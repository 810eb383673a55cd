// Shared device helpers of the port's Hopper kernels (geglu.cu,
// motion_block.cu): the fp32-statistics LayerNorm of a row tile, a tiled
// product with fp32 accumulation, the two GEGLU gate forms (`_gate_mul` of
// followyourclick_tpu/ops/geglu.py), the per-head frame softmax, and the
// LN -> GEGLU feed-forward over a row tile that both kernels run.
//
// Storage types: float and __nv_bfloat16. All arithmetic is fp32; values
// are rounded to the storage type exactly where the Pallas kernels cast
// (`rnd<T>`), so the bf16 kernels reproduce the TPU kernels' numerics.
//
// Products (block_gemm_nt, block_gemm_nt_acc): 256 threads per block, a
// row tile of MC = 16, 32 or 64 rows, A in shared memory, B (an nn.Linear
// weight, K contiguous) read from device memory / L2.
//  - bf16 with 16-aligned shapes: tensor cores through WMMA (16 x 16 x 16
//    bf16 fragments, fp32 accumulators); each warp owns whole 16 x 16
//    output tiles and loads its B fragments straight from L2.
//  - otherwise (fp32, odd widths): fp32 FMA on shared-memory tiles, B staged
//    k-major in k-slices of 32, a pass width of 64, 128 or 256 columns
//    chosen per call, TM = MC * width / 1024 rows x 4 columns per thread.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace fyc {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKS = 32;     // k-slice staged in shared memory
constexpr int kTN = 4;      // columns per thread
constexpr int kBNMax = 256;  // widest pass of block_gemm_nt
constexpr int kBsPad = 4;   // keeps the k-major rows 16-byte aligned
constexpr int kBsElems = kKS * (kBNMax + kBsPad);  // staging tile, elements
constexpr int kJC = 64;     // chunk of the FF inner dimension

// bytes of the per-block work buffer of the products: the FMA path's
// staging tile, or the WMMA path's per-warp 16 x 16 fp32 tiles
__host__ __device__ constexpr size_t work_bytes(size_t tsize) {
  return kBsElems * tsize > kWarps * 256 * 4 ? kBsElems * tsize
                                             : kWarps * 256 * 4;
}

// rows a buffer needs for an M-row tile: whole 16-row fragments
__host__ __device__ constexpr int frag_rows(int m) { return (m + 15) / 16 * 16; }

// Row stride, in elements, of a shared-memory operand of the products with
// `c` columns of `tsize` bytes: padded by 16 bytes. A stride that is a
// multiple of 128 bytes puts all rows of a 16 x 16 fragment in the same
// banks, and every fragment load or store then conflicts 8 ways.
__host__ __device__ constexpr int padded(int c, int tsize) {
  return c + 16 / tsize;
}

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// round an fp32 value to the storage type's precision (a cast and back)
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f<T>(from_f<T>(v));
}

static __device__ __forceinline__ float rbf(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// four consecutive values of a 16-byte (float) / 8-byte (bf16) aligned row
static __device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x, out[1] = v.y, out[2] = v.z, out[3] = v.w;
}
static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                             float* out) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(q[0]), hi = __bfloat1622float2(q[1]);
  out[0] = lo.x, out[1] = lo.y, out[2] = hi.x, out[3] = hi.y;
}

static __device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// h * gelu(gate), rounded to T (`_gate_mul`).
//  fast == 0: exact erf-GELU in fp32.
//  fast == 1: tanh-GELU with every elementwise op rounded to bf16, the
//             serving form of the TPU kernel (default for bf16 at C <= 640).
template <typename T>
__device__ __forceinline__ float gate_mul(float h, float gate, int fast) {
  if (!fast) {
    const float g = 0.5f * gate * (1.0f + erff(gate * 0.70710678118654752f));
    return rnd<T>(h * g);
  }
  const float gb = rbf(gate), hb = rbf(h);
  const float c1 = rbf(0.044715f), c2 = rbf(0.7978845608f);
  const float cube = rbf(rbf(rbf(c1 * gb) * gb) * gb);
  const float inner = rbf(c2 * rbf(gb + cube));
  const float g = rbf(rbf(0.5f * gb) * rbf(1.0f + rbf(tanhf(inner))));
  return rnd<T>(rbf(hb * g));
}

// dst[m, :] = T(LN(src[m, :]) * ls + lb) [+ pe[m % F, :], added in T],
// fp32 statistics (two-pass mean / centred variance), one warp per row;
// dst has row stride ldd.
template <typename T>
__device__ void ln_rows(const T* src, int M, int C, const T* __restrict__ ls,
                        const T* __restrict__ lb, float eps,
                        const T* __restrict__ pe, int F, T* dst, int ldd) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int m = warp; m < M; m += kThreads / 32) {
    const T* row = src + (size_t)m * C;
    float s = 0.f;
    for (int c = lane; c < C; c += 32) s += to_f(row[c]);
    const float mean = warp_sum(s) / C;
    float v = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float d = to_f(row[c]) - mean;
      v += d * d;
    }
    const float rs = rsqrtf(warp_sum(v) / C + eps);
    for (int c = lane; c < C; c += 32) {
      const float n = (to_f(row[c]) - mean) * rs * to_f(ls[c]) + to_f(lb[c]);
      float o = rnd<T>(n);
      if (pe != nullptr) o = rnd<T>(o + to_f(pe[(size_t)(m % F) * C + c]));
      dst[(size_t)m * ldd + c] = from_f<T>(o);
    }
  }
}

// The per-head frame softmax: each of the M rows of F fp32 scores becomes
// its softmax in place, in fp32, with p rounded to T (p is cast before p . v).
template <typename T>
__device__ void softmax_rows(float* s, int M, int F) {
  for (int m = threadIdx.x; m < M; m += kThreads) {
    float* row = s + (size_t)m * F;
    float mx = row[0];
    for (int j = 1; j < F; ++j) mx = fmaxf(mx, row[j]);
    float sum = 0.f;
    for (int j = 0; j < F; ++j) {
      row[j] = expf(row[j] - mx);
      sum += row[j];
    }
    for (int j = 0; j < F; ++j) row[j] = rnd<T>(row[j] / sum);
  }
}

// FMA path, one pass width BN: MC x BN output tiles. Rows n < split of B
// come from Blo, the rest from Bhi (two row ranges of one weight).
template <typename T, int MC, int BN, typename Epi>
__device__ void gemm_nt_passes(const T* A, int lda, int M,
                               const T* __restrict__ Blo,
                               const T* __restrict__ Bhi, int split, int ldb,
                               int N, int K, T* Bs, Epi& epi) {
  constexpr int CG = BN / kTN;        // column groups
  constexpr int RG = kThreads / CG;   // row groups
  constexpr int TM = MC / RG;         // rows per thread
  constexpr int LDS = BN + kBsPad;    // k-major staging row stride
  static_assert(TM >= 1 && RG * TM == MC, "row tile / pass width");
  const int tid = threadIdx.x;
  const int rg = tid / CG, cg = tid % CG;
  for (int n0 = 0; n0 < N; n0 += BN) {
    const bool active = n0 + cg * kTN < N && rg * TM < M;
    float acc[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < K; k0 += kKS) {
      __syncthreads();
      for (int i = tid; i < BN * kKS; i += kThreads) {
        const int nn = i / kKS, kk = i % kKS;
        const int n = n0 + nn, k = k0 + kk;
        const T* row = n < split ? Blo + (size_t)n * ldb
                                 : Bhi + (size_t)(n - split) * ldb;
        Bs[kk * LDS + nn] = (n < N && k < K) ? row[k] : from_f<T>(0.f);
      }
      __syncthreads();
      if (!active) continue;
      const int kmax = min(kKS, K - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        float a[TM], b[kTN];
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const int m = rg * TM + i;
          a[i] = m < M ? to_f(A[(size_t)m * lda + k0 + kk]) : 0.f;
        }
        load4(Bs + kk * LDS + cg * kTN, b);
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    if (!active) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) {
        const int m = rg * TM + i, n = n0 + cg * kTN + j;
        if (m < M && n < N) epi(m, n, acc[i][j]);
      }
  }
}

template <typename T, int MC, typename Epi>
__device__ void gemm_nt_fma(const T* A, int lda, int M, const T* Blo,
                            const T* Bhi, int split, int ldb, int N, int K,
                            T* Bs, Epi& epi) {
  // pass width minimising (padded columns) x (1 + shared loads per FMA)
  int best = 0;
  float best_cost = 0.f;
  for (int w = 0; w < 3; ++w) {
    const int bn = 64 << w, tm = MC * bn / 1024;
    const float cost = (float)((N + bn - 1) / bn * bn) *
                       (1.f + (tm + 1.f) / (4.f * tm));
    if (w == 0 || cost < best_cost) best = w, best_cost = cost;
  }
  if (best == 2)
    gemm_nt_passes<T, MC, 256>(A, lda, M, Blo, Bhi, split, ldb, N, K, Bs, epi);
  else if (best == 1)
    gemm_nt_passes<T, MC, 128>(A, lda, M, Blo, Bhi, split, ldb, N, K, Bs, epi);
  else
    gemm_nt_passes<T, MC, 64>(A, lda, M, Blo, Bhi, split, ldb, N, K, Bs, epi);
}

using bf16 = __nv_bfloat16;
namespace wmma = nvcuda::wmma;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// shapes and pointers the WMMA path takes: 16-element multiples, 32-byte
// aligned fragment starts
static __device__ __forceinline__ bool wmma_ok(const void* A, int lda,
                                               const void* Blo,
                                               const void* Bhi, int split,
                                               int ldb, int N, int K) {
  return N % 16 == 0 && K % 16 == 0 && lda % 8 == 0 && ldb % 8 == 0 &&
         split % 16 == 0 && (((uintptr_t)A | (uintptr_t)Blo | (uintptr_t)Bhi)
                             & 31) == 0;
}

// c += A[16 rows at a] . B[16 rows at b]^T over K
static __device__ __forceinline__ void wmma_tile(FragC& c, const bf16* a,
                                                 int lda, const bf16* b,
                                                 int ldb, int K) {
  for (int k = 0; k < K; k += 16) {
    FragA fa;
    FragB fb;
    wmma::load_matrix_sync(fa, a + k, lda);
    wmma::load_matrix_sync(fb, b + k, ldb);
    wmma::mma_sync(c, fa, fb, c);
  }
}

// WMMA path: each warp takes whole 16 x 16 output tiles; the tile goes
// through the warp's 16 x 16 fp32 slice of `work` to the epilogue. Rows of
// the last fragment past M read (and compute) scratch rows and are dropped.
template <typename Epi>
__device__ void gemm_nt_wmma(const bf16* A, int lda, int M, const bf16* Blo,
                             const bf16* Bhi, int split, int ldb, int N,
                             int K, float* work, Epi& epi) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mt = (M + 15) / 16, nt = N / 16;
  float* tile = work + warp * 256;
  for (int t = warp; t < mt * nt; t += kWarps) {
    const int fm = t % mt, n0 = t / mt * 16;
    const bf16* b = n0 < split ? Blo + (size_t)n0 * ldb
                               : Bhi + (size_t)(n0 - split) * ldb;
    FragC c;
    wmma::fill_fragment(c, 0.f);
    wmma_tile(c, A + (size_t)fm * 16 * lda, lda, b, ldb, K);
    wmma::store_matrix_sync(tile, c, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int m = fm * 16 + e / 16;
      if (m < M) epi(m, n0 + e % 16, tile[e]);
    }
    __syncwarp();
  }
}

// out[m, n] = sum_k A[m * lda + k] * B[n, k] for m < M <= MC, n < N, fp32
// accumulation; calls epi(m, n, value) once per output. B row n is
// Blo + n * ldb for n < split, else Bhi + (n - split) * ldb. A lies in
// shared memory (frag_rows(M) rows allocated); `work` holds
// work_bytes(sizeof(T)) bytes. Starts and ends with a barrier, so callers
// may reuse buffers around it.
template <typename T, int MC, typename Epi>
__device__ void block_gemm_nt(const T* A, int lda, int M, const T* Blo,
                              const T* Bhi, int split, int ldb, int N, int K,
                              void* work, Epi epi) {
  __syncthreads();
  if constexpr (std::is_same<T, bf16>::value) {
    if (wmma_ok(A, lda, Blo, Bhi, split, ldb, N, K)) {
      gemm_nt_wmma(A, lda, M, Blo, Bhi, split, ldb, N, K, (float*)work, epi);
      __syncthreads();
      return;
    }
  }
  gemm_nt_fma<T, MC>(A, lda, M, Blo, Bhi, split, ldb, N, K, (T*)work, epi);
  __syncthreads();
}

template <typename T, int MC, typename Epi>
__device__ void block_gemm_nt(const T* A, int lda, int M, const T* B, int ldb,
                              int N, int K, void* work, Epi epi) {
  block_gemm_nt<T, MC>(A, lda, M, B, B, N, ldb, N, K, work, epi);
}

// Cm[m * ldc + n] += sum_k A[m * lda + k] * B[n, k] (Cm fp32 in shared
// memory with frag_rows(M) rows). The WMMA path keeps each tile in a
// fragment: load, multiply-accumulate over K, store back.
template <typename T, int MC>
__device__ void block_gemm_nt_acc(const T* A, int lda, int M, const T* B,
                                  int ldb, int N, int K, void* work,
                                  float* Cm, int ldc) {
  if constexpr (std::is_same<T, bf16>::value) {
    if (wmma_ok(A, lda, B, B, N, ldb, N, K) && ldc % 4 == 0 &&
        ((uintptr_t)Cm & 31) == 0) {
      __syncthreads();
      const int warp = threadIdx.x / 32;
      const int mt = (M + 15) / 16, nt = N / 16;
      for (int t = warp; t < mt * nt; t += kWarps) {
        const int fm = t % mt, n0 = t / mt * 16;
        float* c_at = Cm + (size_t)fm * 16 * ldc + n0;
        FragC c;
        wmma::load_matrix_sync(c, c_at, ldc, wmma::mem_row_major);
        wmma_tile(c, A + (size_t)fm * 16 * lda, lda, B + (size_t)n0 * ldb,
                  ldb, K);
        wmma::store_matrix_sync(c_at, c, ldc, wmma::mem_row_major);
      }
      __syncthreads();
      return;
    }
  }
  block_gemm_nt<T, MC>(A, lda, M, B, ldb, N, K, work,
                       [&](int m, int n, float v) { Cm[m * ldc + n] += v; });
}

// acc[m, :] += GEGLU(xn[m, :]) for the M rows of a tile, without the b2
// bias: per chunk of `inner`, the value and gate columns of xn . W1 (one
// product over two row ranges of W1, fp32 into hbuf), + b1 and the gate
// into ybuf (rounded to T), then ybuf . W2 into acc. The (M, 2 * inner)
// intermediate never leaves the SM. Row strides: xn padded(C, sizeof(T)),
// acc padded(C, 4), ybuf padded(kJC, sizeof(T)).
// w1: (2 * inner, C), b1: (2 * inner), w2: (C, inner) -- nn.Linear layout.
template <typename T, int MC>
__device__ void ff_accumulate(const T* xn, int M, int C, int inner,
                              const T* __restrict__ w1,
                              const T* __restrict__ b1,
                              const T* __restrict__ w2, int fast, float* acc,
                              float* hbuf, T* ybuf, void* work) {
  const int lx = padded(C, sizeof(T)), ly = padded(kJC, sizeof(T));
  for (int j0 = 0; j0 < inner; j0 += kJC) {
    const int jc = min(kJC, inner - j0);
    block_gemm_nt<T, MC>(xn, lx, M, w1 + (size_t)j0 * C,
                         w1 + (size_t)(inner + j0) * C, jc, C, 2 * jc, C,
                         work, [&](int m, int n, float v) {
                           hbuf[m * 2 * kJC + (n < jc ? n : kJC + n - jc)] = v;
                         });
    for (int i = threadIdx.x; i < M * jc; i += kThreads) {
      const int m = i / jc, n = i % jc;
      const float h = hbuf[m * 2 * kJC + n] + to_f(b1[j0 + n]);
      const float g = hbuf[m * 2 * kJC + kJC + n] + to_f(b1[inner + j0 + n]);
      ybuf[m * ly + n] = from_f<T>(gate_mul<T>(h, g, fast));
    }
    block_gemm_nt_acc<T, MC>(ybuf, ly, M, w2 + j0, inner, C, jc, work, acc,
                             padded(C, 4));
  }
}

// bump allocator over the dynamic shared-memory buffer, 128-byte aligned
// (WMMA fragment loads need 32)
struct SmemCursor {
  size_t off = 0;
  template <typename U> __host__ __device__ size_t take(size_t count) {
    const size_t at = (off + 127) & ~size_t(127);
    off = at + count * sizeof(U);
    return at;
  }
};

constexpr size_t kMaxSmem = 232448;  // 227 KB, the H100's per-block limit

}  // namespace fyc
