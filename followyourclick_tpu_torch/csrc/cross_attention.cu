// LayerNorm -> q projection -> softmax attention over a short key set ->
// out projection (pre-residual), over (B, S, C) query rows.
//
// Replaces the Pallas TPU kernel
// followyourclick_tpu/ops/cross_attention.py, fused_ln_cross_attention
// (_kernel): LN with fp32 statistics, cast; q = xn . Wq^T accumulated in
// fp32, cast; per head the logits q . k^T in fp32 times `scale` over the
// Skv <= 128 keys (keys at or beyond Skv masked), the softmax in fp32, the
// weights cast, p . v accumulated in fp32, cast; out = o . Wo^T + bo in
// fp32, cast. k and v (B, Skv, H * D) are projected by the caller.
//
// What bounds it on the H100: the two projections, 4 * R * C * H * D
// operations (54 GFLOP, 0.054 ms at 989 TFLOP/s, at 131072 rows of
// C = 320), against one read and one write of the (R, C) rows (0.050 ms at
// 3.35 TB/s); the attention adds 4 * R * Skv * H * D.
//
// bf16: four launches, sequenced by the wrapper (ops/cross_attention.py),
// on device code the other kernels already run, rounding exactly where the
// Pallas kernel casts:
//  (a) the LN pass of geglu.cu (fyc_ln_rows_bf16): xn = bf16(LN(x));
//  (b) q = bf16(xn . Wq^T) on the GEMM core of gemm.cuh (fyc_linear_bf16
//      below: 160-wide tiles, which divide C = 320, 640 and 1280, and an
//      epilogue that only casts);
//  (c) the short-kv attention below (fyc_cross_attention_bf16);
//  (d) out = bf16(o . Wo^T + bo) on the GEMM core, geglu.cu's
//      fyc_geglu_down_bf16 without the residual.
// Against keeping a row tile on chip, xn, q and o go through device memory
// once each (6 * R * C bytes more, 0.25 ms at 131072 x 320); what it buys:
// both products stream their operands by TMA into a 5-stage ring and run
// on wgmma with 128-row tiles, where an on-chip tile of at most 64 rows
// re-read all of Wq and Wo from L2 (2 * C^2 values a block).
//
// The short-kv attention (c). It moves q in and o out (4 * R * C bytes)
// and does 4 * R * Skv * C operations on the tensor cores, 80 per byte at
// Skv = 77: device memory bounds it. A block takes one batch row, a run of
// heads (the largest divisor of H whose k | v tile fits kCaKvBytes) and a
// tile of up to 128 query rows. It loads that batch row's k and v of its
// heads once by 16-byte cp.async, Skv padded to a multiple of 16 rows and
// D to one of 16 columns by the copies' zero fill, and reuses them for all
// its query rows. Each warp owns 16 query rows of one head: the logits on
// mma.sync m16n8k16 into fp32 registers, times `scale`, keys at or beyond
// Skv set to -inf; the softmax in fp32 in registers, the row max and sum by
// quad shuffles, each exponential computed once; p rounded to bf16 in
// registers is at once the A operand of p . v (two m16n8 score tiles are
// one m16n8k16 A fragment of 16 keys), V read by ldmatrix.trans; o rounded
// to bf16 overwrites the warp's q rows in shared memory and leaves by
// 16-byte stores. Shared-memory rows are an odd multiple of 16 bytes, so an
// ldmatrix's eight rows fall in distinct banks. Head widths that are not
// whole 16-byte chunks, or pointers off 16 bytes, take the same tiles
// through element loads and stores. The Pallas kernel's block-diagonal
// head packing (every head's keys in its own 128-lane segment, one dot for
// all heads) is a TPU lane-layout device and is not carried over.
//
// fp32: the all-on-chip kernel (ln_cross_attention_kernel): a block owns a
// tile of MC query rows (16, 32 or 64, sized against the shared memory by
// the caller) of one batch row and keeps everything of it on chip: the LN
// output, q for all heads, and per head a zero-padded copy of the head's q
// columns, k rows and v^T, the fp32 scores and the weights, with the
// products on common.cuh's FMA tiles. The attention output overwrites the
// LN output, which is dead once q exists. fp32 at C = 1280 does not fit.
#include "common.cuh"
#include "gemm.cuh"

namespace fyc {

__host__ __device__ constexpr int round16(int v) { return (v + 15) / 16 * 16; }

struct CrossLayout {
  size_t xo, q, qh, kh, vt, s, p, work, bytes;
  __host__ __device__ CrossLayout(int mc, int c, int ci, int d, int skv,
                                  size_t t) {
    const int dp = round16(d), sp = round16(skv), wx = c > ci ? c : ci;
    SmemCursor cur;
    xo = cur.take<char>((size_t)mc * padded(wx, t) * t);
    q = cur.take<char>((size_t)mc * padded(ci, t) * t);
    qh = cur.take<char>((size_t)mc * padded(dp, t) * t);
    kh = cur.take<char>((size_t)sp * padded(dp, t) * t);
    vt = cur.take<char>((size_t)dp * padded(sp, t) * t);
    s = cur.take<float>((size_t)mc * sp);
    p = cur.take<char>((size_t)mc * padded(sp, t) * t);
    work = cur.take<char>(work_bytes(t));
    bytes = cur.off;
  }
};

template <typename T, int MC>
__global__ void __launch_bounds__(kThreads)
ln_cross_attention_kernel(const T* __restrict__ x, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ ls,
                          const T* __restrict__ lb, const T* __restrict__ wq,
                          const T* __restrict__ wo, const T* __restrict__ bo,
                          T* __restrict__ out, int S, int C, int heads, int D,
                          int Skv, float scale, float eps) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ci = heads * D, dp = round16(D), sp = round16(Skv);
  const CrossLayout lay(MC, C, ci, D, Skv, sizeof(T));
  T* xo = reinterpret_cast<T*>(smem + lay.xo);
  T* q = reinterpret_cast<T*>(smem + lay.q);
  T* qh = reinterpret_cast<T*>(smem + lay.qh);
  T* kh = reinterpret_cast<T*>(smem + lay.kh);
  T* vt = reinterpret_cast<T*>(smem + lay.vt);
  float* s = reinterpret_cast<float*>(smem + lay.s);
  T* p = reinterpret_cast<T*>(smem + lay.p);
  void* work = smem + lay.work;
  const int lx = padded(C > ci ? C : ci, sizeof(T)), lq = padded(ci, sizeof(T));
  const int ld = padded(dp, sizeof(T)), lp = padded(sp, sizeof(T));

  const int b = blockIdx.y;
  const size_t r0 = (size_t)blockIdx.x * MC;
  const int M = min(MC, (int)(S - r0));
  const T* xt = x + ((size_t)b * S + r0) * C;
  const T* kb = k + (size_t)b * Skv * ci;
  const T* vb = v + (size_t)b * Skv * ci;
  const T zero = from_f<T>(0.f);

  ln_rows<T>(xt, M, C, ls, lb, eps, nullptr, 1, xo, lx);
  block_gemm_nt<T, MC>(xo, lx, M, wq, C, ci, C, work,
                       [&](int m, int n, float a) { q[m * lq + n] = from_f<T>(a); });

  for (int hd = 0; hd < heads; ++hd) {
    const int c0 = hd * D;
    // this head's q columns, k rows and v^T, zero-padded to dp and sp
    for (int i = threadIdx.x; i < MC * dp; i += kThreads) {
      const int m = i / dp, j = i % dp;
      qh[m * ld + j] = (m < M && j < D) ? q[m * lq + c0 + j] : zero;
    }
    for (int i = threadIdx.x; i < sp * dp; i += kThreads) {
      const int key = i / dp, j = i % dp;
      const bool in = key < Skv && j < D;
      const size_t at = (size_t)key * ci + c0 + j;
      kh[key * ld + j] = in ? kb[at] : zero;
      vt[j * lp + key] = in ? vb[at] : zero;
    }
    // fp32 logits times the scale
    block_gemm_nt<T, MC>(qh, ld, M, kh, ld, sp, dp, work,
                         [&](int m, int n, float a) { s[m * sp + n] = a * scale; });
    // softmax over the Skv keys in fp32, one warp per row; the weights are
    // cast, and the padded keys get weight 0
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int m = warp; m < M; m += kWarps) {
      const float* row = s + m * sp;
      float mx = -3.0e38f;  // every row has Skv >= 1 finite logits
      for (int j = lane; j < Skv; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int j = lane; j < Skv; j += 32) sum += expf(row[j] - mx);
      sum = warp_sum(sum);
      for (int j = lane; j < sp; j += 32)
        p[m * lp + j] = j < Skv ? from_f<T>(expf(row[j] - mx) / sum) : zero;
    }
    // o[:, head columns] = p . v, cast (p rows past M are never read back)
    block_gemm_nt<T, MC>(p, lp, M, vt, lp, dp, sp, work,
                         [&](int m, int n, float a) {
                           if (n < D) xo[m * lx + c0 + n] = from_f<T>(a);
                         });
  }
  // out = o . Wo^T + bo, cast
  T* ot = out + ((size_t)b * S + r0) * C;
  block_gemm_nt<T, MC>(xo, lx, M, wo, ci, C, ci, work,
                       [&](int m, int n, float a) {
                         ot[(size_t)m * C + n] = from_f<T>(a + to_f(bo[n]));
                       });
}

template <typename T, int MC>
cudaError_t cross_launch(const void* x, const void* k, const void* v,
                         const void* ls, const void* lb, const void* wq,
                         const void* wo, const void* bo, void* out, int B,
                         int S, int C, int heads, int D, int Skv, float scale,
                         float eps, cudaStream_t stream) {
  const CrossLayout lay(MC, C, heads * D, D, Skv, sizeof(T));
  auto kern = ln_cross_attention_kernel<T, MC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + MC - 1) / MC, B);
  kern<<<grid, kThreads, lay.bytes, stream>>>(
      (const T*)x, (const T*)k, (const T*)v, (const T*)ls, (const T*)lb,
      (const T*)wq, (const T*)wo, (const T*)bo, (T*)out, S, C, heads, D, Skv,
      scale, eps);
  return cudaGetLastError();
}

cudaError_t cross_dispatch_fp32(int rows, const void* x, const void* k,
                                const void* v, const void* ls, const void* lb,
                                const void* wq, const void* wo, const void* bo,
                                void* out, int B, int S, int C, int heads,
                                int D, int Skv, float scale, float eps,
                                cudaStream_t stream) {
  switch (rows) {
    case 16: return cross_launch<float, 16>(x, k, v, ls, lb, wq, wo, bo, out, B, S, C, heads, D, Skv, scale, eps, stream);
    case 32: return cross_launch<float, 32>(x, k, v, ls, lb, wq, wo, bo, out, B, S, C, heads, D, Skv, scale, eps, stream);
    case 64: return cross_launch<float, 64>(x, k, v, ls, lb, wq, wo, bo, out, B, S, C, heads, D, Skv, scale, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16 (b): q = bf16(xn . Wq^T) on the GEMM core --------------------------

// the epilogue: each pair of columns n, n + 1 (N even) rounded to bf16
struct CastEpi {
  bf16* out;
  int R, N;
  template <int F>
  __device__ void operator()(float (&acc)[1][F], int row, int col) const {
#pragma unroll
    for (int i = 0; i < F / 4; ++i) {
      const int n = col + 8 * i;
      if (n >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= R) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)r * N + n) =
            __floats2bfloat162_rn(acc[0][4 * i + 2 * h],
                                  acc[0][4 * i + 2 * h + 1]);
      }
    }
  }
};

constexpr int kLinBN = 160, kLinStages = 5;  // 160 divides 320, 640, 1280

// ---- bf16 (c): the short-kv attention -----------------------------------------

constexpr int kCaKvBytes = 40 * 1024;  // the k | v tile a block aims under
constexpr int kCaMaxRows = 128;        // query rows a block takes at most
constexpr int kCaWarps = 8;
constexpr int kCaBlocks = 1056;        // blocks a launch aims at: 8 an SM

// columns of a head row in shared memory (whole k16 steps, zero past D),
// and the row stride: an odd multiple of 16 bytes
__host__ __device__ constexpr int ca_cols(int D) { return round16(D); }
__host__ __device__ constexpr int ca_stride(int D) { return round16(D) + 8; }

// k | v rows of hpt heads, each row ca_stride(D) elements
__host__ __device__ constexpr size_t ca_kv_bytes(int hpt, int D, int skp) {
  return (size_t)hpt * 2 * skp * ca_stride(D) * sizeof(bf16);
}

struct CaTile {
  int hpt, mq, tpb;  // heads, query rows of a tile, tiles of a block
};

// k | v of the block's heads, and one query tile buffer, or two where the
// block walks several tiles
static size_t ca_smem(const CaTile& t, int D, int skp) {
  return ca_kv_bytes(t.hpt, D, skp) + (size_t)(t.tpb > 1 ? 2 : 1) * t.hpt *
                                          t.mq * ca_stride(D) * sizeof(bf16);
}

// heads: the largest divisor of H whose k | v tile fits kCaKvBytes, else
// 1; query rows: S rounded up to 16, at most kCaMaxRows; tiles a block
// walks: as many as leave about kCaBlocks blocks; the query rows halved
// while the block's shared memory exceeds the card's
static CaTile ca_tile(int B, int S, int H, int D, int skp) {
  CaTile t{1, round16(S) < kCaMaxRows ? round16(S) : kCaMaxRows, 1};
  for (int g = 2; g <= H && ca_kv_bytes(g, D, skp) <= kCaKvBytes; ++g)
    if (H % g == 0) t.hpt = g;
  const long long runs = (long long)B * (H / t.hpt);
  const int tiles = (S + t.mq - 1) / t.mq;
  const long long per_run = (kCaBlocks + runs - 1) / runs;
  t.tpb = per_run >= tiles ? 1 : (int)((tiles + per_run - 1) / per_run);
  while (t.mq > 16 && ca_smem(t, D, skp) > kMaxSmem) t.mq = round16(t.mq / 2);
  return t;
}

// Block (run of tiles blockIdx.x, head run blockIdx.y, batch row
// blockIdx.z): k and v of the block's heads load once; the query tiles
// follow in two shared-memory buffers, the copies of tile i + 1 in flight
// while tile i is computed and stored. vec: 16-byte chunks (D a multiple
// of 8, pointers 16-byte aligned), else element by element.
template <int SKP>
__global__ void __launch_bounds__(kCaWarps * 32)
cross_attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, bf16* __restrict__ out,
                       int S, int Skv, int H, int D, CaTile t, float scale,
                       bool vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int hpt = t.hpt, mq = t.mq;
  const int cols = ca_cols(D), ls = ca_stride(D);
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [hpt][SKP][ls]
  bf16* vs = ks + (size_t)hpt * SKP * ls;
  bf16* qbuf = vs + (size_t)hpt * SKP * ls;      // [2][hpt][mq][ls]
  const size_t qtile = (size_t)hpt * mq * ls;
  const size_t C = (size_t)H * D;
  const int b = blockIdx.z, tile0 = blockIdx.x * t.tpb;
  const int ntiles = min(t.tpb, (S + mq - 1) / mq - tile0);
  const size_t head0 = (size_t)blockIdx.y * hpt * D;
  const bf16* kb = k + (size_t)b * Skv * C + head0;
  const bf16* vb = v + (size_t)b * Skv * C + head0;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nw = blockDim.x / 32;
  const bf16 zero = __float2bfloat16(0.f);
  // the lanes of a warp take neighbouring chunks of a row, the warps take
  // rows; padded rows and columns are zero-filled
  const int unit = vec ? 8 : 1;  // elements a copy moves
  const int per_row = cols / unit, units = hpt * per_row;
  auto load = [&](bf16* dst, const bf16* src, int rows, int live_rows) {
    for (int j = lane; j < units; j += 32) {
      const int hh = j / per_row, c = (j - hh * per_row) * unit;
      const size_t at = (size_t)hh * D + c;
      for (int row = warp; row < rows; row += nw) {
        const bool live = row < live_rows && c < D;
        bf16* d = dst + ((size_t)hh * rows + row) * ls + c;
        if (vec)
          hopper::cp_async16(d, live ? src + row * C + at : src, live);
        else
          *d = live ? src[row * C + at] : zero;
      }
    }
  };
  auto q_rows = [&](int i) { return min(mq, S - (tile0 + i) * mq); };
  auto q_src = [&](int i) {
    return q + ((size_t)b * S + (size_t)(tile0 + i) * mq) * C + head0;
  };

  load(ks, kb, SKP, Skv);
  load(vs, vb, SKP, Skv);
  load(qbuf, q_src(0), mq, q_rows(0));
  hopper::cp_async_commit();
  const int tiles = mq / 16;
  for (int i = 0; i < ntiles; ++i) {
    bf16* qs = qbuf + (i & 1) * qtile;
    if (i + 1 < ntiles) {
      load(qbuf + ((i + 1) & 1) * qtile, q_src(i + 1), mq, q_rows(i + 1));
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    // one warp per 16 query rows of one head; o overwrites those q rows
    const int mrows = q_rows(i);
    for (int w = warp; w < hpt * tiles; w += nw) {
      const int hh = w / tiles, r0 = (w - hh * tiles) * 16;
      if (r0 >= mrows) continue;  // rows of padding only
      hopper::mma_attention<SKP>(qs + ((size_t)hh * mq + r0) * ls,
                                 ks + (size_t)hh * SKP * ls,
                                 vs + (size_t)hh * SKP * ls, ls, 16, Skv, D,
                                 cols, scale);
    }
    __syncthreads();
    // o -> out, as the loads
    bf16* ob = out + ((size_t)b * S + (size_t)(tile0 + i) * mq) * C + head0;
    const int out_row = D / unit, out_units = hpt * out_row;
    for (int j = lane; j < out_units; j += 32) {
      const int hh = j / out_row, c = (j - hh * out_row) * unit;
      const bf16* from = qs + (size_t)hh * mq * ls + c;
      bf16* to = ob + (size_t)hh * D + c;
      for (int row = warp; row < mrows; row += nw) {
        if (vec)
          *reinterpret_cast<uint4*>(to + row * C) =
              *reinterpret_cast<const uint4*>(from + row * ls);
        else
          to[row * C] = from[row * ls];
      }
    }
    __syncthreads();  // the buffer is read out before tile i + 2 fills it
  }
}

template <int SKP>
cudaError_t ca_launch(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int Skv, int H, int D, float scale,
                      cudaStream_t stream) {
  const CaTile t = ca_tile(B, S, H, D, SKP);
  const size_t bytes = ca_smem(t, D, SKP);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  const bool vec =
      D % 8 == 0 &&
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15) ==
          0;
  auto kern = cross_attention_kernel<SKP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int tasks = t.hpt * (t.mq / 16);
  const int tiles = (S + t.mq - 1) / t.mq;
  const dim3 grid((tiles + t.tpb - 1) / t.tpb, H / t.hpt, B);
  kern<<<grid, 32 * (tasks < kCaWarps ? tasks : kCaWarps), bytes, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, S, Skv, H,
      D, t, scale, vec);
  return cudaGetLastError();
}

}  // namespace fyc

// Shared memory one block takes for a tile of `rows` query rows.
extern "C" long long fyc_ln_cross_attention_smem_bytes(int rows, int C,
                                                       int heads, int D,
                                                       int Skv, int dtype) {
  return (long long)fyc::CrossLayout(rows, C, heads * D, D, Skv,
                                     dtype == 1 ? 2 : 4).bytes;
}

// fp32, the all-on-chip kernel. x: (B, S, C); k, v: (B, Skv, heads * D)
// projected keys and values; wq: (heads * D, C); wo: (C, heads * D); ls, lb,
// bo: (C). Skv <= 128. dtype must be 0 (float32): bfloat16 runs the four
// launches below. rows: 16, 32 or 64 query rows per block. Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fyc_ln_cross_attention(
    const void* x, const void* k, const void* v, const void* ls,
    const void* lb, const void* wq, const void* wo, const void* bo, void* out,
    int B, int S, int C, int heads, int D, int Skv, float scale, float eps,
    int dtype, int rows, void* stream) {
  if (dtype != 0 || Skv < 1 || Skv > 128 ||
      fyc::CrossLayout(rows, C, heads * D, D, Skv, 4).bytes > fyc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  return (int)fyc::cross_dispatch_fp32(rows, x, k, v, ls, lb, wq, wo, bo, out,
                                       B, S, C, heads, D, Skv, scale, eps,
                                       (cudaStream_t)stream);
}

// bf16 (b): out (R, N) = bf16(a . W^T), a (R, K), W (N, K), no bias. K and
// N multiples of 8 (16-byte rows for TMA), pointers 16-byte aligned.
extern "C" int fyc_linear_bf16(const void* a, const void* w, void* out, int R,
                               int N, int K, void* stream) {
  if (R <= 0 || N <= 0 || K <= 0 || N % 8 || K % 8)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!fyc::hopper::make_map_2d(&ta, a, R, K, fyc::kGemmBM) ||
      !fyc::hopper::make_map_2d(&tb, w, N, K, fyc::kLinBN))
    return (int)cudaErrorInvalidValue;
  const fyc::CastEpi epi{(fyc::bf16*)out, R, N};
  return (int)fyc::gemm_launch<fyc::kLinBN, 1, fyc::kLinStages>(
      ta, tb, R, N, K, 0, epi, (cudaStream_t)stream);
}

// bf16 (c): o (B, S, H * D) = softmax(q . k^T * scale) . v per batch row
// and head; q: (B, S, H * D), k, v: (B, Skv, H * D), all contiguous;
// 1 <= Skv <= 128. Returns the cudaError_t of the launch (0 on success).
extern "C" int fyc_cross_attention_bf16(const void* q, const void* k,
                                        const void* v, void* out, int B,
                                        int S, int Skv, int H, int D,
                                        float scale, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || H <= 0 || D <= 0 || Skv < 1 ||
      Skv > 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (fyc::round16(Skv)) {
    case 16: return (int)fyc::ca_launch<16>(q, k, v, out, B, S, Skv, H, D, scale, s);
    case 32: return (int)fyc::ca_launch<32>(q, k, v, out, B, S, Skv, H, D, scale, s);
    case 48: return (int)fyc::ca_launch<48>(q, k, v, out, B, S, Skv, H, D, scale, s);
    case 64: return (int)fyc::ca_launch<64>(q, k, v, out, B, S, Skv, H, D, scale, s);
    case 80: return (int)fyc::ca_launch<80>(q, k, v, out, B, S, Skv, H, D, scale, s);
    case 96: return (int)fyc::ca_launch<96>(q, k, v, out, B, S, Skv, H, D, scale, s);
    case 112: return (int)fyc::ca_launch<112>(q, k, v, out, B, S, Skv, H, D, scale, s);
    default: return (int)fyc::ca_launch<128>(q, k, v, out, B, S, Skv, H, D, scale, s);
  }
}
