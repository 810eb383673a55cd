// Frame-axis attention of the motion module's modular path.
//
// Replaces two Pallas TPU kernels of followyourclick_tpu/ops/
// temporal_attention.py:
//  - temporal_attention (_kernel over _attend): per-head softmax attention
//    over S <= 32 frames on the raw (B, S, H * D) layout of the projections;
//    fp32 logits times scale, fp32 softmax, p cast to v's type, p . v
//    accumulated in fp32, cast on the way out;
//  - fused_temporal_block (_fused_kernel): x . Wq, x . Wk, x . Wv (each cast
//    after fp32 accumulation) -> the same attention -> o cast -> o . Wo + bo
//    in fp32 -> cast.
//
// The frame attention (fyc_temporal_attention; also stage (c) of the bf16
// motion block and of the bf16 fused_temporal_block). What bounds it on the
// H100: 4 * B * S * S * C operations against 4 * B * S * C * 2 bytes (bf16
// q, k, v in, o out), 2 * S = 32 operations per byte at 16 frames, far
// under the card's ~295: device memory bounds it (335 MB, 0.100 ms at 3.35
// TB/s, at the motion block's (8192, 16, 8, 40)).
//
// What the design does about that:
//  - a block takes one tile: one position's S rows over a run of whole
//    heads (all H where the tile fits kTaTileBytes of shared memory, else
//    the largest run that divides H), so its loads are contiguous runs of
//    the tile's width, not 2 * D-byte pieces. Every byte of q, k, v is read
//    once by a 16-byte cp.async, the lanes of a warp on neighbouring chunks
//    of a row, all of a tile's loads in flight together; several blocks per
//    SM (five at (8192, 16, 8, 40)) overlap one tile's loads with another's
//    arithmetic and store. o goes back through shared memory as 16-byte
//    stores. (A persistent grid that double-buffers its tiles in two
//    shared-memory stages measured no faster: PERF.md, PR 8.)
//  - each (position, head) is one warp's: no block-wide barrier between
//    the two products and the softmax.
//  - bf16 runs both products on the tensor cores with mma.sync m16n8k16
//    (hopper.cuh's mma_attention, shared with cross_attention.cu):
//    S padded to 16 or 32 rows (one or two M tiles; padded keys masked to
//    -inf, padded query rows discarded), D padded to a multiple of 16 with
//    zeros for the score product. The scores stay in fp32 accumulators; the
//    softmax runs in registers with quad shuffles for the row max and sum;
//    p is rounded to bf16 in registers and is at once the A operand of
//    p . v (the m16n8 accumulator layout of two key tiles is the m16n8k16 A
//    layout of their 16 keys); V comes through ldmatrix.trans.
//  - fp32 keeps the same tiles and one warp per head on FMA (no tf32): lane
//    j takes key j's score with float4 reads, the softmax by warp shuffles,
//    then lane c takes output column c.
//  - shared-memory rows are padded to an odd multiple of 16 bytes, so the
//    eight rows of an ldmatrix (or a float4 phase) fall in distinct banks.
// Shapes whose head rows are not whole 16-byte chunks (D % 8 for bf16,
// D % 4 for fp32) or whose pointers are not 16-byte aligned take the same
// tiles through element loads and stores.
//
// fused_temporal_block. bf16: three launches sequenced by the wrapper
// (ops/temporal_attention.py) on device code of the other kernels:
// motion_block.cu's fyc_qkv_bf16 (one GEMM-core product over [Wq; Wk; Wv]),
// the frame attention above, geglu.cu's fyc_geglu_down_bf16 without the
// residual. fp32: temporal_block_kernel below, all on chip: a block owns G
// whole positions (G * S rows, at most 64), keeps x, q, k, v and o in shared
// memory, runs common.cuh's frame_attention (the all-head q/k/v products on
// FMA tiles and the per-head softmax) and the out-projection, and writes
// each output once.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace fyc {

// ---- the frame attention ---------------------------------------------------

constexpr int kTaTileBytes = 48 * 1024;  // shared memory a tile aims under
constexpr int kTaMaxWarps = 8;

// rows a tile keeps per head: bf16 pads S to the 16-row M tiles of
// m16n8k16, fp32 keeps S
__host__ __device__ constexpr int ta_rows(int S, int tsize) {
  return tsize == 2 ? (S <= 16 ? 16 : 32) : S;
}
// columns of a head row in shared memory, zero past D: whole k16 steps of
// the score product (bf16), whole float4 reads (fp32)
__host__ __device__ constexpr int ta_cols(int D, int tsize) {
  return tsize == 2 ? (D + 15) / 16 * 16 : (D + 3) / 4 * 4;
}
// row stride: an odd multiple of 16 bytes
__host__ __device__ constexpr int ta_stride(int D, int tsize) {
  return tsize == 2 ? ta_cols(D, 2) + 8
                    : ta_cols(D, 4) + (ta_cols(D, 4) % 8 ? 0 : 4);
}
// q | k | v of `heads` heads, each head rows x stride
__host__ __device__ constexpr size_t ta_tile_bytes(int S, int D, int heads,
                                                   int tsize) {
  return (size_t)3 * heads * ta_rows(S, tsize) * ta_stride(D, tsize) * tsize;
}

// heads per tile: the largest divisor of H whose tile fits kTaTileBytes,
// else 1
static int ta_heads_per_tile(int S, int H, int D, int tsize) {
  int best = 1;
  for (int g = 2; g <= H && ta_tile_bytes(S, D, g, tsize) <= kTaTileBytes;
       ++g)
    if (H % g == 0) best = g;
  return best;
}

using hopper::cp_async16;
using hopper::cp_async_wait_all;

static __device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One (position, head) on one warp, fp32 on FMA. qs, ks, vs: S rows of `ls`
// floats, columns [D, ceil4(D)) zero. o overwrites q's rows.
__device__ void head_attention(float* qs, const float* ks, const float* vs,
                               int ls, int S, int D, float scale) {
  const int lane = threadIdx.x % 32, c4 = (D + 3) / 4;
  for (int i = 0; i < S; ++i) {
    float s = -INFINITY;
    if (lane < S) {
      const float4* qr = reinterpret_cast<const float4*>(qs + i * ls);
      const float4* kr = reinterpret_cast<const float4*>(ks + lane * ls);
      float dot = 0.f;
      for (int c = 0; c < c4; ++c) {
        const float4 a = qr[c], b = kr[c];
        dot = fmaf(a.x, b.x, dot);
        dot = fmaf(a.y, b.y, dot);
        dot = fmaf(a.z, b.z, dot);
        dot = fmaf(a.w, b.w, dot);
      }
      s = dot * scale;
    }
    const float mx = warp_max(s);  // every lane shuffles
    const float e = lane < S ? expf(s - mx) : 0.f;
    const float p = e / warp_sum(e);
    __syncwarp();  // q's row i is read; o may overwrite it
    for (int c0 = 0; c0 < D; c0 += 32) {
      const int c = c0 + lane;
      float acc = 0.f;
      for (int j = 0; j < S; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        if (c < D) acc = fmaf(pj, vs[j * ls + c], acc);
      }
      if (c < D) qs[i * ls + c] = acc;
    }
  }
}

// One tile per block: position blockIdx.x / (H / hpt), heads
// hpt * (blockIdx.x % (H / hpt)) and the next hpt - 1. vec: 16-byte chunks
// (D a multiple of 16 / sizeof(T), pointers 16-byte aligned), else element
// by element.
template <typename T, int SP>
__global__ void __launch_bounds__(kTaMaxWarps * 32)
frame_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int H, int D, int hpt, float scale, bool vec) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  constexpr int kTs = sizeof(T), kE = 16 / kTs;
  const int rows = ta_rows(S, kTs), cols = ta_cols(D, kTs);
  const int ls = ta_stride(D, kTs);
  const int per_head = rows * ls, per_tensor = hpt * per_head;
  const int groups = H / hpt;
  const size_t C = (size_t)H * D;
  const size_t base = (size_t)(blockIdx.x / groups) * S * C +
                      (size_t)(blockIdx.x % groups) * hpt * D;
  const int tid = threadIdx.x, nth = blockDim.x;

  // q | k | v -> shared memory: the lanes of a warp take neighbouring
  // chunks of one tile row (neighbouring addresses), the warps take rows;
  // a lane's (head, column) is worked out once, not per row
  const int lane = tid % 32, warp = tid / 32, nw = nth / 32;
  const int unit = vec ? kE : 1;                    // elements a copy moves
  const int per_row = cols / unit, units = hpt * per_row;
  for (int j = lane; j < units; j += 32) {
    const int hh = j / per_row, c = (j - hh * per_row) * unit;
    T* dst = smem + hh * per_head + c;
    const size_t at = base + (size_t)hh * D + c;
    for (int t = 0; t < 3; ++t) {
      const T* src = t == 0 ? q : t == 1 ? k : v;
      for (int row = warp; row < rows; row += nw) {
        const bool live = row < S && c < D;
        T* d = dst + t * per_tensor + row * ls;
        if (vec)
          cp_async16(d, live ? src + at + row * C : src, live);
        else
          *d = live ? src[at + row * C] : from_f<T>(0.f);
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  for (int hh = warp; hh < hpt; hh += nw) {
    T* qs = smem + hh * per_head;
    if constexpr (kTs == 2)
      hopper::mma_attention<SP>(qs, qs + per_tensor, qs + 2 * per_tensor,
                                ls, S, S, D, cols, scale);
    else
      head_attention(qs, qs + per_tensor, qs + 2 * per_tensor, ls, S, D,
                     scale);
  }
  __syncthreads();

  // o (in q's rows) -> out, as the loads
  const int out_row = D / unit, out_units = hpt * out_row;
  for (int j = lane; j < out_units; j += 32) {
    const int hh = j / out_row, c = (j - hh * out_row) * unit;
    const T* from = smem + hh * per_head + c;
    T* to = out + base + (size_t)hh * D + c;
    for (int row = warp; row < S; row += nw) {
      if (vec)
        *reinterpret_cast<uint4*>(to + row * C) =
            *reinterpret_cast<const uint4*>(from + row * ls);
      else
        to[row * C] = from[row * ls];
    }
  }
}

template <typename T, int SP>
cudaError_t ta_launch(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int H, int D, float scale,
                      cudaStream_t stream) {
  constexpr int kTs = sizeof(T);
  const int hpt = ta_heads_per_tile(S, H, D, kTs);
  const size_t bytes = ta_tile_bytes(S, D, hpt, kTs);
  const bool vec =
      D % (16 / kTs) == 0 &&
      (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15) ==
          0;
  auto kern = frame_attention_kernel<T, SP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long long tiles = (long long)B * (H / hpt);
  kern<<<(unsigned)tiles, 32 * (hpt < kTaMaxWarps ? hpt : kTaMaxWarps), bytes,
         stream>>>((const T*)q, (const T*)k, (const T*)v, (T*)out, S, H, D,
                   hpt, scale, vec);
  return cudaGetLastError();
}

// ---- fused_temporal_block, fp32 -------------------------------------------

struct TemporalLayout {
  size_t xn, q, k, v, s, work, bytes;
  __host__ __device__ TemporalLayout(int rows, int f, int c) {
    SmemCursor cur;
    const size_t t = sizeof(float), r = (size_t)frag_rows(rows);
    xn = cur.take<char>(r * padded(c, t) * t);
    q = cur.take<char>(r * c * t);
    k = cur.take<char>(r * c * t);
    v = cur.take<char>(r * c * t);
    s = cur.take<float>(r * f);
    work = cur.take<char>(work_bytes(t));
    bytes = cur.off;
  }
};

template <int MC>
__global__ void __launch_bounds__(kThreads)
temporal_block_kernel(const float* __restrict__ x,
                      const float* __restrict__ wq,
                      const float* __restrict__ wk,
                      const float* __restrict__ wv,
                      const float* __restrict__ wo,
                      const float* __restrict__ bo, float* __restrict__ out,
                      int P, int F, int C, int heads, int G, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TemporalLayout lay(G * F, F, C);
  float* xn = reinterpret_cast<float*>(smem + lay.xn);
  float* q = reinterpret_cast<float*>(smem + lay.q);
  float* k = reinterpret_cast<float*>(smem + lay.k);
  float* v = reinterpret_cast<float*>(smem + lay.v);
  float* s = reinterpret_cast<float*>(smem + lay.s);
  void* work = smem + lay.work;

  const size_t row0 = (size_t)blockIdx.x * G * F;
  const int M = min(G, P - (int)(blockIdx.x * G)) * F;
  const int lx = padded(C, sizeof(float));
  for (int i = threadIdx.x; i < M * C; i += kThreads)
    xn[(size_t)(i / C) * lx + i % C] = x[row0 * C + i];
  // (block_gemm_nt opens with a barrier)
  frame_attention<float, MC>(xn, lx, q, k, v, s, work, M, F, C, heads, scale,
                             wq, wk, wv);
  // out = o . Wo^T + bo
  block_gemm_nt<float, MC>(xn, lx, M, wo, C, C, C, work,
                           [&](int m, int n, float y) {
                             out[(row0 + m) * C + n] = y + bo[n];
                           });
}

template <int MC>
cudaError_t tb_launch(const void* const* w, const void* x, void* out, int P,
                      int F, int C, int heads, int G, float scale,
                      cudaStream_t stream) {
  const TemporalLayout lay(G * F, F, C);
  auto kern = temporal_block_kernel<MC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (P + G - 1) / G;
  kern<<<blocks, kThreads, lay.bytes, stream>>>(
      (const float*)x, (const float*)w[0], (const float*)w[1],
      (const float*)w[2], (const float*)w[3], (const float*)w[4],
      (float*)out, P, F, C, heads, G, scale);
  return cudaGetLastError();
}

}  // namespace fyc

// Shared memory of the smallest frame-attention tile (one head) at S
// frames, head dim D. dtype: 0 = float32, 1 = bfloat16.
extern "C" long long fyc_temporal_attention_smem_bytes(int S, int D,
                                                       int dtype) {
  return (long long)fyc::ta_tile_bytes(S, D, 1, dtype == 1 ? 2 : 4);
}

// q, k, v, out: (B, S, H, D) contiguous (row stride C = H * D). dtype: 0 =
// float32, 1 = bfloat16. Returns the cudaError_t of the launch (0 on
// success).
extern "C" int fyc_temporal_attention(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int D, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || S > 32 || H <= 0 || D <= 0 ||
      (long long)B * H > 2147483647LL ||
      fyc_temporal_attention_smem_bytes(S, D, dtype) > fyc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype != 1)
    return (int)fyc::ta_launch<float, 0>(q, k, v, out, B, S, H, D, scale, s);
  if (S <= 16)
    return (int)fyc::ta_launch<fyc::bf16, 16>(q, k, v, out, B, S, H, D, scale,
                                              s);
  return (int)fyc::ta_launch<fyc::bf16, 32>(q, k, v, out, B, S, H, D, scale,
                                            s);
}

// Shared memory one fp32 fused_temporal_block block takes for G positions
// of F frames at width C.
extern "C" long long fyc_temporal_block_smem_bytes(int G, int F, int C) {
  return (long long)fyc::TemporalLayout(G * F, F, C).bytes;
}

// fp32. x, out: (P, F, C) contiguous; weights: host array of the 5 device
// pointers wq, wk, wv, wo (nn.Linear layout (out, in)) and bo. G: positions
// per block (G * F <= 64). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int fyc_temporal_block(const void* x, const void* const* weights,
                                  void* out, int P, int F, int C, int heads,
                                  int G, float scale, void* stream) {
  if (P <= 0 || F <= 0 || F > 32 || heads <= 0 || C % heads != 0 || G <= 0 ||
      G * F > 64 || fyc::TemporalLayout(G * F, F, C).bytes > fyc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = G * F;
  if (rows <= 16)
    return (int)fyc::tb_launch<16>(weights, x, out, P, F, C, heads, G, scale,
                                   s);
  if (rows <= 32)
    return (int)fyc::tb_launch<32>(weights, x, out, P, F, C, heads, G, scale,
                                   s);
  return (int)fyc::tb_launch<64>(weights, x, out, P, F, C, heads, G, scale, s);
}
