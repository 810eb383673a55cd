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
// operations (0.05 TFLOP at 131072 rows of C = 320), against one read and
// one write of the (R, C) rows; the attention itself adds 4 * R * Skv * H * D.
//
// What the design does: a block owns a tile of MC query rows (16, 32 or 64,
// sized against the shared memory by the caller) of one batch row and keeps
// everything of it on chip: the LN output, q for all heads, and per head a
// zero-padded copy of the head's q columns, k rows and v^T, the fp32 scores
// and the cast weights. D is padded to a multiple of 16 (40 -> 48) and Skv to
// one of 16 in shared memory only, so bf16 tiles take the tensor cores
// through WMMA (common.cuh's block_gemm_nt; fp32 takes its FMA tiles). The
// Pallas kernel's block-diagonal head packing (every head's keys in its own
// 128-lane segment, one dot for all heads) is a TPU lane-layout device and
// is not carried over: the block loops over the heads. The attention output
// overwrites the LN output, which is dead once q exists.
#include "common.cuh"

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

template <typename T>
cudaError_t cross_dispatch(int rows, const void* x, const void* k,
                           const void* v, const void* ls, const void* lb,
                           const void* wq, const void* wo, const void* bo,
                           void* out, int B, int S, int C, int heads, int D,
                           int Skv, float scale, float eps,
                           cudaStream_t stream) {
  switch (rows) {
    case 16: return cross_launch<T, 16>(x, k, v, ls, lb, wq, wo, bo, out, B, S, C, heads, D, Skv, scale, eps, stream);
    case 32: return cross_launch<T, 32>(x, k, v, ls, lb, wq, wo, bo, out, B, S, C, heads, D, Skv, scale, eps, stream);
    case 64: return cross_launch<T, 64>(x, k, v, ls, lb, wq, wo, bo, out, B, S, C, heads, D, Skv, scale, eps, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fyc

// Shared memory one block takes for a tile of `rows` query rows.
extern "C" long long fyc_ln_cross_attention_smem_bytes(int rows, int C,
                                                       int heads, int D,
                                                       int Skv, int dtype) {
  return (long long)fyc::CrossLayout(rows, C, heads * D, D, Skv,
                                     dtype == 1 ? 2 : 4).bytes;
}

// x: (B, S, C); k, v: (B, Skv, heads * D) projected keys and values; wq:
// (heads * D, C); wo: (C, heads * D); ls, lb, bo: (C). Skv <= 128.
// dtype: 0 = float32, 1 = bfloat16. rows: 16, 32 or 64 query rows per
// block. Returns the cudaError_t of the launch (0 on success).
extern "C" int fyc_ln_cross_attention(
    const void* x, const void* k, const void* v, const void* ls,
    const void* lb, const void* wq, const void* wo, const void* bo, void* out,
    int B, int S, int C, int heads, int D, int Skv, float scale, float eps,
    int dtype, int rows, void* stream) {
  if (Skv < 1 || Skv > 128 ||
      fyc::CrossLayout(rows, C, heads * D, D, Skv, dtype == 1 ? 2 : 4).bytes >
          fyc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)fyc::cross_dispatch<__nv_bfloat16>(
        rows, x, k, v, ls, lb, wq, wo, bo, out, B, S, C, heads, D, Skv, scale,
        eps, s);
  return (int)fyc::cross_dispatch<float>(rows, x, k, v, ls, lb, wq, wo, bo,
                                         out, B, S, C, heads, D, Skv, scale,
                                         eps, s);
}
