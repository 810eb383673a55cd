// The whole motion-module transformer block in one kernel, over the
// frames-minor (P, F, C) rows (P = B * H * W spatial positions).
//
// Replaces the Pallas TPU kernel followyourclick_tpu/ops/motion_block.py,
// fused_motion_block (_kernel): twice [LN (fp32 statistics) -> + PE ->
// q/k/v projections -> per-head softmax over the F frames -> out-proj +
// bias -> + residual], then LN -> GEGLU feed-forward -> + residual.
//
// What bounds it on the H100: the projections, 2 * P * F * C * (8 * C +
// 12 * C) FLOPs (about 0.54 TFLOP per call at 64^2 / C = 320 in the 16-frame
// CFG step) against 2 * P * F * C * 2 bytes in and out: compute-bound, as
// long as the residual stream and the intermediates stay on chip. The
// modular formulation writes and re-reads the hidden state about ten times
// per block (two LNs, q/k/v, the scores, the FF intermediate).
//
// What the design does: a block owns G whole spatial positions (G * F rows,
// at most 64) and keeps their residual stream in shared memory across all
// three sublayers, so h is read once and written once. Each attention
// sublayer projects q, k, v for all heads at once (three full-width
// products), then runs head by head: the F x F scores in fp32, the softmax,
// and o = p . v written over the LN output, which is dead by then; one
// out-projection product adds into h. The FF reuses the q/k/v space for its
// fp32 accumulator and chunks, so at C = 1280 in bf16 one position (16
// rows) fits the 227 KB. The TPU kernel's head-block mask and segmented
// softmax are lane-layout devices; here each (position, head, query frame)
// row computes its own softmax directly. The FF is the same device code as
// the LN-GEGLU kernel. bf16 products run on the tensor cores (WMMA), fp32
// ones on FMA tiles (common.cuh).
#include "common.cuh"

namespace fyc {

struct MotionLayout {
  size_t h, xn, q, k, v, acc, hbuf, ybuf, s, work, bytes;
  __host__ __device__ MotionLayout(int rows, int f, int c, size_t tsize) {
    SmemCursor cur;
    const size_t t = tsize, r = (size_t)frag_rows(rows);
    h = cur.take<char>(r * c * t);
    xn = cur.take<char>(r * padded(c, t) * t);
    // attention: q | k | v; the FF overlays acc | hbuf | ybuf on them
    const size_t base = cur.off;
    q = cur.take<char>(r * c * t);
    k = cur.take<char>(r * c * t);
    v = cur.take<char>(r * c * t);
    const size_t attn_end = cur.off;
    cur.off = base;
    acc = cur.take<float>(r * padded(c, 4));
    hbuf = cur.take<float>(r * 2 * kJC);
    ybuf = cur.take<char>(r * padded(kJC, t) * t);
    if (cur.off < attn_end) cur.off = attn_end;
    s = cur.take<float>(r * f);
    work = cur.take<char>(work_bytes(t));
    bytes = cur.off;
  }
};

// the 20 tensors of fused_motion_block, nn.Linear layout for matrices:
// l0s l0b wq0 wk0 wv0 wo0 bo0 | l1s l1b wq1 wk1 wv1 wo1 bo1 |
// lfs lfb w1 b1 w2 b2
struct MotionParams {
  const void* p[20];
};

template <typename T, int MC>
__device__ void attention_sublayer(T* h, T* xn, T* q, T* k, T* v, float* s,
                                   void* work, int M, int F, int C,
                                   int heads, float scale, float eps,
                                   const T* pe, const MotionParams& prm,
                                   int base) {
  const T* ls = (const T*)prm.p[base + 0];
  const T* lb = (const T*)prm.p[base + 1];
  const T* wq = (const T*)prm.p[base + 2];
  const T* wk = (const T*)prm.p[base + 3];
  const T* wv = (const T*)prm.p[base + 4];
  const T* wo = (const T*)prm.p[base + 5];
  const T* bo = (const T*)prm.p[base + 6];
  const int d = C / heads, lx = padded(C, sizeof(T));

  ln_rows<T>(h, M, C, ls, lb, eps, pe, F, xn, lx);
  block_gemm_nt<T, MC>(xn, lx, M, wq, C, C, C, work,
                       [&](int m, int n, float x) { q[m * C + n] = from_f<T>(x); });
  block_gemm_nt<T, MC>(xn, lx, M, wk, C, C, C, work,
                       [&](int m, int n, float x) { k[m * C + n] = from_f<T>(x); });
  block_gemm_nt<T, MC>(xn, lx, M, wv, C, C, C, work,
                       [&](int m, int n, float x) { v[m * C + n] = from_f<T>(x); });
  T* o = xn;  // the LN output is dead once q, k, v exist (row stride lx)
  for (int hd = 0; hd < heads; ++hd) {
    const int c0 = hd * d;
    // scores of row m = (position g, query frame) against the F key frames
    for (int i = threadIdx.x; i < M * F; i += kThreads) {
      const int m = i / F, key = (m / F) * F + i % F;
      const T* qr = q + (size_t)m * C + c0;
      const T* kr = k + (size_t)key * C + c0;
      float dot = 0.f;
      for (int j = 0; j < d; ++j) dot = fmaf(to_f(qr[j]), to_f(kr[j]), dot);
      s[i] = dot * scale;
    }
    __syncthreads();
    softmax_rows<T>(s, M, F);
    __syncthreads();
    // o[:, head columns] = p . v, rounded to T
    for (int i = threadIdx.x; i < M * d; i += kThreads) {
      const int m = i / d, n = c0 + i % d, g0 = (m / F) * F;
      float acc = 0.f;
      for (int j = 0; j < F; ++j)
        acc = fmaf(s[m * F + j], to_f(v[(size_t)(g0 + j) * C + n]), acc);
      o[(size_t)m * lx + n] = from_f<T>(acc);
    }
    __syncthreads();
  }
  // h += T(o . Wo^T + bo), each output written once
  block_gemm_nt<T, MC>(o, lx, M, wo, C, C, C, work, [&](int m, int n, float x) {
    h[m * C + n] = from_f<T>(
        rnd<T>(to_f(h[m * C + n]) + rnd<T>(x + to_f(bo[n]))));
  });
}

template <typename T, int MC>
__global__ void __launch_bounds__(kThreads)
motion_block_kernel(const T* __restrict__ x, const T* __restrict__ pe,
                    MotionParams prm, T* __restrict__ out, int P, int F,
                    int C, int heads, int G, float scale, float eps,
                    int fast) {
  extern __shared__ __align__(128) unsigned char smem[];
  const MotionLayout lay(G * F, F, C, sizeof(T));
  T* h = reinterpret_cast<T*>(smem + lay.h);
  T* xn = reinterpret_cast<T*>(smem + lay.xn);
  T* q = reinterpret_cast<T*>(smem + lay.q);
  T* k = reinterpret_cast<T*>(smem + lay.k);
  T* v = reinterpret_cast<T*>(smem + lay.v);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  float* hbuf = reinterpret_cast<float*>(smem + lay.hbuf);
  T* ybuf = reinterpret_cast<T*>(smem + lay.ybuf);
  float* s = reinterpret_cast<float*>(smem + lay.s);
  void* work = smem + lay.work;

  const size_t row0 = (size_t)blockIdx.x * G * F;
  const int M = min(G, P - (int)(blockIdx.x * G)) * F;
  for (int i = threadIdx.x; i < M * C; i += kThreads) h[i] = x[row0 * C + i];
  __syncthreads();

  attention_sublayer<T, MC>(h, xn, q, k, v, s, work, M, F, C, heads, scale,
                            eps, pe, prm, 0);
  attention_sublayer<T, MC>(h, xn, q, k, v, s, work, M, F, C, heads, scale,
                            eps, pe, prm, 7);

  const int lacc = padded(C, 4);
  ln_rows<T>(h, M, C, (const T*)prm.p[14], (const T*)prm.p[15], eps, nullptr,
             1, xn, padded(C, sizeof(T)));
  for (int i = threadIdx.x; i < M * lacc; i += kThreads) acc[i] = 0.f;
  ff_accumulate<T, MC>(xn, M, C, 4 * C, (const T*)prm.p[16],
                       (const T*)prm.p[17], (const T*)prm.p[18], fast, acc,
                       hbuf, ybuf, work);
  const T* b2 = (const T*)prm.p[19];
  for (int i = threadIdx.x; i < M * C; i += kThreads)
    out[row0 * C + i] = from_f<T>(
        rnd<T>(to_f(h[i]) + rnd<T>(acc[i / C * lacc + i % C] +
                                   to_f(b2[i % C]))));
}

template <typename T, int MC>
cudaError_t mb_launch(const void* x, const void* pe, const MotionParams& prm,
                      void* out, int P, int F, int C, int heads, int G,
                      float scale, float eps, int fast, cudaStream_t stream) {
  const MotionLayout lay(G * F, F, C, sizeof(T));
  auto kern = motion_block_kernel<T, MC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (P + G - 1) / G;
  kern<<<blocks, kThreads, lay.bytes, stream>>>(
      (const T*)x, (const T*)pe, prm, (T*)out, P, F, C, heads, G, scale, eps,
      fast);
  return cudaGetLastError();
}

template <typename T>
cudaError_t mb_dispatch(const void* x, const void* pe, const MotionParams& prm,
                        void* out, int P, int F, int C, int heads, int G,
                        float scale, float eps, int fast, cudaStream_t stream) {
  const int rows = G * F;
  if (rows <= 16)
    return mb_launch<T, 16>(x, pe, prm, out, P, F, C, heads, G, scale, eps, fast, stream);
  if (rows <= 32)
    return mb_launch<T, 32>(x, pe, prm, out, P, F, C, heads, G, scale, eps, fast, stream);
  if (rows <= 64)
    return mb_launch<T, 64>(x, pe, prm, out, P, F, C, heads, G, scale, eps, fast, stream);
  return cudaErrorInvalidValue;
}

}  // namespace fyc

// Shared memory one block takes for G positions of F frames at width C.
extern "C" long long fyc_motion_block_smem_bytes(int G, int F, int C,
                                                 int heads, int dtype) {
  return (long long)fyc::MotionLayout(G * F, F, C, dtype == 1 ? 2 : 4).bytes;
}

// params: host array of the 20 device pointers. dtype: 0 = float32,
// 1 = bfloat16. G: positions per block (G * F <= 64). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fyc_motion_block(const void* x, const void* pe,
                                const void* const* params, void* out, int P,
                                int F, int C, int heads, int G, float scale,
                                float eps, int fast, int dtype, void* stream) {
  if (C % heads != 0 || G * F > 64 ||
      fyc::MotionLayout(G * F, F, C, dtype == 1 ? 2 : 4).bytes > fyc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  fyc::MotionParams prm;
  for (int i = 0; i < 20; ++i) prm.p[i] = params[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)fyc::mb_dispatch<__nv_bfloat16>(x, pe, prm, out, P, F, C,
                                                heads, G, scale, eps, fast, s);
  return (int)fyc::mb_dispatch<float>(x, pe, prm, out, P, F, C, heads, G,
                                      scale, eps, fast, s);
}
