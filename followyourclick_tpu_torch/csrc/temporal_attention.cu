// Frame-axis attention of the motion module's modular path: two kernels.
//
// Replaces the Pallas TPU kernels of followyourclick_tpu/ops/
// temporal_attention.py:
//  - temporal_attention (_kernel over _attend): per-head softmax attention
//    over S <= 32 frames on the raw (B, S, H * D) layout of the projections;
//    fp32 logits times scale, fp32 softmax, p cast to v's type, p . v
//    accumulated in fp32, cast on the way out;
//  - fused_temporal_block (_fused_kernel): x . Wq, x . Wk, x . Wv (each cast
//    after fp32 accumulation) -> the same attention -> o cast -> o . Wo + bo
//    in fp32 -> cast.
//
// What bounds them on the H100. temporal_attention does 4 * B * S * S * C
// FLOPs against 4 * B * S * C * 2 bytes (bf16 q, k, v in, o out): 2 * S = 32
// operations per byte, far under the card's ~295, so it is bound by device
// memory (84 MB, ~25 us at 3.35 TB/s, at the C = 1280 path shape
// (512, 16, 8, 160)). fused_temporal_block adds the four C x C products,
// 8 * B * S * C^2 FLOPs against the same 2 * B * S * C * 2 bytes: 2 * C
// operations per byte, compute-bound once q, k, v and o stay on chip.
//
// What the design does. temporal_attention: one block per (row b, head);
// it stages that head's q, k and v (S x D each, fp32, rows padded by one
// float so the score loop's strided reads spread over the banks), computes
// the S x S scores, the softmax (softmax_rows of common.cuh) and p . v, and
// writes its D columns of o. One read and one write of each value, nothing
// else in device memory. fused_temporal_block: the attention sublayer of
// the motion-block kernel without its LayerNorm, PE and residual: a block
// owns G whole positions (G * S rows, at most 64), keeps x, q, k, v and o in
// shared memory, runs frame_attention (common.cuh: the all-head q/k/v
// products and the per-head softmax) and the out-projection, and writes
// each output once. bf16 products run on the tensor cores through WMMA,
// fp32 ones on FMA tiles. The TPU kernels' head-block mask, tile repeat and
// segmented softmax are lane-layout devices and are not carried over: each
// (row, head, query) softmax is computed directly.
#include "common.cuh"

namespace fyc {

// ---- temporal_attention ---------------------------------------------------

__host__ __device__ constexpr size_t ta_smem_bytes(int S, int D) {
  return (size_t)(3 * S * (D + 1) + S * S) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
temporal_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out, int S,
                          int H, int D, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int ld = D + 1;
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + S * ld;
  float* vs = ks + S * ld;
  float* s = vs + S * ld;
  const int b = blockIdx.x / H, hd = blockIdx.x % H;
  const size_t C = (size_t)H * D;
  const size_t base = (size_t)b * S * C + (size_t)hd * D;

  for (int i = threadIdx.x; i < S * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const size_t at = base + r * C + c;
    qs[r * ld + c] = to_f(q[at]);
    ks[r * ld + c] = to_f(k[at]);
    vs[r * ld + c] = to_f(v[at]);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < S * S; i += kThreads) {
    const int r = i / S, j = i % S;
    const float* qr = qs + r * ld;
    const float* kr = ks + j * ld;
    float dot = 0.f;
    for (int c = 0; c < D; ++c) dot = fmaf(qr[c], kr[c], dot);
    s[i] = dot * scale;
  }
  __syncthreads();
  softmax_rows<T>(s, S, S);
  __syncthreads();
  for (int i = threadIdx.x; i < S * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float acc = 0.f;
    for (int j = 0; j < S; ++j) acc = fmaf(s[r * S + j], vs[j * ld + c], acc);
    out[base + r * C + c] = from_f<T>(acc);
  }
}

template <typename T>
cudaError_t ta_launch(const void* q, const void* k, const void* v, void* out,
                      int B, int S, int H, int D, float scale,
                      cudaStream_t stream) {
  const size_t bytes = ta_smem_bytes(S, D);
  auto kern = temporal_attention_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  kern<<<B * H, kThreads, bytes, stream>>>((const T*)q, (const T*)k,
                                           (const T*)v, (T*)out, S, H, D,
                                           scale);
  return cudaGetLastError();
}

// ---- fused_temporal_block -------------------------------------------------

struct TemporalLayout {
  size_t xn, q, k, v, s, work, bytes;
  __host__ __device__ TemporalLayout(int rows, int f, int c, size_t tsize) {
    SmemCursor cur;
    const size_t t = tsize, r = (size_t)frag_rows(rows);
    xn = cur.take<char>(r * padded(c, t) * t);
    q = cur.take<char>(r * c * t);
    k = cur.take<char>(r * c * t);
    v = cur.take<char>(r * c * t);
    s = cur.take<float>(r * f);
    work = cur.take<char>(work_bytes(t));
    bytes = cur.off;
  }
};

template <typename T, int MC>
__global__ void __launch_bounds__(kThreads)
temporal_block_kernel(const T* __restrict__ x, const T* __restrict__ wq,
                      const T* __restrict__ wk, const T* __restrict__ wv,
                      const T* __restrict__ wo, const T* __restrict__ bo,
                      T* __restrict__ out, int P, int F, int C, int heads,
                      int G, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TemporalLayout lay(G * F, F, C, sizeof(T));
  T* xn = reinterpret_cast<T*>(smem + lay.xn);
  T* q = reinterpret_cast<T*>(smem + lay.q);
  T* k = reinterpret_cast<T*>(smem + lay.k);
  T* v = reinterpret_cast<T*>(smem + lay.v);
  float* s = reinterpret_cast<float*>(smem + lay.s);
  void* work = smem + lay.work;

  const size_t row0 = (size_t)blockIdx.x * G * F;
  const int M = min(G, P - (int)(blockIdx.x * G)) * F;
  const int lx = padded(C, sizeof(T));
  for (int i = threadIdx.x; i < M * C; i += kThreads)
    xn[(size_t)(i / C) * lx + i % C] = x[row0 * C + i];
  // (block_gemm_nt opens with a barrier)
  frame_attention<T, MC>(xn, lx, q, k, v, s, work, M, F, C, heads, scale, wq,
                         wk, wv);
  // out = T(o . Wo^T + bo), the bias added in fp32
  block_gemm_nt<T, MC>(xn, lx, M, wo, C, C, C, work, [&](int m, int n, float y) {
    out[(row0 + m) * C + n] = from_f<T>(y + to_f(bo[n]));
  });
}

template <typename T, int MC>
cudaError_t tb_launch(const void* const* w, const void* x, void* out, int P,
                      int F, int C, int heads, int G, float scale,
                      cudaStream_t stream) {
  const TemporalLayout lay(G * F, F, C, sizeof(T));
  auto kern = temporal_block_kernel<T, MC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (P + G - 1) / G;
  kern<<<blocks, kThreads, lay.bytes, stream>>>(
      (const T*)x, (const T*)w[0], (const T*)w[1], (const T*)w[2],
      (const T*)w[3], (const T*)w[4], (T*)out, P, F, C, heads, G, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t tb_dispatch(const void* const* w, const void* x, void* out, int P,
                        int F, int C, int heads, int G, float scale,
                        cudaStream_t stream) {
  const int rows = G * F;
  if (rows <= 16)
    return tb_launch<T, 16>(w, x, out, P, F, C, heads, G, scale, stream);
  if (rows <= 32)
    return tb_launch<T, 32>(w, x, out, P, F, C, heads, G, scale, stream);
  if (rows <= 64)
    return tb_launch<T, 64>(w, x, out, P, F, C, heads, G, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace fyc

// Shared memory one temporal_attention block takes (S frames, head dim D).
extern "C" long long fyc_temporal_attention_smem_bytes(int S, int D) {
  return (long long)fyc::ta_smem_bytes(S, D);
}

// q, k, v, out: (B, S, H, D) contiguous. dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fyc_temporal_attention(const void* q, const void* k,
                                      const void* v, void* out, int B, int S,
                                      int H, int D, float scale, int dtype,
                                      void* stream) {
  if (B <= 0 || S <= 0 || S > 32 || H <= 0 || D <= 0 ||
      (long long)B * H > 2147483647LL ||
      fyc::ta_smem_bytes(S, D) > fyc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)fyc::ta_launch<__nv_bfloat16>(q, k, v, out, B, S, H, D, scale,
                                              s);
  return (int)fyc::ta_launch<float>(q, k, v, out, B, S, H, D, scale, s);
}

// Shared memory one fused_temporal_block block takes for G positions of F
// frames at width C.
extern "C" long long fyc_temporal_block_smem_bytes(int G, int F, int C,
                                                   int dtype) {
  return (long long)fyc::TemporalLayout(G * F, F, C, dtype == 1 ? 2 : 4).bytes;
}

// x, out: (P, F, C) contiguous; weights: host array of the 5 device
// pointers wq, wk, wv, wo (nn.Linear layout (out, in)) and bo. dtype: 0 =
// float32, 1 = bfloat16. G: positions per block (G * F <= 64). Returns the
// cudaError_t of the launch (0 on success).
extern "C" int fyc_temporal_block(const void* x, const void* const* weights,
                                  void* out, int P, int F, int C, int heads,
                                  int G, float scale, int dtype,
                                  void* stream) {
  if (P <= 0 || F <= 0 || F > 32 || heads <= 0 || C % heads != 0 || G <= 0 ||
      G * F > 64 ||
      fyc::TemporalLayout(G * F, F, C, dtype == 1 ? 2 : 4).bytes >
          fyc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)fyc::tb_dispatch<__nv_bfloat16>(weights, x, out, P, F, C,
                                                heads, G, scale, s);
  return (int)fyc::tb_dispatch<float>(weights, x, out, P, F, C, heads, G,
                                      scale, s);
}
