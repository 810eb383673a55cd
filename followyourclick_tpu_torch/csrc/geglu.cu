// LayerNorm -> GEGLU feed-forward -> +residual over (R, C) token rows.
//
// Replaces the Pallas TPU kernel followyourclick_tpu/ops/geglu.py,
// fused_ln_geglu (_ln_kernel): LN with fp32 statistics, x . W1 + b1 to
// 2 * inner channels, h * gelu(gate), . W2 + b2, + x.
//
// What bounds it on the H100: the two products, 2 * R * C * 3 * inner
// FLOPs (about 0.32 TFLOP per call at every UNet width of the 16-frame
// 512^2 CFG step), against R * C * 2 * 2 bytes of activations in and out.
// At 320 operations per byte it is compute-bound, and the XLA/PyTorch
// formulation additionally writes and re-reads the (R, 2 * inner)
// intermediate (~670 MB at 64^2 / C = 320).
//
// What the design does: a block owns a tile of M rows (16, 32 or 64, sized
// by C against the 227 KB of shared memory) and keeps everything of the
// row tile on chip: the LN output (T), an fp32 (M, C) accumulator, one
// 64-wide chunk of the value/gate columns (fp32) and of the gated product
// (T). The intermediate never reaches device memory; x is read once (twice
// with the residual, from L2) and the output written once. bf16 products
// run on the tensor cores through WMMA with the weights read from L2, fp32
// ones on FMA tiles (common.cuh) -- simple and right first; wgmma, TMA and
// a pipelined weight stream come later.
#include "common.cuh"

namespace fyc {

struct GegluLayout {
  size_t xn, acc, hbuf, ybuf, work, bytes;
  __host__ __device__ GegluLayout(int mc, int c, size_t tsize) {
    SmemCursor cur;
    const size_t t = tsize;
    xn = cur.take<char>((size_t)mc * padded(c, t) * t);
    acc = cur.take<float>((size_t)mc * padded(c, 4));
    hbuf = cur.take<float>((size_t)mc * 2 * kJC);
    ybuf = cur.take<char>((size_t)mc * padded(kJC, t) * t);
    work = cur.take<char>(work_bytes(t));
    bytes = cur.off;
  }
};

template <typename T, int MC>
__global__ void __launch_bounds__(kThreads)
ln_geglu_kernel(const T* __restrict__ x, const T* __restrict__ ls,
                const T* __restrict__ lb, const T* __restrict__ w1,
                const T* __restrict__ b1, const T* __restrict__ w2,
                const T* __restrict__ b2, T* __restrict__ out, int R, int C,
                int inner, float eps, int residual, int fast) {
  extern __shared__ __align__(128) unsigned char smem[];
  const GegluLayout lay(MC, C, sizeof(T));
  T* xn = reinterpret_cast<T*>(smem + lay.xn);
  float* acc = reinterpret_cast<float*>(smem + lay.acc);
  float* hbuf = reinterpret_cast<float*>(smem + lay.hbuf);
  T* ybuf = reinterpret_cast<T*>(smem + lay.ybuf);
  void* work = smem + lay.work;

  const size_t r0 = (size_t)blockIdx.x * MC;
  const int M = min(MC, (int)(R - r0));
  const T* xt = x + r0 * C;

  const int lacc = padded(C, 4);
  ln_rows<T>(xt, M, C, ls, lb, eps, nullptr, 1, xn, padded(C, sizeof(T)));
  for (int i = threadIdx.x; i < M * lacc; i += kThreads) acc[i] = 0.f;
  ff_accumulate<T, MC>(xn, M, C, inner, w1, b1, w2, fast, acc, hbuf, ybuf,
                       work);

  for (int i = threadIdx.x; i < M * C; i += kThreads) {
    float o = rnd<T>(acc[i / C * lacc + i % C] + to_f(b2[i % C]));
    if (residual) o = rnd<T>(o + to_f(xt[i]));
    out[r0 * C + i] = from_f<T>(o);
  }
}

template <typename T, int MC>
cudaError_t geglu_launch(const void* x, const void* ls, const void* lb,
                   const void* w1, const void* b1, const void* w2,
                   const void* b2, void* out, int R, int C, int inner,
                   float eps, int residual, int fast, cudaStream_t stream) {
  const GegluLayout lay(MC, C, sizeof(T));
  auto kern = ln_geglu_kernel<T, MC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (R + MC - 1) / MC;
  kern<<<blocks, kThreads, lay.bytes, stream>>>(
      (const T*)x, (const T*)ls, (const T*)lb, (const T*)w1, (const T*)b1,
      (const T*)w2, (const T*)b2, (T*)out, R, C, inner, eps, residual, fast);
  return cudaGetLastError();
}

template <typename T>
cudaError_t geglu_dispatch(int rows, const void* x, const void* ls, const void* lb,
                     const void* w1, const void* b1, const void* w2,
                     const void* b2, void* out, int R, int C, int inner,
                     float eps, int residual, int fast, cudaStream_t stream) {
  switch (rows) {
    case 16: return geglu_launch<T, 16>(x, ls, lb, w1, b1, w2, b2, out, R, C, inner, eps, residual, fast, stream);
    case 32: return geglu_launch<T, 32>(x, ls, lb, w1, b1, w2, b2, out, R, C, inner, eps, residual, fast, stream);
    case 64: return geglu_launch<T, 64>(x, ls, lb, w1, b1, w2, b2, out, R, C, inner, eps, residual, fast, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace fyc

// Shared memory one block takes for a tile of `rows` rows of width C.
extern "C" long long fyc_ln_geglu_smem_bytes(int rows, int C, int dtype) {
  return (long long)fyc::GegluLayout(rows, C, dtype == 1 ? 2 : 4).bytes;
}

// dtype: 0 = float32, 1 = bfloat16. rows: 16, 32 or 64 rows per block.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fyc_ln_geglu(const void* x, const void* ls, const void* lb,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, int R, int C,
                            int inner, float eps, int residual, int fast,
                            int dtype, int rows, void* stream) {
  if (fyc::GegluLayout(rows, C, dtype == 1 ? 2 : 4).bytes > fyc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)fyc::geglu_dispatch<__nv_bfloat16>(rows, x, ls, lb, w1, b1, w2, b2,
                                             out, R, C, inner, eps, residual,
                                             fast, s);
  return (int)fyc::geglu_dispatch<float>(rows, x, ls, lb, w1, b1, w2, b2, out, R, C,
                                   inner, eps, residual, fast, s);
}
