// The motion-module transformer block over the frames-minor (P, F, C) rows
// (P = B * H * W spatial positions, R = P * F rows).
//
// Replaces the Pallas TPU kernel followyourclick_tpu/ops/motion_block.py,
// fused_motion_block (_kernel): twice [LN (fp32 statistics) -> + PE ->
// q/k/v projections -> per-head softmax over the F frames -> out-proj +
// bias -> + residual], then LN -> GEGLU feed-forward -> + residual.
//
// What bounds it on the H100: the products, 2 * R * C * (8 * C + 12 * C)
// FLOPs (about 0.54 TFLOP per call at 64^2 / C = 320 in the 16-frame CFG
// step), against 2 * R * C * 2 bytes in and out: bound by operations.
//
// bf16 (every path of the sampler): eleven launches per call, all on the
// GEMM core of gemm.cuh or on device code the other kernels already run;
// the wrapper (ops/motion_block.py) sequences them. Per attention sublayer:
//  (a) the LN pass of geglu.cu (fyc_ln_rows_bf16 on common.cuh's ln_rows)
//      with the PE table: t = bf16(bf16(LN(h)) + pe[row % F]);
//  (b) q | k | v = bf16(t . Wqkv^T) on the GEMM core, here: one product
//      over the (3C, C) concatenation of Wq, Wk, Wv (160-wide tiles, which
//      divide 3C = 960, 1920 and 3840), the epilogue storing each column to
//      q, k or v by its range;
//  (c) the frame attention of temporal_attention.cu (fyc_temporal_attention)
//      over (P, F, heads, C / heads): fp32 scores and softmax, p rounded to
//      bf16, o = bf16(p . v);
//  (d) the down-projection of geglu.cu (fyc_geglu_down_bf16, inner = C):
//      h' = bf16(h + bf16(o . Wo^T + bo)), into a buffer other than h.
// Then the feed-forward: geglu.cu's three launches (LN, up-projection with
// the gate, down-projection with the residual). Every intermediate goes to
// device memory rounded exactly where the Pallas kernel rounds (the LN
// output + PE, q, k, v, o, h after each residual, the gated FF rows), so the
// split changes no numerics. Against keeping the block on chip it moves
// about 37 * R * C more bf16 values (3.1 GB, 0.93 ms at 3.35 TB/s, at 8192
// positions x C = 320); what it buys: every product streams its
// operands by TMA into a 5-stage ring and runs on wgmma with 128-row
// tiles, where an all-on-chip block holds at most 64 rows of the residual
// stream (16 at C = 1280) and re-reads all 20 C^2 weights from L2 per block.
//
// fp32: the all-on-chip kernel (motion_block_kernel). A
// block owns G whole positions (G * F rows, at most 64) and keeps their
// residual stream in shared memory across all three sublayers: q, k, v for
// all heads at once, head by head the F x F scores, the softmax and o = p . v
// (frame_attention in common.cuh, shared with fused_temporal_block), the
// out-projection added into h, then the LN and the FF (the device code of
// the fp32 LN-GEGLU kernel) over the q/k/v space. fp32 at C >= 640 does not
// fit the 227 KB, and the model routes such blocks to the modular kernels.
// Its products run on FMA tiles (common.cuh).
#include "common.cuh"
#include "gemm.cuh"

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
  const int lx = padded(C, sizeof(T));

  ln_rows<T>(h, M, C, ls, lb, eps, pe, F, xn, lx);
  // o (over the LN output in xn) = the heads' attention
  frame_attention<T, MC>(xn, lx, q, k, v, s, work, M, F, C, heads, scale, wq,
                         wk, wv);
  // h += T(o . Wo^T + bo), each output written once
  block_gemm_nt<T, MC>(xn, lx, M, wo, C, C, C, work, [&](int m, int n, float x) {
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

cudaError_t mb_dispatch(const void* x, const void* pe, const MotionParams& prm,
                        void* out, int P, int F, int C, int heads, int G,
                        float scale, float eps, int fast, cudaStream_t stream) {
  const int rows = G * F;
  if (rows <= 16)
    return mb_launch<float, 16>(x, pe, prm, out, P, F, C, heads, G, scale, eps, fast, stream);
  if (rows <= 32)
    return mb_launch<float, 32>(x, pe, prm, out, P, F, C, heads, G, scale, eps, fast, stream);
  if (rows <= 64)
    return mb_launch<float, 64>(x, pe, prm, out, P, F, C, heads, G, scale, eps, fast, stream);
  return cudaErrorInvalidValue;
}

// (b)'s epilogue: column n of the (3C)-wide product goes to q, k or v
// (R, C) by its range, rounded to bf16 (each pair n, n + 1 lies in one
// range: C is even)
struct QkvEpi {
  bf16* q;
  bf16* k;
  bf16* v;
  int R, C;
  template <int N>
  __device__ void operator()(float (&acc)[1][N], int row, int col) const {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const int n = col + 8 * i;
      if (n >= 3 * C) continue;
      const int part = n / C, c = n - part * C;
      bf16* dst = part == 0 ? q : part == 1 ? k : v;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= R) continue;
        *reinterpret_cast<__nv_bfloat162*>(dst + (size_t)r * C + c) =
            __floats2bfloat162_rn(acc[0][4 * i + 2 * h],
                                  acc[0][4 * i + 2 * h + 1]);
      }
    }
  }
};

constexpr int kQkvBN = 160, kQkvStages = 5;  // 160 divides 3C at 320..1280

}  // namespace fyc

// Shared memory one block of the fp32 kernel takes for G positions of F
// frames at width C.
extern "C" long long fyc_motion_block_smem_bytes(int G, int F, int C) {
  return (long long)fyc::MotionLayout(G * F, F, C, sizeof(float)).bytes;
}

// fp32, the all-on-chip kernel. params: host array of the 20 device
// pointers. G: positions per block (G * F <= 64). Returns the cudaError_t
// of the launch (0 on success).
extern "C" int fyc_motion_block(const void* x, const void* pe,
                                const void* const* params, void* out, int P,
                                int F, int C, int heads, int G, float scale,
                                float eps, int fast, void* stream) {
  if (C % heads != 0 || G * F > 64 ||
      fyc::MotionLayout(G * F, F, C, sizeof(float)).bytes > fyc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  fyc::MotionParams prm;
  for (int i = 0; i < 20; ++i) prm.p[i] = params[i];
  return (int)fyc::mb_dispatch(x, pe, prm, out, P, F, C, heads, G, scale,
                               eps, fast, (cudaStream_t)stream);
}

// bf16 (b): q, k, v (R, C) = bf16(t . W^T) of the three C-row ranges of
// wqkv (3C, C) = [Wq; Wk; Wv]. C a multiple of 8 (16-byte rows for TMA),
// pointers 16-byte aligned.
extern "C" int fyc_qkv_bf16(const void* t, const void* wqkv, void* q, void* k,
                            void* v, int R, int C, void* stream) {
  if (R <= 0 || C <= 0 || C % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!fyc::hopper::make_map_2d(&ta, t, R, C, fyc::kGemmBM) ||
      !fyc::hopper::make_map_2d(&tb, wqkv, 3 * (uint64_t)C, C, fyc::kQkvBN))
    return (int)cudaErrorInvalidValue;
  const fyc::QkvEpi epi{(fyc::bf16*)q, (fyc::bf16*)k, (fyc::bf16*)v, R, C};
  return (int)fyc::gemm_launch<fyc::kQkvBN, 1, fyc::kQkvStages>(
      ta, tb, R, 3 * C, C, 0, epi, (cudaStream_t)stream);
}
