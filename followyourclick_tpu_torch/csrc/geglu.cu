// LayerNorm -> GEGLU feed-forward -> +residual over (R, C) token rows.
//
// Replaces the Pallas TPU kernels of followyourclick_tpu/ops/geglu.py:
// fused_ln_geglu (_ln_kernel): LN with fp32 statistics, x . W1 + b1 to
// 2 * inner channels, h * gelu(gate), . W2 + b2, + x; and fused_geglu
// (_kernel), the same feed-forward without the LN and the residual.
//
// What bounds it on the H100: the two products, 2 * R * C * 3 * inner
// FLOPs (about 0.32 TFLOP per call at every UNet width of the 16-frame
// 512^2 CFG step), against R * C * 2 * 2 bytes of activations in and out.
// At 320 operations per byte it is bound by operations.
//
// bf16 (every path of the sampler): three launches per call.
//  (a) ln_bf16_kernel: ln_rows (common.cuh), fp32 two-pass statistics,
//      xn = bf16(LN(x) * s + b) written to device memory exactly where the
//      Pallas kernel casts it.
//  (b) the GEMM core of gemm.cuh on xn . W1^T with paired tiles: each block
//      holds 128 value columns j0.. and the matching 128 gate columns
//      inner + j0.., so the epilogue adds b1 in fp32, applies gate_mul
//      (common.cuh, both gate forms; two columns at a time in packed bf16,
//      bit for bit) and stores y = h * gelu(gate) in bf16.
//  (c) the GEMM core on y . W2^T (160-column tiles, which divide 320, 640
//      and 1280), + b2 in fp32, rounded to bf16, + x in bf16, rounded.
// fused_geglu is (b) on x itself and (c) without the residual. What this
// costs against keeping the (R, inner) intermediate on chip, as the Pallas
// kernel does: y is written and read once in bf16 (at C = 320, 671 MB, about
// 0.2 ms at 3.35 TB/s). What it buys: the fp32 (rows, C) accumulator of an
// all-on-chip tile does not fit Hopper's registers at C = 1280, and tiles
// small enough to hold it re-read every weight from L2 per 64 rows. Each
// product here streams its operands by TMA into a 4-5 stage ring and keeps
// its accumulators in registers.
//
// fp32: the all-on-chip kernel (ln_geglu_kernel): a block owns a tile of
// M rows (16, 32 or 64, sized by C against the 227 KB of shared memory) and
// keeps everything of the row tile on chip -- the LN output, an fp32 (M, C)
// accumulator, one 64-wide chunk of the value/gate columns and of the gated
// product -- with the products on FMA tiles (common.cuh); fused_geglu is its
// LN-off, residual-off mode (the row tile is copied where the LN would have
// written it).
#include "common.cuh"
#include "gemm.cuh"

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
                int inner, float eps, int ln, int residual, int fast) {
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

  const int lacc = padded(C, 4), lx = padded(C, sizeof(T));
  if (ln) {
    ln_rows<T>(xt, M, C, ls, lb, eps, nullptr, 1, xn, lx);
  } else {
    for (int i = threadIdx.x; i < M * C; i += kThreads)
      xn[i / C * lx + i % C] = xt[i];
  }
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
                   float eps, int ln, int residual, int fast,
                   cudaStream_t stream) {
  const GegluLayout lay(MC, C, sizeof(T));
  auto kern = ln_geglu_kernel<T, MC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (R + MC - 1) / MC;
  kern<<<blocks, kThreads, lay.bytes, stream>>>(
      (const T*)x, (const T*)ls, (const T*)lb, (const T*)w1, (const T*)b1,
      (const T*)w2, (const T*)b2, (T*)out, R, C, inner, eps, ln, residual,
      fast);
  return cudaGetLastError();
}

cudaError_t geglu_fp32(int rows, const void* x, const void* ls,
                       const void* lb, const void* w1, const void* b1,
                       const void* w2, const void* b2, void* out, int R,
                       int C, int inner, float eps, int ln, int residual,
                       int fast, cudaStream_t stream) {
  if (GegluLayout(rows, C, sizeof(float)).bytes > kMaxSmem)
    return cudaErrorInvalidValue;
  switch (rows) {
    case 16: return geglu_launch<float, 16>(x, ls, lb, w1, b1, w2, b2, out, R, C, inner, eps, ln, residual, fast, stream);
    case 32: return geglu_launch<float, 32>(x, ls, lb, w1, b1, w2, b2, out, R, C, inner, eps, ln, residual, fast, stream);
    case 64: return geglu_launch<float, 64>(x, ls, lb, w1, b1, w2, b2, out, R, C, inner, eps, ln, residual, fast, stream);
    default: return cudaErrorInvalidValue;
  }
}

// ---- bf16: LN pass, then two wgmma products --------------------------------

// xn = bf16(LN(x) * ls + lb) [+ pe[row % F], rounded] over the block's
// kWarps rows: ln_rows (common.cuh), one warp per row, fp32 two-pass
// statistics.
__global__ void __launch_bounds__(kThreads)
ln_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ ls,
               const bf16* __restrict__ lb, const bf16* __restrict__ pe,
               bf16* __restrict__ xn, int R, int C, int F, float eps) {
  const size_t r0 = (size_t)blockIdx.x * kWarps;
  ln_rows<bf16>(x + r0 * C, min(kWarps, (int)(R - r0)), C, ls, lb, eps, pe,
                F, xn + r0 * C, C, r0);
}

// gate_mul (common.cuh) of two adjacent columns, bit for bit. The tanh
// form's bf16 steps run as packed bf16x2 arithmetic: a product or a sum of
// two bf16 values rounded once to bf16 equals rbf of the fp32 operation
// (the product is exact in fp32; so is the sum, unless the exponents differ
// by more than 16, when both roundings give the larger operand). One packed
// operation replaces two fp32 operations and four scalar conversions.
static __device__ __forceinline__ __nv_bfloat162 gate_mul2(float h0, float h1,
                                                           float g0, float g1,
                                                           int fast) {
  if (!fast)
    return __floats2bfloat162_rn(gate_mul<bf16>(h0, g0, 0),
                                 gate_mul<bf16>(h1, g1, 0));
  const __nv_bfloat162 gb = __floats2bfloat162_rn(g0, g1);
  const __nv_bfloat162 hb = __floats2bfloat162_rn(h0, h1);
  const __nv_bfloat162 c1 = __float2bfloat162_rn(0.044715f);
  const __nv_bfloat162 c2 = __float2bfloat162_rn(0.7978845608f);
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  const __nv_bfloat162 one = __float2bfloat162_rn(1.0f);
  const __nv_bfloat162 cube = __hmul2(__hmul2(__hmul2(c1, gb), gb), gb);
  const float2 inner = __bfloat1622float2(__hmul2(c2, __hadd2(gb, cube)));
  const __nv_bfloat162 th =
      __floats2bfloat162_rn(tanhf(inner.x), tanhf(inner.y));
  const __nv_bfloat162 g = __hmul2(__hmul2(half, gb), __hadd2(one, th));
  return __hmul2(hb, g);
}

// (b)'s epilogue: y[r, j] = bf16(gate_mul(h + b1[j], g + b1[inner + j]))
struct GegluUpEpi {
  const bf16* b1;
  bf16* y;
  int R, inner, fast;
  template <int N>
  __device__ void operator()(float (&acc)[2][N], int row, int col) const {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const int j = col + 8 * i;
      if (j >= inner) continue;
      const float2 bh = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b1 + j));
      const float2 bg = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b1 + inner + j));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= R) continue;
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r * inner + j) =
            gate_mul2(acc[0][4 * i + 2 * h] + bh.x,
                      acc[0][4 * i + 2 * h + 1] + bh.y,
                      acc[1][4 * i + 2 * h] + bg.x,
                      acc[1][4 * i + 2 * h + 1] + bg.y, fast);
      }
    }
  }
};

// (c)'s epilogue: out = bf16(acc + b2) [then bf16(out + x)]
struct GegluDownEpi {
  const bf16* b2;
  const bf16* x;  // the residual, or nullptr
  bf16* out;
  int R, C;
  template <int N>
  __device__ void operator()(float (&acc)[1][N], int row, int col) const {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const int n = col + 8 * i;
      if (n >= C) continue;
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(b2 + n));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r >= R) continue;
        float o0 = rbf(acc[0][4 * i + 2 * h] + b.x);
        float o1 = rbf(acc[0][4 * i + 2 * h + 1] + b.y);
        const size_t at = (size_t)r * C + n;
        if (x != nullptr) {
          const float2 xr = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(x + at));
          o0 = rbf(o0 + xr.x);
          o1 = rbf(o1 + xr.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + at) =
            __floats2bfloat162_rn(o0, o1);
      }
    }
  }
};

constexpr int kUpBN = 128, kUpStages = 4;
constexpr int kDownBN = 160, kDownStages = 5;  // 160 divides 320, 640, 1280

}  // namespace fyc

// Shared memory one block of the fp32 kernel takes for `rows` rows of C.
extern "C" long long fyc_ln_geglu_smem_bytes(int rows, int C) {
  return (long long)fyc::GegluLayout(rows, C, sizeof(float)).bytes;
}

// fp32 (the all-on-chip kernel), rows: 16, 32 or 64 rows per block.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int fyc_ln_geglu(const void* x, const void* ls, const void* lb,
                            const void* w1, const void* b1, const void* w2,
                            const void* b2, void* out, int R, int C,
                            int inner, float eps, int residual, int fast,
                            int rows, void* stream) {
  return (int)fyc::geglu_fp32(rows, x, ls, lb, w1, b1, w2, b2, out, R, C,
                              inner, eps, 1, residual, fast,
                              (cudaStream_t)stream);
}

// fp32, the LN-off, residual-off mode (fused_geglu).
extern "C" int fyc_geglu(const void* x, const void* w1, const void* b1,
                         const void* w2, const void* b2, void* out, int R,
                         int C, int inner, int fast, int rows, void* stream) {
  return (int)fyc::geglu_fp32(rows, x, nullptr, nullptr, w1, b1, w2, b2, out,
                              R, C, inner, 0.f, 0, 0, fast,
                              (cudaStream_t)stream);
}

// bf16 (a): xn = bf16(LN(x)), (R, C) contiguous; with pe (F, C) not
// nullptr, + pe[row % F] rounded to bf16 (the motion block's LN + PE).
extern "C" int fyc_ln_rows_bf16(const void* x, const void* ls,
                                const void* lb, const void* pe, void* xn,
                                int R, int C, int F, float eps,
                                void* stream) {
  if (R <= 0 || C <= 0 || F <= 0) return (int)cudaErrorInvalidValue;
  const int blocks = (R + fyc::kWarps - 1) / fyc::kWarps;
  fyc::ln_bf16_kernel<<<blocks, fyc::kThreads, 0, (cudaStream_t)stream>>>(
      (const fyc::bf16*)x, (const fyc::bf16*)ls, (const fyc::bf16*)lb,
      (const fyc::bf16*)pe, (fyc::bf16*)xn, R, C, F, eps);
  return (int)cudaGetLastError();
}

// bf16 (b): y (R, inner) = gate(a . W1^T + b1), a (R, C), W1 (2 inner, C).
// C and inner multiples of 8 (16-byte rows for TMA), pointers 16-byte
// aligned.
extern "C" int fyc_geglu_up_bf16(const void* a, const void* w1,
                                 const void* b1, void* y, int R, int C,
                                 int inner, int fast, void* stream) {
  if (R <= 0 || C % 8 || inner % 8 || C <= 0 || inner <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!fyc::hopper::make_map_2d(&ta, a, R, C, fyc::kGemmBM) ||
      !fyc::hopper::make_map_2d(&tb, w1, 2 * (uint64_t)inner, C, fyc::kUpBN))
    return (int)cudaErrorInvalidValue;
  const fyc::GegluUpEpi epi{(const fyc::bf16*)b1, (fyc::bf16*)y, R, inner,
                            fast};
  return (int)fyc::gemm_launch<fyc::kUpBN, 2, fyc::kUpStages>(
      ta, tb, R, inner, C, inner, epi, (cudaStream_t)stream);
}

// bf16 (c): out (R, C) = bf16(y . W2^T + b2) [+ x, rounded], W2 (C, inner);
// x = nullptr skips the residual.
extern "C" int fyc_geglu_down_bf16(const void* y, const void* w2,
                                   const void* b2, const void* x, void* out,
                                   int R, int C, int inner, void* stream) {
  if (R <= 0 || C % 8 || inner % 8 || C <= 0 || inner <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb;
  if (!fyc::hopper::make_map_2d(&ta, y, R, inner, fyc::kGemmBM) ||
      !fyc::hopper::make_map_2d(&tb, w2, C, inner, fyc::kDownBN))
    return (int)cudaErrorInvalidValue;
  const fyc::GegluDownEpi epi{(const fyc::bf16*)b2, (const fyc::bf16*)x,
                              (fyc::bf16*)out, R, C};
  return (int)fyc::gemm_launch<fyc::kDownBN, 1, fyc::kDownStages>(
      ta, tb, R, C, inner, 0, epi, (cudaStream_t)stream);
}
