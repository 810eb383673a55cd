// GroupNorm (+SiLU) over (B, N, C) rows, channels last: the statistics of
// each (batch, group) over all N rows and the group's C / G channels.
//
// Replaces the Pallas TPU kernel followyourclick_tpu/ops/groupnorm.py,
// fused_group_norm (_kernel): fp32 statistics shifted by a pilot (the
// group mean of row 0), s1 = sum(x - pilot), s2 = sum((x - pilot)^2),
// var = max(s2 / n - (s1 / n)^2, 0); the affine folded into
// y = x * a + b in fp32 (a = rsqrt(var + eps) * scale, b = bias - mean * a),
// SiLU after it, then the cast.
//
// What bounds it on the H100: bytes. One read and one write of x, 4 bytes
// an element in bf16 against ~10 operations, far below the card's
// operations-per-byte line.
//
// What the design does: the Pallas kernel holds a whole (N, C) slab in
// VMEM; at the UNet's level-0 resnets that slab is 65536 x 320 bf16, 42 MB,
// which fits no block's 227 KB of shared memory. So the kernel takes any N
// in two passes over a grid of (chunk of N, batch) blocks:
//  1. stats: each block sums its chunk's shifted s1, s2 per channel (each
//     thread owns 8 channels of every rg-th row), reduces them over its
//     threads and then over each group's channels in a fixed order, and
//     writes one (s1, s2) pair per group into an fp32 workspace;
//  2. apply: each block reduces the workspace of its batch row over the
//     chunks in order, folds the affine per channel into shared memory and
//     writes y for its chunk. The chunk's second read of x comes from the
//     50 MB L2 when the chunk was read recently.
// No float atomics: repeated runs agree bit for bit.
#include "common.cuh"

namespace fyc {

constexpr int kGnVec = 8;  // channels per thread: 16 bytes of bf16

// the 8 channels at p, as fp32
static __device__ __forceinline__ void load8(const float* p, float* v) {
  load4(p, v);
  load4(p + 4, v + 4);
}
static __device__ __forceinline__ void load8(const bf16* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x, v[2 * i + 1] = f.y;
  }
}

static __device__ __forceinline__ void store8(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}
static __device__ __forceinline__ void store8(bf16* p, const float* v) {
  uint4 raw;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// pilot[g] = mean of x[b, 0, group g's channels], fp32, into shared memory
template <typename T>
__device__ void group_pilot(const T* row0, int C, int G, float* pilot) {
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float s = 0.f;
    for (int j = 0; j < cg; ++j) s += to_f(row0[g * cg + j]);
    pilot[g] = s / cg;
  }
  __syncthreads();
}

// Row groups of the stats pass: the block's threads cover the C / 8
// vectors of a row rg times over (rg = 1 with some threads owning several
// vectors when C / 8 > kThreads).
__host__ __device__ inline int gn_row_groups(int C) {
  const int cv = C / kGnVec;
  return cv < kThreads ? kThreads / cv : 1;
}

// Per-block shared memory of the stats pass: the pilot, and the per-thread
// (s1, s2) of every channel (rg row groups x C x 2 floats).
__host__ __device__ inline size_t gn_stats_smem(int C, int G) {
  return (size_t)(G + 2 * gn_row_groups(C) * C) * sizeof(float);
}

// Per-block shared memory of the apply pass: the pilot and the inverse
// deviation per group, the folded affine (a, b) per channel, and the
// partial sums of the workspace reduction.
__host__ __device__ inline size_t gn_apply_smem(int C, int G) {
  const size_t parts = G < kThreads ? kThreads / G : 1;
  return (2 * G + 2 * C + 2 * parts * G) * sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, int N, int C, int G, int rows,
                float* __restrict__ ws) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const int cv = C / kGnVec, rg = gn_row_groups(C), cg = C / G;
  float* pilot = sm;
  float* part = sm + G;  // [2][rg][C]
  const T* xb = x + (size_t)b * N * C;
  group_pilot(xb, C, G, pilot);

  const int tid = threadIdx.x, r = tid / cv;
  const int n0 = chunk * rows, n1 = min(N, n0 + rows);
  if (r < rg) {
    for (int vi = tid % cv; vi < cv; vi += kThreads) {
      const int c0 = vi * kGnVec;
      float sh[kGnVec], s1[kGnVec], s2[kGnVec], v[kGnVec];
#pragma unroll
      for (int i = 0; i < kGnVec; ++i) {
        sh[i] = pilot[(c0 + i) / cg];
        s1[i] = 0.f, s2[i] = 0.f;
      }
      for (int n = n0 + r; n < n1; n += rg) {
        load8(xb + (size_t)n * C + c0, v);
#pragma unroll
        for (int i = 0; i < kGnVec; ++i) {
          const float d = v[i] - sh[i];
          s1[i] += d;
          s2[i] = fmaf(d, d, s2[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kGnVec; ++i) {
        part[(size_t)r * C + c0 + i] = s1[i];
        part[(size_t)(rg + r) * C + c0 + i] = s2[i];
      }
    }
  }
  __syncthreads();
  // per channel over the row groups, then per group over its channels,
  // each in a fixed order
  for (int c = tid; c < C; c += kThreads) {
    float a1 = 0.f, a2 = 0.f;
    for (int j = 0; j < rg; ++j) {
      a1 += part[(size_t)j * C + c];
      a2 += part[(size_t)(rg + j) * C + c];
    }
    part[c] = a1;
    part[(size_t)rg * C + c] = a2;
  }
  __syncthreads();
  for (int g = tid; g < G; g += kThreads) {
    float a1 = 0.f, a2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      a1 += part[g * cg + j];
      a2 += part[(size_t)rg * C + g * cg + j];
    }
    float* w = ws + (((size_t)b * chunks + chunk) * G + g) * 2;
    w[0] = a1, w[1] = a2;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                const T* __restrict__ bias, int N, int C, int G, int rows,
                float eps, int silu, const float* __restrict__ ws,
                T* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  const int b = blockIdx.y, chunk = blockIdx.x, chunks = gridDim.x;
  const int cv = C / kGnVec, cg = C / G;
  const int parts = G < kThreads ? kThreads / G : 1;  // as gn_apply_smem
  float* pilot = sm;          // [G], then the group's mean
  float* inv = sm + G;        // [G]
  float* fa = sm + 2 * G;     // [C] a
  float* fb = fa + C;         // [C] b
  float* red = fb + C;        // [2][parts][G]
  const T* xb = x + (size_t)b * N * C;
  group_pilot(xb, C, G, pilot);

  // the chunks' partial sums: `parts` threads per group each take every
  // parts-th chunk, then one thread per group adds the parts in order
  for (int t = threadIdx.x; t < parts * G; t += kThreads) {
    const int g = t % G, p = t / G;
    float s1 = 0.f, s2 = 0.f;
    for (int k = p; k < chunks; k += parts) {
      const float* w = ws + (((size_t)b * chunks + k) * G + g) * 2;
      s1 += w[0];
      s2 += w[1];
    }
    red[p * G + g] = s1;
    red[(parts + p) * G + g] = s2;
  }
  __syncthreads();
  const float cnt = (float)N * cg;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int p = 0; p < parts; ++p) {
      s1 += red[p * G + g];
      s2 += red[(parts + p) * G + g];
    }
    const float mean_c = s1 / cnt;
    const float var = fmaxf(s2 / cnt - mean_c * mean_c, 0.f);
    inv[g] = rsqrtf(var + eps);
    pilot[g] = mean_c + pilot[g];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float a = inv[c / cg] * to_f(scale[c]);
    fa[c] = a;
    fb[c] = to_f(bias[c]) - pilot[c / cg] * a;
  }
  __syncthreads();

  const int n0 = chunk * rows, n1 = min(N, n0 + rows);
  const size_t total = (size_t)(n1 - n0) * cv;
  for (size_t i = threadIdx.x; i < total; i += kThreads) {
    const int n = n0 + (int)(i / cv), c0 = (int)(i % cv) * kGnVec;
    const size_t at = ((size_t)b * N + n) * C + c0;
    float v[kGnVec];
    load8(x + at, v);
#pragma unroll
    for (int k = 0; k < kGnVec; ++k) {
      float y = fmaf(v[k], fa[c0 + k], fb[c0 + k]);
      if (silu) y = y / (1.f + expf(-y));
      v[k] = y;
    }
    store8(out + at, v);
  }
}

template <typename T>
cudaError_t gn_launch(const void* x, const void* scale, const void* bias,
                      void* ws, void* out, int B, int N, int C, int G,
                      int rows, float eps, int silu, cudaStream_t stream) {
  const dim3 grid((N + rows - 1) / rows, B);
  const size_t stats = gn_stats_smem(C, G);
  const size_t apply = gn_apply_smem(C, G);
  cudaError_t err = cudaFuncSetAttribute(
      gn_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)stats);
  if (err != cudaSuccess) return err;
  gn_stats_kernel<T><<<grid, kThreads, stats, stream>>>(
      (const T*)x, N, C, G, rows, (float*)ws);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gn_apply_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)apply);
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T><<<grid, kThreads, apply, stream>>>(
      (const T*)x, (const T*)scale, (const T*)bias, N, C, G, rows, eps, silu,
      (const float*)ws, (T*)out);
  return cudaGetLastError();
}

}  // namespace fyc

// x, out: (B, N, C) contiguous, 16-byte aligned; C a multiple of 8 whose
// statistics fit one block's shared memory, G dividing C. rows: rows of N per block (the grid is
// ceil(N / rows) x B); ws: B * ceil(N / rows) * G * 2 floats.
// dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int fyc_group_norm(const void* x, const void* scale,
                              const void* bias, void* ws, void* out, int B,
                              int N, int C, int G, int rows, float eps,
                              int silu, int dtype, void* stream) {
  if (C % fyc::kGnVec || C % G || rows < 1 ||
      fyc::gn_stats_smem(C, G) > fyc::kMaxSmem ||
      fyc::gn_apply_smem(C, G) > fyc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)fyc::gn_launch<__nv_bfloat16>(x, scale, bias, ws, out, B, N,
                                              C, G, rows, eps, silu, s);
  return (int)fyc::gn_launch<float>(x, scale, bias, ws, out, B, N, C, G, rows,
                                    eps, silu, s);
}
