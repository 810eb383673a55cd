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
// What the design does: the Pallas kernel holds a whole (N, C) slab of a
// batch row in VMEM and reads it once. A block's shared memory holds at
// most 227 KB, so two paths, chosen by the wrapper from (B, N, C, dtype)
// alone (ops/groupnorm.group_norm_path):
//  - cluster (slabs of up to 16 blocks' shared memory: every per-frame
//    site of the UNet and the resnet sites at (2, 1024, 1280) in bf16):
//    one launch; a thread-block cluster of CS blocks owns a batch row, each
//    block holding `rows` rows of it in shared memory, loaded once by
//    16-byte cp.async. Each block sums its rows' shifted s1, s2 per group
//    in a fixed order, the cluster exchanges those partials through
//    distributed shared memory, and every block adds the CS partials in
//    rank order (so all hold the same totals) and applies the affine to its
//    rows from shared memory: one read and one write of x, no workspace.
//  - two passes (larger slabs: the resnet sites of 4.6 MB and more, and
//    fp32 rows past the on-chip limit), each over a grid of (chunk of N,
//    batch row) blocks sized to fill the card:
//     1. stats: each block sums its chunk's shifted s1, s2 per group, four
//        16-byte loads in flight per thread; clusters of kGnStatsCluster
//        blocks add their partials through distributed shared memory in
//        rank order, and rank 0 writes one (s1, s2) pair per group and
//        cluster into an fp32 workspace;
//     2. apply: each block reduces its batch row's workspace in order
//        and writes y for its chunk. Chunks and rows run in reverse order
//        of the stats pass, so those it read last, still in the 50 MB L2,
//        are applied first.
// A thread owns 8 channels (one 16-byte vector) of every rg-th row in both
// paths and keeps several rows' loads in flight; its affine comes from a
// per-channel table in shared memory, and no address needs a divide. SiLU
// takes __expf and a fast division. No float atomics: repeated runs agree
// bit for bit.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace fyc {

namespace cg = cooperative_groups;

constexpr int kGnVec = 8;            // channels per thread: 16 bytes of bf16
constexpr int kGnMaxThreads = 384;  // two blocks an SM at 85 registers
constexpr int kGnStatsCluster = 8;   // stats blocks that pool their partials
constexpr int kGnMaxCluster = 16;

// 8 channels as raw 16-byte words (one for bf16, two for fp32), so a
// thread can keep several rows' loads in flight before converting any
template <typename T> struct Raw8 {
  uint4 w[sizeof(T) / 2];
};
template <typename T>
static __device__ __forceinline__ Raw8<T> ld8(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i)
    r.w[i] = reinterpret_cast<const uint4*>(p)[i];
  return r;
}

// the 8 channels as fp32
static __device__ __forceinline__ void cvt8(const Raw8<float>& r, float* v) {
  const float* f = reinterpret_cast<const float*>(r.w);
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = f[i];
}
static __device__ __forceinline__ void cvt8(const Raw8<bf16>& r, float* v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(r.w);
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

// rows of 8 channels a thread keeps in flight: 128 bytes of loads
template <typename T> constexpr int kGnInFlight = 16 / sizeof(T);

// Thread layout: rg row groups, each of tv threads over the C / 8 vectors
// of a row (a thread takes vectors vi, vi + tv, ... of rows r, r + rg, ...).
__host__ __device__ inline int gn_row_groups(int C) {
  const int cv = C / kGnVec, rg = (256 + cv / 2) / cv;  // ~256 threads
  return rg > 1 ? rg : 1;
}
__host__ __device__ inline int gn_threads(int C) {
  const int cv = C / kGnVec;
  return gn_row_groups(C) * (cv < kGnMaxThreads ? cv : kGnMaxThreads);
}

// fp32 words of a block's scratch besides its rows: the per-thread partials
// of every channel (2 x rg x C); 3 words per group (G <= C): the pilot and
// the block's (s1, s2) partial (read by the cluster); and the folded affine
// (a, b) of every channel
__host__ __device__ inline size_t gn_scratch_words(int C) {
  return (size_t)(2 * gn_row_groups(C) + 5) * C;
}

// shared memory of a cluster block holding `rows` rows of C
__host__ __device__ inline size_t gn_cluster_smem(int rows, int C,
                                                  size_t tsize) {
  return (size_t)rows * C * tsize + gn_scratch_words(C) * sizeof(float);
}

// pilot[g] = mean of row0[group g's channels], fp32, into shared memory:
// row 0 read once by all threads into tmp (C floats), then summed per group
template <typename T>
__device__ void group_pilot(const T* row0, int C, int G, float* tmp,
                            float* pilot) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) tmp[c] = to_f(row0[c]);
  __syncthreads();
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < cg; ++j) s += tmp[g * cg + j];
    pilot[g] = s / cg;
  }
  __syncthreads();
}

// The block's shifted sums over rows [0, n) of x (row stride C, device or
// shared memory): per channel over each thread's rows (kGnInFlight loads in
// flight a thread), over the row groups, then over each group's channels, each in
// a fixed order, into gs[2 g] (s1) and gs[2 g + 1] (s2). part: 2 rg C
// floats. Ends with a barrier.
template <typename T>
__device__ void group_sums(const T* x, int n, int C, int G,
                           const float* pilot, float* part, float* gs) {
  const int cv = C / kGnVec, rg = gn_row_groups(C), cg = C / G;
  const int tv = blockDim.x / rg, r = threadIdx.x / tv;
  for (int vi = threadIdx.x % tv; vi < cv; vi += tv) {
    const int c0 = vi * kGnVec;
    float sh[kGnVec], s1[kGnVec], s2[kGnVec];
#pragma unroll
    for (int i = 0; i < kGnVec; ++i) {
      sh[i] = pilot[(c0 + i) / cg];
      s1[i] = 0.f, s2[i] = 0.f;
    }
    constexpr int U = kGnInFlight<T>;
    auto add = [&](const Raw8<T>& raw) {
      float v[kGnVec];
      cvt8(raw, v);
#pragma unroll
      for (int i = 0; i < kGnVec; ++i) {
        const float d = v[i] - sh[i];
        s1[i] += d;
        s2[i] = fmaf(d, d, s2[i]);
      }
    };
    int m = r;
    for (; m + (U - 1) * rg < n; m += U * rg) {
      Raw8<T> raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        raw[u] = ld8(x + (size_t)(m + u * rg) * C + c0);
#pragma unroll
      for (int u = 0; u < U; ++u) add(raw[u]);
    }
    for (; m < n; m += rg) add(ld8(x + (size_t)m * C + c0));
#pragma unroll
    for (int i = 0; i < kGnVec; ++i) {
      part[(size_t)r * C + c0 + i] = s1[i];
      part[(size_t)(rg + r) * C + c0 + i] = s2[i];
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a1 = 0.f, a2 = 0.f;
    for (int j = 0; j < rg; ++j) {
      a1 += part[(size_t)j * C + c];
      a2 += part[(size_t)(rg + j) * C + c];
    }
    part[c] = a1;
    part[(size_t)rg * C + c] = a2;
  }
  __syncthreads();
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float a1 = 0.f, a2 = 0.f;
    for (int j = 0; j < cg; ++j) {
      a1 += part[g * cg + j];
      a2 += part[(size_t)rg * C + g * cg + j];
    }
    gs[2 * g] = a1, gs[2 * g + 1] = a2;
  }
  __syncthreads();
}

// (s1, s2) totals of a group -> mean into mean[g] (pilot added), inverse
// deviation into inv[g]
static __device__ __forceinline__ void group_moments(float s1, float s2,
                                                     float cnt, float eps,
                                                     float pilot, float* mean,
                                                     float* inv) {
  const float mean_c = s1 / cnt;
  const float var = fmaxf(s2 / cnt - mean_c * mean_c, 0.f);
  *inv = rsqrtf(var + eps);
  *mean = mean_c + pilot;
}

// The folded affine of every channel into fab (a at [c], b at [C + c]):
// a = inv * scale, b = bias - mean * a, from the groups' mean and inverse
// deviation. Ends with a barrier.
template <typename T>
__device__ void fold_affine(int C, int G, const T* __restrict__ scale,
                            const T* __restrict__ bias, const float* mean,
                            const float* inv, float* fab) {
  const int cg = C / G;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float a = inv[c / cg] * to_f(scale[c]);
    fab[c] = a;
    fab[C + c] = to_f(bias[c]) - mean[c / cg] * a;
  }
  __syncthreads();
}

// y = x * a + b (+ SiLU, by __expf and a fast division) of rows [0, n) of
// src (device or shared memory) into rows [0, n) of dst, both row stride
// C, the affine from fab; a thread takes its vectors of every rg-th row,
// kGnInFlight rows in flight, the last row first where `reverse`.
template <typename T>
__device__ void apply_rows(const T* src, T* dst, int n, int C,
                           const float* fab, int silu, bool reverse) {
  const int cv = C / kGnVec, rg = gn_row_groups(C);
  const int tv = blockDim.x / rg, r = threadIdx.x / tv;
  if (r >= n) return;
  const int last = r + (n - 1 - r) / rg * rg;  // the thread's last row
  const int first = reverse ? last : r, step = reverse ? -rg : rg;
  const int count = (last - r) / rg + 1;      // the thread's rows
  constexpr int U = kGnInFlight<T>;
  for (int vi = threadIdx.x % tv; vi < cv; vi += tv) {
    const int c0 = vi * kGnVec;
    float fa[kGnVec], fb[kGnVec];
#pragma unroll
    for (int i = 0; i < kGnVec; ++i) {
      fa[i] = fab[c0 + i];
      fb[i] = fab[C + c0 + i];
    }
    auto apply = [&](const Raw8<T>& raw, T* to) {
      float v[kGnVec];
      cvt8(raw, v);
#pragma unroll
      for (int i = 0; i < kGnVec; ++i) {
        float y = fmaf(v[i], fa[i], fb[i]);
        if (silu) y = __fdividef(y, 1.f + __expf(-y));
        v[i] = y;
      }
      store8(to, v);
    };
    int j = 0, m = first;
    for (; j + U <= count; j += U, m += U * step) {
      Raw8<T> raw[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        raw[u] = ld8(src + (size_t)(m + u * step) * C + c0);
#pragma unroll
      for (int u = 0; u < U; ++u)
        apply(raw[u], dst + (size_t)(m + u * step) * C + c0);
    }
    for (; j < count; ++j, m += step)
      apply(ld8(src + (size_t)m * C + c0), dst + (size_t)m * C + c0);
  }
}

// ---- one launch: a cluster owns a batch row ----------------------------------

// Block rank of cluster blockIdx.y (batch row) holds rows [rank * rows,
// min(N, (rank + 1) * rows)).
template <typename T>
__global__ void __launch_bounds__(kGnMaxThreads, 2)
gn_cluster_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                  const T* __restrict__ bias, int N, int C, int G, int rows,
                  float eps, int silu, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), cs = (int)cluster.num_blocks();
  const int b = blockIdx.y;
  const int n0 = rank * rows, n = max(0, min(N, n0 + rows) - n0);
  T* xs = reinterpret_cast<T*>(smem);
  float* part = reinterpret_cast<float*>(smem + (size_t)rows * C * sizeof(T));
  float* pilot = part + (size_t)2 * gn_row_groups(C) * C;  // [G]
  float* gs = pilot + C;                                   // [G][2]
  float* fab = gs + 2 * C;                                 // [2][C]
  const T* xb = x + (size_t)b * N * C;

  // the block's rows -> shared memory, all copies in flight together
  const char* src = reinterpret_cast<const char*>(xb + (size_t)n0 * C);
  const size_t chunks = (size_t)n * C * sizeof(T) / 16;
  for (size_t i = threadIdx.x; i < chunks; i += blockDim.x)
    hopper::cp_async16(smem + 16 * i, src + 16 * i, true);
  group_pilot(xb, C, G, part, pilot);  // row 0, while the copies land
  hopper::cp_async_wait_all();
  __syncthreads();

  group_sums(xs, n, C, G, pilot, part, gs);
  cluster.sync();  // every block's partials are written
  // the cluster's totals, added in rank order by every block; the moments
  // go where the per-channel partials were
  float* mean = part;
  float* inv = part + G;
  const float cnt = (float)N * (C / G);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < cs; ++k) {
      const float* peer = cluster.map_shared_rank(gs, k);
      s1 += peer[2 * g];
      s2 += peer[2 * g + 1];
    }
    group_moments(s1, s2, cnt, eps, pilot[g], mean + g, inv + g);
  }
  __syncthreads();
  fold_affine(C, G, scale, bias, mean, inv, fab);
  apply_rows(xs, out + ((size_t)b * N + n0) * C, n, C, fab, silu, false);
  cluster.sync();  // no block leaves while another may read its partials
}

// ---- two passes over chunks of N ----------------------------------------------

// Block (chunk blockIdx.x, batch row blockIdx.y), in clusters of
// kGnStatsCluster along the chunks: ws[(b * chunks / kGnStatsCluster + c)
// * G + g] holds cluster c's (s1, s2) of group g.
template <typename T>
__global__ void __launch_bounds__(kGnMaxThreads, 2)
gn_stats_kernel(const T* __restrict__ x, int N, int C, int G, int rows,
                float* __restrict__ ws) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int b = blockIdx.y, chunk = blockIdx.x;
  float* part = sm;
  float* pilot = part + (size_t)2 * gn_row_groups(C) * C;
  float* gs = pilot + C;
  const T* xb = x + (size_t)b * N * C;
  group_pilot(xb, C, G, part, pilot);
  const int n0 = min(N, chunk * rows), n1 = min(N, n0 + rows);
  group_sums(xb + (size_t)n0 * C, n1 - n0, C, G, pilot, part, gs);
  cluster.sync();
  if (cluster.block_rank() == 0) {
    float* w = ws + ((size_t)b * gridDim.x + chunk) / kGnStatsCluster * G * 2;
    for (int g = threadIdx.x; g < G; g += blockDim.x) {
      float s1 = 0.f, s2 = 0.f;
      for (int k = 0; k < kGnStatsCluster; ++k) {
        const float* peer = cluster.map_shared_rank(gs, k);
        s1 += peer[2 * g];
        s2 += peer[2 * g + 1];
      }
      w[2 * g] = s1, w[2 * g + 1] = s2;
    }
  }
  cluster.sync();  // rank 0 has read every block's partials
}

// Block (chunks - 1 - blockIdx.x, batch row B - 1 - blockIdx.y): the reverse
// of the stats pass's order.
template <typename T>
__global__ void __launch_bounds__(kGnMaxThreads, 2)
gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                const T* __restrict__ bias, int N, int C, int G, int rows,
                float eps, int silu, const float* __restrict__ ws,
                T* __restrict__ out) {
  extern __shared__ __align__(16) float sm[];
  const int b = gridDim.y - 1 - blockIdx.y;
  const int chunk = gridDim.x - 1 - blockIdx.x;
  const int parts_n = gridDim.x / kGnStatsCluster;
  // threads per group summing every par-th workspace entry, then one
  // thread per group adding those in order
  const int par = blockDim.x >= 2 * G ? blockDim.x / G : 1;
  float* pilot = sm;        // [G]
  float* mean = sm + G;     // [G]
  float* inv = sm + 2 * G;  // [G]
  float* fab = sm + 3 * G;  // [2][C]
  float* red = fab + 2 * C;  // [2][par][G], row 0 before that
  const T* xb = x + (size_t)b * N * C;
  group_pilot(xb, C, G, red, pilot);
  const float* wb = ws + (size_t)b * parts_n * G * 2;
  for (int t = threadIdx.x; t < par * G; t += blockDim.x) {
    const int g = t % G, p = t / G;
    float s1 = 0.f, s2 = 0.f;
    for (int k = p; k < parts_n; k += par) {
      s1 += wb[((size_t)k * G + g) * 2];
      s2 += wb[((size_t)k * G + g) * 2 + 1];
    }
    red[p * G + g] = s1;
    red[(par + p) * G + g] = s2;
  }
  __syncthreads();
  const float cnt = (float)N * (C / G);
  for (int g = threadIdx.x; g < G; g += blockDim.x) {
    float s1 = 0.f, s2 = 0.f;
    for (int p = 0; p < par; ++p) {
      s1 += red[p * G + g];
      s2 += red[(par + p) * G + g];
    }
    group_moments(s1, s2, cnt, eps, pilot[g], mean + g, inv + g);
  }
  __syncthreads();
  fold_affine(C, G, scale, bias, mean, inv, fab);
  const int n0 = min(N, chunk * rows), n1 = min(N, n0 + rows);
  const size_t at = ((size_t)b * N + n0) * C;
  apply_rows(x + at, out + at, n1 - n0, C, fab, silu, true);
}

// words of the apply pass's shared memory: pilot, mean and inverse
// deviation per group, the folded affine (2 C), then row 0 (C) or the
// partial sums (2 par G)
__host__ __device__ inline size_t gn_apply_words(int C, int G) {
  const int threads = gn_threads(C);
  const int par = threads >= 2 * G ? threads / G : 1;
  const size_t red = 2 * (size_t)par * G;
  return 3 * (size_t)G + 2 * (size_t)C + (red > (size_t)C ? red : (size_t)C);
}

// chunks of the two-pass grid for `rows` rows a chunk: whole stats clusters
__host__ __device__ inline int gn_chunks(int N, int rows) {
  const int c = (N + rows - 1) / rows;
  return (c + kGnStatsCluster - 1) / kGnStatsCluster * kGnStatsCluster;
}

template <typename Kern, typename... Args>
cudaError_t launch_clustered(Kern kern, dim3 grid, int threads, size_t smem,
                             int cluster, cudaStream_t stream,
                             Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess && cluster > 8)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

template <typename T>
cudaError_t gn_two_pass(const void* x, const void* scale, const void* bias,
                        void* ws, void* out, int B, int N, int C, int G,
                        int rows, float eps, int silu, cudaStream_t stream) {
  const dim3 grid(gn_chunks(N, rows), B);
  const int threads = gn_threads(C);
  cudaError_t err = launch_clustered(
      gn_stats_kernel<T>, grid, threads, gn_scratch_words(C) * sizeof(float),
      kGnStatsCluster, stream, (const T*)x, N, C, G, rows, (float*)ws);
  if (err != cudaSuccess) return err;
  const size_t apply = gn_apply_words(C, G) * sizeof(float);
  err = cudaFuncSetAttribute(gn_apply_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)apply);
  if (err != cudaSuccess) return err;
  gn_apply_kernel<T><<<grid, threads, apply, stream>>>(
      (const T*)x, (const T*)scale, (const T*)bias, N, C, G, rows, eps, silu,
      (const float*)ws, (T*)out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t gn_cluster(const void* x, const void* scale, const void* bias,
                       void* out, int B, int N, int C, int G, int cs,
                       int rows, float eps, int silu, cudaStream_t stream) {
  return launch_clustered(gn_cluster_kernel<T>, dim3(cs, B), gn_threads(C),
                          gn_cluster_smem(rows, C, sizeof(T)), cs, stream,
                          (const T*)x, (const T*)scale, (const T*)bias, N, C,
                          G, rows, eps, silu, (T*)out);
}

// the shapes both paths take: C a multiple of 8 with G dividing it, the
// scratch in one block's shared memory
inline bool gn_shape_ok(int B, int N, int C, int G) {
  return B > 0 && B <= 65535 && N > 0 && C > 0 && G > 0 && C % kGnVec == 0 &&
         C % G == 0 && gn_scratch_words(C) * sizeof(float) <= kMaxSmem &&
         gn_apply_words(C, G) * sizeof(float) <= kMaxSmem;
}

}  // namespace fyc

// Two passes. x, out: (B, N, C) contiguous, 16-byte aligned; C a multiple
// of 8 whose scratch fits one block's shared memory, G dividing C. rows:
// rows of N per chunk; the grid is gn_chunks(N, rows) (ceil(N / rows)
// rounded up to a multiple of 8) x B. ws: B * gn_chunks(N, rows) / 8 * G * 2
// floats. dtype: 0 = float32, 1 = bfloat16. Returns the cudaError_t of the
// launches (0 on success).
extern "C" int fyc_group_norm(const void* x, const void* scale,
                              const void* bias, void* ws, void* out, int B,
                              int N, int C, int G, int rows, float eps,
                              int silu, int dtype, void* stream) {
  if (!fyc::gn_shape_ok(B, N, C, G) || rows < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)fyc::gn_two_pass<__nv_bfloat16>(x, scale, bias, ws, out, B, N,
                                                C, G, rows, eps, silu, s);
  return (int)fyc::gn_two_pass<float>(x, scale, bias, ws, out, B, N, C, G,
                                      rows, eps, silu, s);
}

// One launch: a cluster of cs blocks (1 to 16) per batch row, each holding
// `rows` rows (cs * rows >= N) in shared memory. Same x, out, C, G, dtype
// as fyc_group_norm. Returns the cudaError_t of the launch (0 on success):
// a cluster the card cannot place is an error, never another path.
extern "C" int fyc_group_norm_cluster(const void* x, const void* scale,
                                      const void* bias, void* out, int B,
                                      int N, int C, int G, int cs, int rows,
                                      float eps, int silu, int dtype,
                                      void* stream) {
  const size_t t = dtype == 1 ? 2 : 4;
  if (!fyc::gn_shape_ok(B, N, C, G) || cs < 1 || cs > fyc::kGnMaxCluster ||
      rows < 1 || (long long)cs * rows < N ||
      fyc::gn_cluster_smem(rows, C, t) > fyc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)fyc::gn_cluster<__nv_bfloat16>(x, scale, bias, out, B, N, C,
                                               G, cs, rows, eps, silu, s);
  return (int)fyc::gn_cluster<float>(x, scale, bias, out, B, N, C, G, cs,
                                     rows, eps, silu, s);
}

// Clusters of the one-launch path the card can hold at once for (C, cs,
// rows, dtype) (cudaOccupancyMaxActiveClusters); 0 or less: none, or an
// error (its negated cudaError_t).
extern "C" int fyc_group_norm_max_clusters(int C, int cs, int rows,
                                           int dtype) {
  const size_t t = dtype == 1 ? 2 : 4;
  const size_t smem = fyc::gn_cluster_smem(rows, C, t);
  auto query = [&](auto kern) -> int {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess && cs > 8)
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return -(int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cs, 1);
    cfg.blockDim = dim3(fyc::gn_threads(C));
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cs;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = 0;
    err = cudaOccupancyMaxActiveClusters(&n, (void*)kern, &cfg);
    return err == cudaSuccess ? n : -(int)err;
  };
  return dtype == 1 ? query(fyc::gn_cluster_kernel<__nv_bfloat16>)
                    : query(fyc::gn_cluster_kernel<float>);
}
