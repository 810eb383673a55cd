// Online-softmax tiled attention (flash attention, forward).
//
// Replaces the Pallas TPU kernel of followyourclick_tpu/ops/
// flash_attention.py (flash_attention, body _fwd_kernel): softmax attention
// of (B, Sq, H, D) q over (B, Sk, H, D) k and v without keeping the Sq x Sk
// scores. Numerics as there: logits q . k^T in fp32 times scale, key rows
// past Sk masked with -1e30, running row max and sum in fp32, p cast to v's
// type before p . v, which accumulates in fp32, the sum divided out at the
// end and the result cast.
//
// What bounds it on the H100. At the path shape (B * H = 512, Sq = Sk =
// 4096, D = 40, bf16) it does 4 * B * H * Sq * Sk * D = 1.37 TFLOP on the
// tensor cores against 671 MB of q, k, v and o: ~2000 operations per byte,
// far above the card's ~295, so it is bound by operations (1.39 ms at
// 989 TFLOP/s). It also takes B * H * Sq * Sk = 8.6e9 exponentials, which
// at D = 40 cost the special-function units (16 per SM per clock) more than
// the products cost the tensor cores.
//
// What the design does. q, k and v are read by stride from the (B, S, H, D)
// layout, so the Pallas wrapper's transpose to (B * H, S, D) is not needed,
// and D is padded with zeros only in shared memory, to whole 16-element
// product depths (40 -> 48; zero columns change neither q . k^T nor the
// kept part of p . v), where the TPU wrapper padded it to 128 lanes in
// device memory. A block takes one (batch * head, query tile) and walks the
// keys in 64-row k/v tiles staged in shared memory; each warp owns 16 query
// rows end to end. Consecutive blocks take consecutive query tiles of one
// head, so a head's k and v stay in L2.
//
// bf16: 8 warps, 128 query rows per block (each k/v tile read from L2 once
// per 128 rows); k/v tiles double-buffered by cp.async, so the next tile's
// copy runs under this tile's products. mma.sync m16n8k16 on the tensor
// cores with fp32 accumulation, every fragment in registers: q's A
// fragments for the whole walk, the S accumulator, whose layout is that of
// P's A operand, so p is rounded to bf16 and fed to P . V without leaving
// registers, and the O accumulator, rescaled in place; v's B fragments come
// transposed from shared memory by ldmatrix (staging S, P and O in shared
// memory instead makes the kernel bound by shared-memory traffic). p is
// exp2 of (s * scale * log2(e) - max), one FMA and one ex2.approx per score.
//
// fp32: 4 warps, 64 query rows, FMA on shared-memory tiles of S, p and O.
#include "common.cuh"

namespace fyc {

constexpr int kFaBK = 64;  // key rows per staged tile
constexpr float kFaMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// warps per block (16 query rows each) by storage type
template <typename T> __host__ __device__ constexpr int fa_warps() {
  return std::is_same<T, bf16>::value ? 8 : 4;
}

// head dim padded to whole 16-element product depths (40 -> 48)
__host__ __device__ constexpr int fa_dp(int d) { return (d + 15) / 16 * 16; }

// Shared memory of one block, rows padded by 16 bytes (common.cuh
// `padded`). bf16: the q tile and two k and two v tiles (row stride ldq).
// fp32: the q, k and v tiles, the scores (lds), p (ldp) and O (ldo).
struct FlashLayout {
  size_t q, k[2], v[2], s, p, o, bytes;
  int ldq, lds, ldp, ldo;
  __host__ __device__ FlashLayout(int d, size_t tsize) {
    const bool half = tsize == 2;
    const int dp = fa_dp(d), bq = 16 * (half ? 8 : 4);
    ldq = padded(dp, (int)tsize);
    lds = padded(kFaBK, 4);
    ldp = padded(kFaBK, (int)tsize);
    ldo = padded(dp, 4);
    SmemCursor cur;
    q = cur.take<char>((size_t)bq * ldq * tsize);
    for (int i = 0; i < 2; ++i) {
      const bool own = half || i == 0;  // fp32 has one k/v buffer
      k[i] = own ? cur.take<char>((size_t)kFaBK * ldq * tsize) : k[0];
      v[i] = own ? cur.take<char>((size_t)kFaBK * ldq * tsize) : v[0];
    }
    s = p = o = 0;
    if (!half) {
      s = cur.take<float>((size_t)bq * lds);
      p = cur.take<char>((size_t)bq * ldp * tsize);
      o = cur.take<float>((size_t)bq * ldo);
    }
    bytes = cur.off;
  }
};

// The block's (batch * head, query tile) and the first rows of its head.
template <typename T>
struct FlashTile {
  int q0, b, h;
  size_t rs;  // elements between sequence rows, H * D
  const T* qg;
  const T* kg;
  const T* vg;
  __device__ FlashTile(const T* q, const T* k, const T* v, int Sq, int Sk,
                       int H, int D) {
    q0 = blockIdx.x * 16 * fa_warps<T>();
    b = blockIdx.y / H;
    h = blockIdx.y % H;
    rs = (size_t)H * D;
    qg = q + ((size_t)b * Sq + q0) * rs + (size_t)h * D;
    kg = k + (size_t)b * Sk * rs + (size_t)h * D;
    vg = v + (size_t)b * Sk * rs + (size_t)h * D;
  }
};

// `tile_rows` rows of one head of a (B, S, H, D) tensor (src: its first
// row, row stride rs elements) into a tile of shared memory (row stride ld,
// dp columns): zero beyond `rows` rows and D columns. 16-byte copies: D is
// a multiple of 8 (bf16) or 4 (fp32) elements, so a copy is all data or all
// padding. ASYNC: cp.async copies (zero-filled where there is no data),
// which the caller commits and waits for.
template <typename T, bool ASYNC = false>
__device__ __forceinline__ void fa_load_tile(const T* __restrict__ src,
                                             size_t rs, int tile_rows,
                                             int rows, int D, int dp, T* dst,
                                             int ld) {
  constexpr int kVec = 16 / sizeof(T);
  const int chunks = dp / kVec;
  for (int i = threadIdx.x; i < tile_rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * kVec;
    const bool data = r < rows && c < D;
    T* to = dst + (size_t)r * ld + c;
    if constexpr (ASYNC) {
      const unsigned sa = static_cast<unsigned>(__cvta_generic_to_shared(to));
      const T* from = data ? src + (size_t)r * rs + c : src;
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                   :: "r"(sa), "l"(from), "r"(data ? 16 : 0));
    } else {
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (data) val = *reinterpret_cast<const uint4*>(src + (size_t)r * rs + c);
      *reinterpret_cast<uint4*>(to) = val;
    }
  }
}

// ---- bf16: mma.sync m16n8k16, every fragment in registers ----------------
//
// Fragment layouts (PTX ISA, mma.m16n8k16 .bf16; g = lane / 4, t = lane % 4):
//  A (16 x 16): a[0] = (row g, cols 2t, 2t+1), a[1] = (row g+8, same),
//               a[2] = (row g, cols 2t+8, 2t+9), a[3] = (row g+8, same);
//  B (16 x 8):  b[0] = (rows 2t, 2t+1, col g), b[1] = (rows 2t+8, 2t+9);
//  C (16 x 8):  c[0], c[1] = (row g, cols 2t, 2t+1), c[2], c[3] = (row g+8).
// Each register holds the lower column (A) or row (B) in its low half.

static __device__ __forceinline__ unsigned lds32(const bf16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

static __device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

static __device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

static __device__ __forceinline__ void mma_bf16(float* c, const unsigned* a,
                                                unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices, transposed: lane l gives the address of row
// l % 8 of matrix l / 8 (16 contiguous bytes) and receives, of matrix i,
// the elements (rows 2t, 2t+1; col g) in r[i].
static __device__ __forceinline__ void ldsm_x4_trans(unsigned* r,
                                                     const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

template <int NK>
__global__ void __launch_bounds__(32 * fa_warps<bf16>())
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ out, int Sq,
                  int Sk, int H, int D, float scale_log2) {
  constexpr int DP = NK * 16, NT = DP / 8;  // padded width, 8-column tiles
  constexpr int ST = kFaBK / 8;             // score tiles per k/v tile
  constexpr int BQ = 16 * fa_warps<bf16>();
  extern __shared__ __align__(128) unsigned char smem[];
  const FlashLayout lay(D, sizeof(bf16));
  const int ldq = lay.ldq;
  const FlashTile<bf16> tile(q, k, v, Sq, Sk, H, D);
  const int tiles = (Sk + kFaBK - 1) / kFaBK;

  bf16* kbuf0 = reinterpret_cast<bf16*>(smem + lay.k[0]);
  bf16* kbuf1 = reinterpret_cast<bf16*>(smem + lay.k[1]);
  bf16* vbuf0 = reinterpret_cast<bf16*>(smem + lay.v[0]);
  bf16* vbuf1 = reinterpret_cast<bf16*>(smem + lay.v[1]);

  // cp.async copies of k/v tile `it` into buffer it % 2, one commit group
  auto issue = [=](int it) {
    const int k0 = it * kFaBK, kv = min(kFaBK, Sk - k0);
    fa_load_tile<bf16, true>(tile.kg + (size_t)k0 * tile.rs, tile.rs, kFaBK,
                             kv, D, DP, it % 2 ? kbuf1 : kbuf0, ldq);
    fa_load_tile<bf16, true>(tile.vg + (size_t)k0 * tile.rs, tile.rs, kFaBK,
                             kv, D, DP, it % 2 ? vbuf1 : vbuf0, ldq);
    asm volatile("cp.async.commit_group;\n" ::);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp * 16;  // the warp's 16 query rows

  bf16* qs = reinterpret_cast<bf16*>(smem + lay.q);
  fa_load_tile(tile.qg, tile.rs, BQ, min(BQ, Sq - tile.q0), D, DP, qs, ldq);
  issue(0);
  __syncthreads();
  unsigned qa[NK][4];  // the warp's q rows as A fragments, one per depth
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    const bf16* at = qs + (r0 + g) * ldq + kk * 16 + 2 * t;
    qa[kk][0] = lds32(at);
    qa[kk][1] = lds32(at + 8 * ldq);
    qa[kk][2] = lds32(at + 8);
    qa[kk][3] = lds32(at + 8 * ldq + 8);
  }

  float o[NT][4];  // O rows g and g + 8, columns 8n + 2t, 2t + 1
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  // rows g and g + 8: running max of the scaled logits (log2 units) and
  // this lane's part of the running sum (the row's four lanes share the max)
  float m[2] = {kFaMask, kFaMask}, l[2] = {0.f, 0.f};

  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) {
      issue(it + 1);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();  // tile `it` has landed for every thread
    const bf16* ks = it % 2 ? kbuf1 : kbuf0;
    const bf16* vs = it % 2 ? vbuf1 : vbuf0;
    const int kv = min(kFaBK, Sk - it * kFaBK);

    // S = Q . K^T: B fragment (d, key) = K[key][d], a row of the k tile
    float s[ST][4];
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* kr = ks + (8 * j + g) * ldq + 2 * t;
#pragma unroll
      for (int kk = 0; kk < NK; ++kk)
        mma_bf16(s[j], qa[kk], lds32(kr + kk * 16), lds32(kr + kk * 16 + 8));
    }
    if (kv < kFaBK) {  // the ragged last tile
#pragma unroll
      for (int j = 0; j < ST; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * j + 2 * t + (e & 1) >= kv) s[j][e] = kFaMask;
    }

    // online softmax of rows g (s[.][0..1]) and g + 8 (s[.][2..3]); the max
    // is taken on the raw logits (scale > 0)
    float mx[2] = {kFaMask, kFaMask};
#pragma unroll
    for (int j = 0; j < ST; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2], neg[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r] * scale_log2);
      alpha[r] = ex2(m[r] - m_new);
      m[r] = m_new;
      neg[r] = -m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < ST; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = ex2(fmaf(s[j][e], scale_log2, neg[e / 2]));
        l[e / 2] += s[j][e];
      }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0], o[n][1] *= alpha[0];
      o[n][2] *= alpha[1], o[n][3] *= alpha[1];
    }

    // O += P . V: P's A fragment of keys 16kk.. is score tiles 2kk, 2kk+1,
    // rounded to bf16; V's B fragments come transposed from the v tile
#pragma unroll
    for (int kk = 0; kk < kFaBK / 16; ++kk) {
      const unsigned pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      // matrix i = lane / 8: keys 16kk + 8 (i % 2) + lane % 8, columns
      // 16c + 8 (i / 2): b0, b1 of column tile 2c, then of 2c + 1
      const bf16* vr = vs + (16 * kk + 8 * ((lane / 8) % 2) + lane % 8) * ldq
                       + 8 * (lane / 16);
#pragma unroll
      for (int c = 0; c < NT / 2; ++c) {
        unsigned vb[4];
        ldsm_x4_trans(vb, vr + 16 * c);
        mma_bf16(o[2 * c], pa, vb[0], vb[1]);
        mma_bf16(o[2 * c + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with buffer it % 2
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = tile.q0 + r0 + g + 8 * r;
    if (row >= Sq) continue;
    bf16* og = out + ((size_t)tile.b * Sq + row) * tile.rs +
               (size_t)tile.h * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < D)
        *reinterpret_cast<__nv_bfloat162*>(og + c) = __floats2bfloat162_rn(
            o[n][2 * r] / l[r], o[n][2 * r + 1] / l[r]);
    }
  }
}

// ---- fp32: FMA on shared-memory tiles --------------------------------------
//
// Each warp owns 16 query rows: its scores (lane: keys lane and lane + 32),
// its softmax rows (two lanes per row, columns 2i + half), its rows of p
// and of the accumulator O, all in shared memory.
template <int NK>
__global__ void __launch_bounds__(32 * fa_warps<float>())
flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int Sq, int Sk, int H, int D, float scale_log2) {
  constexpr int DP = NK * 16;
  constexpr int BQ = 16 * fa_warps<float>();
  extern __shared__ __align__(128) unsigned char smem[];
  const FlashLayout lay(D, sizeof(float));
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* ks = reinterpret_cast<float*>(smem + lay.k[0]);
  float* vs = reinterpret_cast<float*>(smem + lay.v[0]);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  float* ps = reinterpret_cast<float*>(smem + lay.p);
  float* os = reinterpret_cast<float*>(smem + lay.o);
  const int ldq = lay.ldq, lds = lay.lds, ldp = lay.ldp, ldo = lay.ldo;
  const FlashTile<float> tile(q, k, v, Sq, Sk, H, D);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int row = r0 + lane / 2, half = lane % 2;

  fa_load_tile(tile.qg, tile.rs, BQ, min(BQ, Sq - tile.q0), D, DP, qs, ldq);
  for (int i = lane; i < 16 * DP; i += 32)
    os[(r0 + i / DP) * ldo + i % DP] = 0.f;

  float m = kFaMask, l = 0.f;  // the row's running max (log2 units), sum
  float* srow = ss + row * lds;
  float* prow = ps + row * ldp;
  float* orow = os + row * ldo;

  for (int k0 = 0; k0 < Sk; k0 += kFaBK) {
    const int kv = min(kFaBK, Sk - k0);
    __syncthreads();  // every warp is done with the previous k, v tiles
    fa_load_tile(tile.kg + (size_t)k0 * tile.rs, tile.rs, kFaBK, kv, D, DP,
                 ks, ldq);
    fa_load_tile(tile.vg + (size_t)k0 * tile.rs, tile.rs, kFaBK, kv, D, DP,
                 vs, ldq);
    __syncthreads();

    float acc[16][2];
#pragma unroll
    for (int r = 0; r < 16; ++r) acc[r][0] = acc[r][1] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float ka = ks[lane * ldq + d], kb = ks[(lane + 32) * ldq + d];
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const float qv = qs[(r0 + r) * ldq + d];
        acc[r][0] = fmaf(qv, ka, acc[r][0]);
        acc[r][1] = fmaf(qv, kb, acc[r][1]);
      }
    }
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      ss[(r0 + r) * lds + lane] = acc[r][0];
      ss[(r0 + r) * lds + lane + 32] = acc[r][1];
    }
    __syncwarp();

    float sv[kFaBK / 2];
    float mx = kFaMask;
#pragma unroll
    for (int i = 0; i < kFaBK / 2; ++i) {
      const int j = 2 * i + half;
      sv[i] = j < kv ? srow[j] * scale_log2 : kFaMask;
      mx = fmaxf(mx, sv[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = exp2f(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kFaBK / 2; ++i) {
      const float p = exp2f(sv[i] - m_new);
      sum += p;
      prow[2 * i + half] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * alpha + sum;
    m = m_new;
    for (int c = half; c < DP; c += 2) orow[c] *= alpha;
    __syncwarp();

    for (int c0 = 0; c0 < DP; c0 += 32) {
      const int c = c0 + lane;
      if (c >= D) break;
      float acc_o[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) acc_o[r] = 0.f;
      for (int j = 0; j < kv; ++j) {
        const float vv = vs[j * ldq + c];
#pragma unroll
        for (int r = 0; r < 16; ++r)
          acc_o[r] = fmaf(ps[(r0 + r) * ldp + j], vv, acc_o[r]);
      }
#pragma unroll
      for (int r = 0; r < 16; ++r) os[(r0 + r) * ldo + c] += acc_o[r];
    }
    __syncwarp();
  }

  if (tile.q0 + row < Sq) {
    float* og = out + ((size_t)tile.b * Sq + tile.q0 + row) * tile.rs +
                (size_t)tile.h * D;
    for (int c = half; c < D; c += 2) og[c] = orow[c] / l;
  }
}

template <typename T, int NK>
cudaError_t fa_launch(const void* q, const void* k, const void* v, void* out,
                      int B, int Sq, int Sk, int H, int D, float scale,
                      cudaStream_t stream) {
  const FlashLayout lay(D, sizeof(T));
  void (*kern)(const T*, const T*, const T*, T*, int, int, int, int, float);
  if constexpr (std::is_same<T, bf16>::value)
    kern = flash_bf16_kernel<NK>;
  else
    kern = flash_fp32_kernel<NK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return err;
  const int bq = 16 * fa_warps<T>();
  const dim3 grid((Sq + bq - 1) / bq, B * H);
  kern<<<grid, 32 * fa_warps<T>(), lay.bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Sq, Sk, H, D,
      scale * kLog2e);
  return cudaGetLastError();
}

template <typename T>
cudaError_t fa_dispatch(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Sk, int H, int D,
                        float scale, cudaStream_t s) {
  switch (fa_dp(D) / 16) {
    case 1: return fa_launch<T, 1>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 2: return fa_launch<T, 2>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 3: return fa_launch<T, 3>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 4: return fa_launch<T, 4>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 5: return fa_launch<T, 5>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 6: return fa_launch<T, 6>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 7: return fa_launch<T, 7>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 8: return fa_launch<T, 8>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 9: return fa_launch<T, 9>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 10: return fa_launch<T, 10>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace fyc

// q, out: (B, Sq, H, D); k, v: (B, Sk, H, D); contiguous, 16-byte aligned.
// D a multiple of 8 up to 160; B * H <= 65535. dtype: 0 = float32,
// 1 = bfloat16. Returns the cudaError_t of the launch (0 on success).
extern "C" int fyc_flash_attention(const void* q, const void* k,
                                   const void* v, void* out, int B, int Sq,
                                   int Sk, int H, int D, float scale,
                                   int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || H <= 0 || D <= 0 || D % 8 != 0 ||
      D > 160 || (long long)B * H > 65535 ||
      fyc::FlashLayout(D, dtype == 1 ? 2 : 4).bytes > fyc::kMaxSmem)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)fyc::fa_dispatch<__nv_bfloat16>(q, k, v, out, B, Sq, Sk, H,
                                                D, scale, s);
  return (int)fyc::fa_dispatch<float>(q, k, v, out, B, Sq, Sk, H, D, scale,
                                      s);
}
