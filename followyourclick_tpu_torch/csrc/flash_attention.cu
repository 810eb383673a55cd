// Online-softmax tiled attention (flash attention, forward).
//
// Replaces the Pallas TPU kernel of followyourclick_tpu/ops/
// flash_attention.py (flash_attention, body _fwd_kernel): softmax attention
// of (B, Sq, H, D) q over (B, Sk, H, D) k and v without keeping the Sq x Sk
// scores. Numerics as there: logits q . k^T in fp32 times scale (in log2
// units here), key rows past Sk masked with -1e30, running row max and sum
// in fp32, p cast to v's type before p . v, which accumulates in fp32, the
// sum divided out at the end and the result cast.
//
// What bounds it on the H100. At the path shape (B * H = 512, Sq = Sk =
// 4096, D = 40, bf16) it does 4 * B * H * Sq * Sk * D = 1.37 TFLOP on the
// tensor cores against 671 MB of q, k, v and o (1.39 ms at 989 TFLOP/s,
// bound by operations). It also takes B * H * Sq * Sk = 8.6e9 exponentials:
// at the special-function units' 16 per SM per clock, about 2.1 ms, above
// the tensor bound. So the exponentials bind first, then the issue of the
// products.
//
// bf16 (flash_wgmma_kernel), warp-specialised, a block per 192 or 128 query
// rows of one (batch, head):
//  - warpgroup 0 is the producer: one thread loads the q tile once and keeps
//    a ring of 2-3 stages of k and v tiles (128 keys; 64 at D > 128) in
//    flight by TMA, each completing on an mbarrier. The tensor maps are 4-D
//    over the (B, S, H, D) layout (dims D, H, S, B), so no transpose is
//    needed; a box 64 columns wide is written 128-byte-swizzled, and the
//    columns past D (and the rows past S) arrive as zeros without being read
//    (D = 40: 80-byte rows, 48 columns used). Heads wider than 64 come in
//    64-column slabs.
//  - the consumer warpgroups own 64 query rows each: three (192 rows a
//    block) for heads up to 64 wide, so that three warps share each SM
//    sub-partition's special-function unit and hide each other's softmax
//    latency; two (128 rows) for wider heads, whose O accumulator needs the
//    registers. S = Q . K^T runs on wgmma
//    from shared memory (m64n128k16, D / 16 k-steps); the softmax runs on
//    the fp32 accumulator fragments in registers; p is rounded to bf16 in
//    registers and fed as wgmma's register A operand to O += P . V, with V
//    the MN-major B operand (the descriptor's transpose bit).
//  - Each warpgroup issues S(j) and P(j-1) . V(j-1) together, then does the
//    softmax of S(j) while P . V runs, then rescales O (the FlashAttention-3
//    order); the warpgroups take turns at issuing, round robin through
//    named barriers, so one group's exponentials run under another's
//    products.
//  - The exponentials run on the special-function units (ex2.approx): the
//    third consumer warpgroup is what hides them. A share computed on the
//    FMA pipe by a range reduction and a polynomial was measured slower at
//    every share tried (PERF.md), and was removed.
//
// fp32 (flash_fp32_kernel): 4 warps, 64 query rows, FMA on shared-memory
// tiles of S, p and O.
#include "common.cuh"
#include "hopper.cuh"

namespace fyc {

constexpr float kFaMask = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---- bf16: wgmma, TMA, warp-specialised ------------------------------------

template <int R>
static __device__ __forceinline__ void fence_u32(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Padded head width DP (the O accumulator's N, a multiple of 16): 64-column
// slabs DS, consumer warpgroups NWG and query rows BQ per block, keys per
// tile BK, ring stages; bytes of the q tile and of one k (or v) tile;
// registers of a producer and of a consumer thread after setmaxnreg (the
// block's 64 K registers: 128 * PREGS + 128 * NWG * CREGS <= 65536).
template <int DP>
struct FaShape {
  static constexpr int DS = (DP + 63) / 64;
  static constexpr int NWG = DS == 1 ? 3 : 2;
  static constexpr int BQ = 64 * NWG;
  static constexpr int THREADS = 128 * (NWG + 1);
  static constexpr int BK = DS > 2 ? 64 : 128;
  static constexpr int STAGES = DS > 1 ? 2 : 3;
  static constexpr int kQ = DS * BQ * 128;
  static constexpr int kKV = DS * BK * 128;
  static constexpr int kSmem = 1024 + kQ + STAGES * 2 * kKV;
  static constexpr int PREGS = NWG == 3 ? 24 : 40;
  static constexpr int CREGS = NWG == 3 ? 160 : 232;
};

// the padded widths the kernel is built for: D in 8..160, a multiple of 8
__host__ __device__ constexpr int fa_dp(int d) {
  return d <= 16 ? 16 : d <= 32 ? 32 : d <= 48 ? 48 : d <= 64 ? 64
       : d <= 96 ? 96 : d <= 128 ? 128 : 160;
}

template <int DP>
__global__ void __launch_bounds__(FaShape<DP>::THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   bf16* __restrict__ out, int Sq, int Sk, int H, int D,
                   float scale_log2) {
  using F = FaShape<DP>;
  using namespace hopper;
  constexpr int BK = F::BK, BQ = F::BQ, NWG = F::NWG;
  constexpr int NS = BK / 2, NO = DP / 2;
  constexpr int KQK = DP / 16, KPV = BK / 16;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full, k_full[F::STAGES],
      v_full[F::STAGES], kv_empty[F::STAGES];
  const uint32_t base = smem_u32(smem_raw);
  uint8_t* qs = smem_raw + (((base + 1023) & ~1023u) - base);
  uint8_t* kvs = qs + F::kQ;  // stage s: k at kvs + 2 s kKV, v after it

  const int q0 = blockIdx.x * BQ;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int tiles = (Sk + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int s = 0; s < F::STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&kv_empty[s], 4 * NWG);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<F::PREGS>();
    if (threadIdx.x == 0) {
      mbar_expect_tx(&q_full, F::kQ);
      for (int s = 0; s < F::DS; ++s)
        tma_load_4d(qs + s * BQ * 128, &tq, &q_full, 64 * s, h, q0, b);
      for (int it = 0; it < tiles; ++it) {
        const int st = it % F::STAGES;
        mbar_wait(&kv_empty[st], ((it / F::STAGES) & 1) ^ 1);
        uint8_t* ks = kvs + st * 2 * F::kKV;
        mbar_expect_tx(&k_full[st], F::kKV);
        for (int s = 0; s < F::DS; ++s)
          tma_load_4d(ks + s * BK * 128, &tk, &k_full[st], 64 * s, h,
                      it * BK, b);
        mbar_expect_tx(&v_full[st], F::kKV);
        for (int s = 0; s < F::DS; ++s)
          tma_load_4d(ks + F::kKV + s * BK * 128, &tv, &v_full[st], 64 * s,
                      h, it * BK, b);
      }
    }
    return;
  }

  setmaxnreg_inc<F::CREGS>();
  const int c = wg - 1;  // this warpgroup's 64 rows
  // named barriers: this group's turn to issue, and the next group's
  const int my_turn = 1 + c, next = 1 + (c + 1) % NWG;
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
  const int t = lane % 4;
  const bool releaser = lane == 0;
  const uint8_t* qc = qs + c * 64 * 128;

  float s[NS], o[NO];
  uint32_t p[KPV][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  // rows g and g + 8 of the warp: running max of the scaled logits (log2
  // units), this thread's part of the running sum
  float m[2] = {kFaMask, kFaMask}, l[2] = {0.f, 0.f}, alpha[2];

  auto issue_qk = [&](int st) {
    const uint8_t* ks = kvs + st * 2 * F::kKV;
#pragma unroll
    for (int k = 0; k < KQK; ++k)
      Wgmma<BK>::ss(s, desc_sw128(qc + (k / 4) * BQ * 128, 16, 1024)
                           + 2 * (k % 4),
                    desc_sw128(ks + (k / 4) * BK * 128, 16, 1024)
                        + 2 * (k % 4),
                    k > 0);
  };
  auto issue_pv = [&](int st) {
    const uint64_t dv =
        desc_sw128(kvs + st * 2 * F::kKV + F::kKV, BK * 128, 1024);
#pragma unroll
    for (int kk = 0; kk < KPV; ++kk)
      Wgmma<DP>::template rs<1>(o, p[kk], dv + kk * 128, 1);
  };
  // the online softmax of tile `it` on s: new max, alpha, p in s, sums
  auto softmax = [&](int it) {
    const int kv = Sk - it * BK;
    if (kv < BK) {
#pragma unroll
      for (int i = 0; i < BK / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (8 * i + 2 * t + (e & 1) >= kv) s[4 * i + e] = kFaMask;
    }
    float mx[2] = {kFaMask, kFaMask};
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
      mx[0] = fmaxf(mx[0], fmaxf(s[4 * i], s[4 * i + 1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[4 * i + 2], s[4 * i + 3]));
    }
    float neg[2];
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
    for (int i = 0; i < BK / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = fmaf(s[4 * i + e], scale_log2, neg[e / 2]);
        s[4 * i + e] = ex2(x);
        l[e / 2] += s[4 * i + e];
      }
  };
  auto to_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < KPV; ++kk) {
      p[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
      p[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
      p[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
      p[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };
  auto rescale_o = [&]() {
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] *= alpha[(i % 4) / 2];
  };

  mbar_wait(&q_full, 0);
  // the last group lets group 0 go first
  if (c == NWG - 1) bar_arrive(next, 256);

  // tile 0: S(0) alone
  mbar_wait(&k_full[0], 0);
  bar_sync(my_turn, 256);
  wgmma_fence();
  fence_regs(s);
  issue_qk(0);
  wgmma_commit();
  bar_arrive(next, 256);
  wgmma_wait<0>();
  fence_regs(s);
  softmax(0);
  to_p();

  for (int it = 1; it < tiles; ++it) {
    const int st = it % F::STAGES, pst = (it - 1) % F::STAGES;
    mbar_wait(&k_full[st], (it / F::STAGES) & 1);
    bar_sync(my_turn, 256);
    wgmma_fence();
    fence_regs(s);
    issue_qk(st);
    wgmma_commit();
    mbar_wait(&v_full[pst], ((it - 1) / F::STAGES) & 1);
    fence_regs(o);
    issue_pv(pst);
    wgmma_commit();
    bar_arrive(next, 256);
    wgmma_wait<1>();  // S(it) is done, P(it-1) . V(it-1) may run on
    fence_regs(s);
    softmax(it);
    wgmma_wait<0>();
    fence_regs(o);
    fence_u32(p);
    if (releaser) mbar_arrive(&kv_empty[pst]);
    rescale_o();
    to_p();
  }

  // the last P . V
  const int lst = (tiles - 1) % F::STAGES;
  mbar_wait(&v_full[lst], ((tiles - 1) / F::STAGES) & 1);
  bar_sync(my_turn, 256);
  wgmma_fence();
  fence_regs(o);
  issue_pv(lst);
  wgmma_commit();
  // every group takes tiles + 1 turns; the last has none to give after its
  // last, which the first group never waits for
  if (c != NWG - 1) bar_arrive(next, 256);
  wgmma_wait<0>();
  fence_regs(o);
  fence_u32(p);
  if (releaser) mbar_arrive(&kv_empty[lst]);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = 1.f / l[r];
  }
  const size_t rs = (size_t)H * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 64 * c + 16 * w + lane / 4 + 8 * r;
    if (row >= Sq) continue;
    bf16* og = out + ((size_t)b * Sq + row) * rs + (size_t)h * D;
#pragma unroll
    for (int i = 0; i < NO / 4; ++i) {
      const int col = 8 * i + 2 * t;
      if (col < D)
        *reinterpret_cast<__nv_bfloat162*>(og + col) = __floats2bfloat162_rn(
            o[4 * i + 2 * r] * l[r], o[4 * i + 2 * r + 1] * l[r]);
    }
  }
}

// (B, S, H, D) bf16 as a 4-D map (dims D, H, S, B), box 64 x 1 x rows x 1
static bool fa_map(CUtensorMap* map, const void* base, int B, int S, int H,
                   int D, int rows) {
  const uint64_t dims[4] = {(uint64_t)D, (uint64_t)H, (uint64_t)S,
                            (uint64_t)B};
  const uint64_t strides[3] = {(uint64_t)D * 2, (uint64_t)H * D * 2,
                               (uint64_t)S * H * D * 2};
  const uint32_t box[4] = {64, 1, (uint32_t)rows, 1};
  return hopper::make_map(map, base, 4, dims, strides, box);
}

template <int DP>
cudaError_t fa_wgmma_launch(const void* q, const void* k, const void* v,
                            void* out, int B, int Sq, int Sk, int H, int D,
                            float scale, cudaStream_t stream) {
  using F = FaShape<DP>;
  CUtensorMap tq, tk, tv;
  if (!fa_map(&tq, q, B, Sq, H, D, F::BQ) ||
      !fa_map(&tk, k, B, Sk, H, D, F::BK) ||
      !fa_map(&tv, v, B, Sk, H, D, F::BK))
    return cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + F::BQ - 1) / F::BQ, B * H);
  kern<<<grid, F::THREADS, F::kSmem, stream>>>(tq, tk, tv, (bf16*)out, Sq, Sk, H,
                                        D, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t fa_bf16(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Sk, int H, int D, float scale,
                    cudaStream_t s) {
  switch (fa_dp(D)) {
    case 16: return fa_wgmma_launch<16>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 32: return fa_wgmma_launch<32>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 48: return fa_wgmma_launch<48>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 64: return fa_wgmma_launch<64>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 96: return fa_wgmma_launch<96>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 128: return fa_wgmma_launch<128>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 160: return fa_wgmma_launch<160>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
  }
  return cudaErrorInvalidValue;
}

// ---- fp32 helpers ----------------------------------------------------------

constexpr int kFaBK = 64;      // key rows per staged tile
constexpr int kFaWarps32 = 4;  // warps per block, 16 query rows each

// head dim padded to whole 16-element depths (40 -> 48)
__host__ __device__ constexpr int fa_dp16(int d) { return (d + 15) / 16 * 16; }

// Shared memory of one block, rows padded by 16 bytes (common.cuh
// `padded`): the q, k and v tiles (row stride ldq), the scores (lds), p
// (ldp) and O (ldo).
struct FlashLayout {
  size_t q, k, v, s, p, o, bytes;
  int ldq, lds, ldp, ldo;
  __host__ __device__ explicit FlashLayout(int d) {
    const int dp = fa_dp16(d), bq = 16 * kFaWarps32;
    ldq = padded(dp, 4);
    lds = padded(kFaBK, 4);
    ldp = padded(kFaBK, 4);
    ldo = padded(dp, 4);
    SmemCursor cur;
    q = cur.take<float>((size_t)bq * ldq);
    k = cur.take<float>((size_t)kFaBK * ldq);
    v = cur.take<float>((size_t)kFaBK * ldq);
    s = cur.take<float>((size_t)bq * lds);
    p = cur.take<float>((size_t)bq * ldp);
    o = cur.take<float>((size_t)bq * ldo);
    bytes = cur.off;
  }
};

// The block's (batch * head, query tile) and the first rows of its head.
struct FlashTile {
  int q0, b, h;
  size_t rs;  // elements between sequence rows, H * D
  const float* qg;
  const float* kg;
  const float* vg;
  __device__ FlashTile(const float* q, const float* k, const float* v,
                       int Sq, int Sk, int H, int D) {
    q0 = blockIdx.x * 16 * kFaWarps32;
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
// dp columns): zero beyond `rows` rows and D columns, in 16-byte copies (D
// is a multiple of 4 floats, so a copy is all data or all padding).
static __device__ __forceinline__ void fa_load_tile(
    const float* __restrict__ src, size_t rs, int tile_rows, int rows, int D,
    int dp, float* dst, int ld) {
  const int chunks = dp / 4;
  for (int i = threadIdx.x; i < tile_rows * chunks; i += blockDim.x) {
    const int r = i / chunks, c = (i % chunks) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows && c < D)
      val = *reinterpret_cast<const float4*>(src + (size_t)r * rs + c);
    *reinterpret_cast<float4*>(dst + (size_t)r * ld + c) = val;
  }
}

// ---- fp32: FMA on shared-memory tiles --------------------------------------
//
// Each warp owns 16 query rows: its scores (lane: keys lane and lane + 32),
// its softmax rows (two lanes per row, columns 2i + half), its rows of p
// and of the accumulator O, all in shared memory.
template <int NK>
__global__ void __launch_bounds__(32 * kFaWarps32)
flash_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, float* __restrict__ out,
                  int Sq, int Sk, int H, int D, float scale_log2) {
  constexpr int DP = NK * 16;
  constexpr int BQ = 16 * kFaWarps32;
  extern __shared__ __align__(128) unsigned char smem[];
  const FlashLayout lay(D);
  float* qs = reinterpret_cast<float*>(smem + lay.q);
  float* ks = reinterpret_cast<float*>(smem + lay.k);
  float* vs = reinterpret_cast<float*>(smem + lay.v);
  float* ss = reinterpret_cast<float*>(smem + lay.s);
  float* ps = reinterpret_cast<float*>(smem + lay.p);
  float* os = reinterpret_cast<float*>(smem + lay.o);
  const int ldq = lay.ldq, lds = lay.lds, ldp = lay.ldp, ldo = lay.ldo;
  const FlashTile tile(q, k, v, Sq, Sk, H, D);

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

template <int NK>
cudaError_t fa_fp32_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int Sq, int Sk, int H, int D,
                           float scale, cudaStream_t stream) {
  const FlashLayout lay(D);
  auto kern = flash_fp32_kernel<NK>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)lay.bytes);
  if (err != cudaSuccess) return err;
  const int bq = 16 * kFaWarps32;
  const dim3 grid((Sq + bq - 1) / bq, B * H);
  kern<<<grid, 32 * kFaWarps32, lay.bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, Sq, Sk,
      H, D, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t fa_fp32(const void* q, const void* k, const void* v, void* out,
                    int B, int Sq, int Sk, int H, int D, float scale,
                    cudaStream_t s) {
  if (FlashLayout(D).bytes > kMaxSmem) return cudaErrorInvalidValue;
  switch (fa_dp16(D) / 16) {
    case 1: return fa_fp32_launch<1>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 2: return fa_fp32_launch<2>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 3: return fa_fp32_launch<3>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 4: return fa_fp32_launch<4>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 5: return fa_fp32_launch<5>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 6: return fa_fp32_launch<6>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 7: return fa_fp32_launch<7>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 8: return fa_fp32_launch<8>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 9: return fa_fp32_launch<9>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
    case 10: return fa_fp32_launch<10>(q, k, v, out, B, Sq, Sk, H, D, scale, s);
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
      D > 160 || (long long)B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return (int)fyc::fa_bf16(q, k, v, out, B, Sq, Sk, H, D, scale, s);
  return (int)fyc::fa_fp32(q, k, v, out, B, Sq, Sk, H, D, scale, s);
}
