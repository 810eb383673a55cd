// The port's Hopper GEMM core: out = epilogue(A . B^T) with A (M, K) and
// B (N, K) bf16 row-major in device memory (K contiguous: activations and
// nn.Linear weights), fp32 accumulation on wgmma.
//
// An output tile is 128 rows against NB tiles of BN rows of B (NB = 2 pairs
// two row ranges of one weight, e.g. the value and gate halves of W1, so
// that one tile holds both its value and its gate columns). The blocks are
// persistent, one per SM, each walking output tiles (column tiles fastest).
// 384 threads: warpgroup 0 is the producer, of which one thread keeps a
// ring of STAGES k-slices (64 wide) in flight by TMA, each completing on a
// `full` mbarrier, and runs on into the next tile's slices while the
// consumers finish the last one; warpgroups 1 and 2 each own 64 rows and
// run m64nNk16 wgmma products (N = NB * BN, over the NB adjacent B tiles,
// so each A slice is read from shared memory once) from the swizzled
// shared-memory tiles into register accumulators, keep one group of
// products in flight, and hand each slice back through its `empty`
// mbarrier. Rows past M, B rows past N and k past K read as zero (TMA fills
// them), so any M, N, K with 16-byte row strides are taken; the epilogue
// drops what lies outside.
//
// The epilogue is a functor: epi(acc, row, col) with acc[NB][BN / 2] in the
// wgmma accumulator layout (hopper.cuh), row the tile row of acc[.][4i] and
// col the column of acc[.][4i] in B's first range; acc[.][4i + 1] is col + 1,
// acc[.][4i + 2 .. 3] row + 8, and i steps col by 8.
#pragma once

#include "hopper.cuh"

namespace fyc {

constexpr int kGemmBM = 128;       // rows per block
constexpr int kGemmBK = 64;        // k per stage: one 128-byte row
constexpr int kGemmThreads = 384;  // producer + two consumer warpgroups

template <int BN, int NB, int STAGES>
struct GemmShape {
  static constexpr int kA = kGemmBM * kGemmBK * 2;  // bytes per stage
  static constexpr int kB = BN * kGemmBK * 2;
  static constexpr int kStage = kA + NB * kB;
  // 1024 bytes of slack to align the ring to the swizzle atom
  static constexpr int kSmem = 1024 + STAGES * kStage;
  static_assert(BN % 8 == 0 && NB * BN <= 256, "wgmma N");
  static_assert(kA % 1024 == 0 && kB % 1024 == 0, "1024-byte tiles");
};

template <int BN, int NB, int STAGES, class Epi>
__global__ void __launch_bounds__(kGemmThreads, 1)
wgmma_gemm_kernel(const __grid_constant__ CUtensorMap ta,
                  const __grid_constant__ CUtensorMap tb, int K, int n_tiles,
                  int units, int b_split, Epi epi) {
  using S = GemmShape<BN, NB, STAGES>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  const uint32_t base = smem_u32(smem_raw);
  uint8_t* ring = smem_raw + (((base + 1023) & ~1023u) - base);

  const int k_tiles = (K + kGemmBK - 1) / kGemmBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int g = 0;  // slices issued by this block, over all its tiles
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        const int n0 = (u % n_tiles) * BN, m0 = (u / n_tiles) * kGemmBM;
        for (int kt = 0; kt < k_tiles; ++kt, ++g) {
          const int s = g % STAGES;
          mbar_wait(&empty[s], ((g / STAGES) & 1) ^ 1);
          uint8_t* st = ring + s * S::kStage;
          mbar_expect_tx(&full[s], S::kStage);
          tma_load_2d(st, &ta, &full[s], kt * kGemmBK, m0);
#pragma unroll
          for (int j = 0; j < NB; ++j)
            tma_load_2d(st + S::kA + j * S::kB, &tb, &full[s], kt * kGemmBK,
                        n0 + j * b_split);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();
    const int c = wg - 1;  // the consumer's 64 rows of the tile
    const int w = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool releaser = lane == 0;
    float acc[NB * BN / 2];
    int g = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int n0 = (u % n_tiles) * BN, m0 = (u / n_tiles) * kGemmBM;
#pragma unroll
      for (int i = 0; i < NB * BN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < k_tiles; ++kt, ++g) {
        const int s = g % STAGES;
        mbar_wait(&full[s], (g / STAGES) & 1);
        const uint8_t* st = ring + s * S::kStage;
        const uint64_t da = desc_sw128(st + c * 64 * 128, 16, 1024);
        const uint64_t db = desc_sw128(st + S::kA, 16, 1024);
        wgmma_fence();
        fence_regs(acc);
#pragma unroll
        for (int k = 0; k < kGemmBK / 16; ++k)
          Wgmma<NB * BN>::ss(acc, da + 2 * k, db + 2 * k, 1);
        wgmma_commit();
        // the products of the previous slice are done: hand its stage back
        wgmma_wait<1>();
        fence_regs(acc);
        if (kt > 0 && releaser) mbar_arrive(&empty[(g - 1) % STAGES]);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      if (releaser) mbar_arrive(&empty[(g - 1) % STAGES]);
      epi(reinterpret_cast<float(&)[NB][BN / 2]>(acc),
          m0 + 64 * c + 16 * w + lane / 4, n0 + 2 * (lane % 4));
    }
  }
}

// Launches the GEMM over ceil(M / 128) x ceil(N / BN) tiles on at most one
// block per SM; the B tile j of column tile n starts at B row
// n * BN + j * b_split.
template <int BN, int NB, int STAGES, class Epi>
cudaError_t gemm_launch(const CUtensorMap& ta, const CUtensorMap& tb, int M,
                        int N, int K, int b_split, Epi epi,
                        cudaStream_t stream) {
  using S = GemmShape<BN, NB, STAGES>;
  auto kern = wgmma_gemm_kernel<BN, NB, STAGES, Epi>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return err;
  const int n_tiles = (N + BN - 1) / BN;
  const long long units =
      (long long)n_tiles * ((M + kGemmBM - 1) / kGemmBM);
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;
  const int blocks = (int)(units < sms ? units : sms);
  kern<<<blocks, kGemmThreads, S::kSmem, stream>>>(ta, tb, K, n_tiles,
                                                   (int)units, b_split, epi);
  return cudaGetLastError();
}

}  // namespace fyc
