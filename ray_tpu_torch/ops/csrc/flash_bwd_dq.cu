// K3 flash_bwd_dq: dq = sum_k dS k, with dS = P (dP - delta) scale,
// P = exp(q k^T scale - lse) and dP = dO v^T.
//
// Replaces the dq half of the Pallas backward body _flash_bwd_fused_kernel
// in ray_tpu/ops/attention.py (launched by _flash_bwd_pallas). The TPU
// fuses dq, dk and dv into one program that walks its grid in order;
// blocks on the H100 run in parallel and in no order, so dq has a kernel
// of its own: a block owns query rows of one (b, h) and streams the key
// tiles, so each dq row is written by one block, with no atomics, and the
// result is deterministic. K2 (flash_bwd_dkdv.cu) computes dk and dv.
//
// Inputs: q, dO [B,H,Sq,D], k, v [B,H,Sk,D] (bf16 or fp16, contiguous),
// lse and delta = rowsum(dO o) fp32 [B,H,Sq]. Output dq like q.
//
// Bound on the H100: causal at S 1024, D 64 the kernel does 3 products of
// S*S*D/2 multiply-adds per (b, h) (S, dP, dq) against the bytes of q, k,
// v, dO and dq, 3*S/10 = 307 flops a byte, just above the card's ~295, so
// the tensor cores bound it: 0.0196 ms at [8,12,1024,64]. Recomputing P
// and dP here (K2 computes them too) keeps the S x S tiles out of memory.
// The design feeds the tensor cores on K1's skeleton (flash_fwd.cu):
//   - a block owns 64 query rows at D 64 (one consumer warpgroup; two
//     blocks share an SM, so one's loads, prologue and epilogue run beside
//     the other's loop) or 128 at D 128 (two consumer warpgroups). A
//     producer thread loads Q and dO once by TMA, then streams K and V
//     tiles of 64 keys through a two-stage ring with full and empty
//     mbarriers; setmaxnreg moves its registers to the consumers, which
//     hold dq in fp32;
//   - all three products run on wgmma: S = Q K^T and dP = dO V^T with both
//     operands in shared memory, issued together and waited once, then
//     dq += dS K with dS repacked from the accumulators into register A
//     operands and the same K tile read MN-major; a stage is handed back
//     only after that product has read K;
//   - lse and delta of a thread's two rows are read once into registers;
//     tiles past the diagonal are never loaded, a warpgroup skips tiles
//     wholly past its rows, and the masks (causal, keys past Sk) are
//     evaluated only on tiles that cross the diagonal or the Sk edge;
//   - blocks of the longest rows are launched first.
#include "hopper.cuh"

namespace rtt {
namespace {

using namespace sm90;

constexpr int kStages = 2;  // K/V ring depth

template <int D>
struct Dq {
  static constexpr int kWGs = D == 64 ? 1 : 2;
  using L = Layout<kWGs, D == 64 ? 2 : 1>;
  static constexpr int kBM = 64 * kWGs;           // query rows per block
  static constexpr int kBN = 64;                   // keys per tile
  static constexpr int kBoxes = D / 64;            // 64-column boxes per row
  static constexpr int kQBytes = kBM * D * 2;      // Q or dO
  static constexpr int kTileBytes = kBN * D * 2;   // one K or V tile
  static constexpr int kSmem = 2 * kQBytes + 2 * kStages * kTileBytes + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(Dq<D>::L::kThreads, Dq<D>::L::kBlocksPerSM)
flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tq,
                    const __grid_constant__ CUtensorMap tdo,
                    const __grid_constant__ CUtensorMap tk,
                    const __grid_constant__ CUtensorMap tv,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    uint16_t* __restrict__ dq, int Sq, int Sk, int causal,
                    float scale) {
  using C = Dq<D>;
  using L = typename C::L;
  constexpr int kBM = C::kBM, kBN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t do_s = q_s + C::kQBytes;
  const uint32_t k_s = do_s + C::kQBytes;  // stage s at + s * kTileBytes
  const uint32_t v_s = k_s + kStages * C::kTileBytes;
  const uint32_t qdo_full = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]);             // + 8 s
  const uint32_t empty0 = smem_u32(&bars[1 + kStages]);  // + 8 s

  const int bh = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest rows first
  int n_tiles = (Sk + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, (min(m0 + kBM, Sq) - 1) / kBN + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, L::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= L::kConsumerWarps) {
    // ---- producer: Q and dO, then K and V of each tile as its stage frees ----
    reg_dealloc<L::kProducerRegs>();
    if (warp == L::kConsumerWarps && lane == 0) {
      prefetch_map(&tq);
      prefetch_map(&tdo);
      prefetch_map(&tk);
      prefetch_map(&tv);
      mbar_expect_tx(qdo_full, 2 * C::kQBytes);
      for (int b = 0; b < C::kBoxes; ++b) {
        tma_load_3d(q_s + b * kBM * 128, &tq, qdo_full, b * 64, m0, bh);
        tma_load_3d(do_s + b * kBM * 128, &tdo, qdo_full, b * 64, m0, bh);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        if (j >= kStages) mbar_wait(empty0 + 8 * s, ((j / kStages) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * C::kTileBytes);
        for (int b = 0; b < C::kBoxes; ++b) {
          tma_load_3d(k_s + s * C::kTileBytes + b * kBN * 128, &tk, full, b * 64,
                      j * kBN, bh);
          tma_load_3d(v_s + s * C::kTileBytes + b * kBN * 128, &tv, full, b * 64,
                      j * kBN, bh);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns rows r0 .. r0 + 63 ----
    reg_alloc<L::kConsumerRegs>();
    const int wg = warp / 4;
    const int g = lane / 4, t = lane % 4;
    const int r0 = m0 + wg * 64;
    const int row_a = r0 + (warp % 4) * 16 + g;  // this thread's two rows
    const int row_b = row_a + 8;
    const float scale_log2 = scale * kLog2e;
    // Rows past Sq read 0: their Q and dO tiles are zero-filled, so dS is 0.
    const float* lse_bh = lse + (size_t)bh * Sq;
    const float* dl_bh = delta + (size_t)bh * Sq;
    const float ls_a = row_a < Sq ? lse_bh[row_a] * kLog2e : 0.f;
    const float ls_b = row_b < Sq ? lse_bh[row_b] * kLog2e : 0.f;
    const float dl_a = row_a < Sq ? dl_bh[row_a] : 0.f;
    const float dl_b = row_b < Sq ? dl_bh[row_b] : 0.f;
    const uint64_t q_desc = desc_kmajor(q_s + wg * 64 * 128);
    const uint64_t do_desc = desc_kmajor(do_s + wg * 64 * 128);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(qdo_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const int n0 = j * kBN;
      mbar_wait(full0 + 8 * s, (j / kStages) & 1);
      // No row of this warpgroup sees a key of this tile.
      if (r0 >= Sq || (causal && n0 > r0 + 63)) {
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
        continue;
      }
      const uint32_t k_t = k_s + s * C::kTileBytes, v_t = v_s + s * C::kTileBytes;

      // S = Q K^T and dP = dO V^T: 64 rows x kBN keys per warpgroup, fp32.
      float sc[kBN / 2], dp[kBN / 2];
      const uint64_t qd = opaque(q_desc), dod = opaque(do_desc);
      const uint64_t kd = desc_kmajor(k_t), vd = desc_kmajor(v_t);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss<kBN, T::kIsBf16>(sc, desc_add(qd, (ks / 4) * kBM * 128 + col),
                                  desc_add(kd, (ks / 4) * kBN * 128 + col), ks);
        wgmma_ss<kBN, T::kIsBf16>(dp, desc_add(dod, (ks / 4) * kBM * 128 + col),
                                  desc_add(vd, (ks / 4) * kBN * 128 + col), ks);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      fence_regs(dp);

      // dS = P (dP - delta) scale with P = exp2(S scale log2e - lse log2e),
      // packed into A fragments of 16 keys.
      const bool edge = n0 + kBN > Sk || (causal && n0 + kBN - 1 > r0);
      uint32_t da[kBN / 16][4];
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(fmaf(sc[4 * i + e], scale_log2, e < 2 ? -ls_a : -ls_b));
          if (edge) {
            const int key = n0 + i * 8 + 2 * t + (e & 1);
            if (key >= Sk || (causal && key > (e < 2 ? row_a : row_b))) p = 0.f;
          }
          ds[e] = p * (dp[4 * i + e] - (e < 2 ? dl_a : dl_b)) * scale;
        }
        da[i / 2][2 * (i % 2)] = T::pack(ds[0], ds[1]);
        da[i / 2][2 * (i % 2) + 1] = T::pack(ds[2], ds[3]);
      }

      // dq += dS K: the K tile [keys, D] is MN-major for this product.
      const uint64_t kd_mn = desc_mnmajor(k_t, kBN * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<D, T::kIsBf16>(acc, da[kk], desc_add(kd_mn, kk * 16 * 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // K has been read
    }

    uint16_t* dqg = dq + (size_t)bh * Sq * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + 2 * t;
      if (row_a < Sq)
        *reinterpret_cast<uint32_t*>(dqg + (size_t)row_a * D + col) =
            T::pack(acc[4 * i], acc[4 * i + 1]);
      if (row_b < Sq)
        *reinterpret_cast<uint32_t*>(dqg + (size_t)row_b * D + col) =
            T::pack(acc[4 * i + 2], acc[4 * i + 3]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, void* dq, int B, int H,
                   int Sq, int Sk, int causal, float scale, cudaStream_t stream) {
  using C = Dq<D>;
  const uint64_t bh = (uint64_t)B * H;
  CUtensorMap tq, tdo, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, T::kMapType, 2, q, D, Sq, bh, D, 64, C::kBM, true)) ||
      (err = make_map(&tdo, T::kMapType, 2, dout, D, Sq, bh, D, 64, C::kBM, true)) ||
      (err = make_map(&tk, T::kMapType, 2, k, D, Sk, bh, D, 64, C::kBN, true)) ||
      (err = make_map(&tv, T::kMapType, 2, v, D, Sk, bh, D, 64, C::kBN, true)) ||
      (err = prepare<typename C::L, flash_bwd_dq_kernel<T, D>, C::kSmem>()))
    return err;
  dim3 grid(B * H, (Sq + C::kBM - 1) / C::kBM);
  flash_bwd_dq_kernel<T, D><<<grid, C::L::kThreads, C::kSmem, stream>>>(
      tq, tdo, tk, tv, lse, delta, static_cast<uint16_t*>(dq), Sq, Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rtt

// Returns the launch's cudaError_t (0 on success). is_bf16: 1 bf16, 0 fp16.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int H, int Sq,
                            int Sk, int D, int causal, float scale, int is_bf16,
                            void* stream) {
  using namespace rtt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return is_bf16 ? launch<sm90::Bf16, 64>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, scale, s)
                   : launch<sm90::Fp16, 64>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, scale, s);
  if (D == 128)
    return is_bf16 ? launch<sm90::Bf16, 128>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, scale, s)
                   : launch<sm90::Fp16, 128>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
