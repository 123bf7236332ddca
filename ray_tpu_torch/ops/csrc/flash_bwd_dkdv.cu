// K2 flash_bwd_dkdv: dv = sum_q P^T dO and dk = sum_q dS^T q, with
// P = exp(q k^T scale - lse), dS = P (dO v^T - delta) scale.
//
// Replaces the dk/dv half of the Pallas backward body
// _flash_bwd_fused_kernel in ray_tpu/ops/attention.py (launched by
// _flash_bwd_pallas). On the TPU one program walks the Q blocks in order
// and carries dk/dv in VMEM scratch from one grid step to the next; blocks
// on the H100 run in parallel and in no order, so here a block owns 128
// keys of one (b, h) and loops over the query tiles itself, from the
// diagonal down under the causal mask, accumulating dk and dv in fp32
// registers. Each dk/dv row is written by one block: no atomics, and the
// result is deterministic. K3 (flash_bwd_dq.cu) computes dq.
//
// Inputs: q, dO [B,H,Sq,D], k, v [B,H,Sk,D] (bf16 or fp16, contiguous),
// lse and delta = rowsum(dO o) fp32 [B*H rows of Sq, `ld` apart; ld a
// multiple of 4]. Outputs dk, dv like k.
//
// Bound on the H100: causal at S 1024, D 64 the kernel does 4 products of
// S*S*D/2 multiply-adds per (b, h) (s, dP, dv, dk) against the bytes of
// q, k, v, dO, dk and dv, 4*S/12 = 341 flops a byte, above the card's ~295,
// so the tensor cores bound it. The design feeds them:
//   - two consumer warpgroups own 64 keys each; K and V are loaded once by
//     TMA, and a producer thread streams Q and dO tiles with their lse and
//     delta slices through a three-stage ring of TMA loads, full and empty
//     mbarriers; setmaxnreg moves the producer's registers to the
//     consumers, which hold dk and dv in fp32;
//   - all four products run on wgmma: S^T = K Q^T and dP^T = V dO^T with
//     both operands in shared memory, then dv += P^T dO and dk += dS^T Q
//     with P^T and dS^T repacked from the accumulators into register A
//     operands and dO and Q read MN-major;
//   - query tiles wholly before a warpgroup's keys are skipped, and the
//     row mask (causal, and query rows past Sq, whose zero-filled lse
//     would give P = 1) is evaluated only on tiles that need it.
// Query tiles are 64 rows at D 64 and 32 at D 128, where dk and dv alone
// take 128 fp32 registers a thread.
#include "hopper.cuh"

namespace rtt {
namespace {

using namespace sm90;

using L = Layout<2, 1>;     // two consumer warpgroups, one block an SM
constexpr int kBN = 128;    // keys per block (two warpgroups of 64)
constexpr int kStages = 3;  // Q/dO ring depth

template <int D>
struct Bwd {
  static constexpr int kBQ = D == 64 ? 64 : 32;  // query rows per tile
  static constexpr int kBoxes = D / 64;
  static constexpr int kKVBytes = kBN * D * 2;   // K or V
  static constexpr int kQBytes = kBQ * D * 2;    // one Q or dO tile
  static constexpr int kStatBytes = kBQ * 4;     // one lse or delta slice
  static constexpr int kSmem =
      2 * kKVBytes + kStages * (2 * kQBytes + 2 * kStatBytes) + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(L::kThreads, L::kBlocksPerSM)
flash_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap tq,
                      const __grid_constant__ CUtensorMap tk,
                      const __grid_constant__ CUtensorMap tv,
                      const __grid_constant__ CUtensorMap tdo,
                      const __grid_constant__ CUtensorMap tlse,
                      const __grid_constant__ CUtensorMap tdelta,
                      uint16_t* __restrict__ dk, uint16_t* __restrict__ dv, int Sq,
                      int Sk, int causal, float scale) {
  using C = Bwd<D>;
  constexpr int BQ = C::kBQ;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 2 * kStages];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t k_s = (raw + 1023) & ~1023u;
  const uint32_t v_s = k_s + C::kKVBytes;
  const uint32_t q_s = v_s + C::kKVBytes;             // stage s at + s * kQBytes
  const uint32_t do_s = q_s + kStages * C::kQBytes;
  const uint32_t lse_s = do_s + kStages * C::kQBytes;  // stage s at + s * kStatBytes
  const uint32_t dl_s = lse_s + kStages * C::kStatBytes;
  const uint32_t kv_full = smem_u32(&bars[0]);
  const uint32_t full0 = smem_u32(&bars[1]);             // + 8 s
  const uint32_t empty0 = smem_u32(&bars[1 + kStages]);  // + 8 s

  const int bh = blockIdx.x;
  const int n0 = (gridDim.y - 1 - blockIdx.y) * kBN;  // keys that see the most queries first
  const int first = causal ? n0 / BQ : 0;
  const int n_q = max((Sq + BQ - 1) / BQ - first, 0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, L::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= L::kConsumerWarps) {
    // ---- producer ----
    reg_dealloc<L::kProducerRegs>();
    if (warp == L::kConsumerWarps && lane == 0) {
      prefetch_map(&tq);
      prefetch_map(&tdo);
      mbar_expect_tx(kv_full, 2 * C::kKVBytes);
      for (int b = 0; b < C::kBoxes; ++b) {
        tma_load_3d(k_s + b * kBN * 128, &tk, kv_full, b * 64, n0, bh);
        tma_load_3d(v_s + b * kBN * 128, &tv, kv_full, b * 64, n0, bh);
      }
      for (int it = 0; it < n_q; ++it) {
        const int s = it % kStages, q0 = (first + it) * BQ;
        if (it >= kStages) mbar_wait(empty0 + 8 * s, ((it / kStages) - 1) & 1);
        const uint32_t full = full0 + 8 * s;
        mbar_expect_tx(full, 2 * C::kQBytes + 2 * C::kStatBytes);
        for (int b = 0; b < C::kBoxes; ++b) {
          tma_load_3d(q_s + s * C::kQBytes + b * BQ * 128, &tq, full, b * 64, q0, bh);
          tma_load_3d(do_s + s * C::kQBytes + b * BQ * 128, &tdo, full, b * 64, q0,
                      bh);
        }
        tma_load_3d(lse_s + s * C::kStatBytes, &tlse, full, q0, bh, 0);
        tma_load_3d(dl_s + s * C::kStatBytes, &tdelta, full, q0, bh, 0);
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns keys k0 .. k0 + 63 ----
    reg_alloc<L::kConsumerRegs>();
    const int wg = warp / 4;
    const int g = lane / 4, t = lane % 4;
    const int k0 = n0 + wg * 64;
    const int key_a = k0 + (warp % 4) * 16 + g;  // this thread's two keys
    const int key_b = key_a + 8;
    const uint32_t k_wg = k_s + wg * 64 * 128, v_wg = v_s + wg * 64 * 128;
    const float scale_log2 = scale * kLog2e;

    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

    const uint64_t k_desc = desc_kmajor(k_wg), v_desc = desc_kmajor(v_wg);
    mbar_wait(kv_full, 0);
    for (int it = 0; it < n_q; ++it) {
      const int s = it % kStages, q0 = (first + it) * BQ;
      mbar_wait(full0 + 8 * s, (it / kStages) & 1);
      if (causal && q0 + BQ - 1 < k0) {  // every query precedes every key
        if (lane == 0) mbar_arrive(empty0 + 8 * s);
        continue;
      }
      const uint32_t q_t = q_s + s * C::kQBytes, do_t = do_s + s * C::kQBytes;

      // S^T = K Q^T and dP^T = V dO^T: 64 keys x BQ queries, fp32.
      float st[BQ / 2], dpt[BQ / 2];
      const uint64_t kd = opaque(k_desc), vd = opaque(v_desc);
      const uint64_t qd = desc_kmajor(q_t), dod = desc_kmajor(do_t);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss<BQ, T::kIsBf16>(st, desc_add(kd, (ks / 4) * kBN * 128 + col),
                                 desc_add(qd, (ks / 4) * BQ * 128 + col), ks);
        wgmma_ss<BQ, T::kIsBf16>(dpt, desc_add(vd, (ks / 4) * kBN * 128 + col),
                                 desc_add(dod, (ks / 4) * BQ * 128 + col), ks);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);

      // P^T and dS^T = P^T (dP^T - delta) scale, packed into A fragments of
      // 16 queries; lse and delta come from the stage by plain loads.
      const float* lse_t = reinterpret_cast<const float*>(
          smem_raw + (lse_s - raw) + s * C::kStatBytes);
      const float* dl_t = reinterpret_cast<const float*>(
          smem_raw + (dl_s - raw) + s * C::kStatBytes);
      const bool edge = q0 + BQ > Sq || (causal && k0 + 63 > q0);
      uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
      for (int i = 0; i < BQ / 8; ++i) {
        const int c = i * 8 + 2 * t;  // query column within the tile
        const float2 l2 = *reinterpret_cast<const float2*>(lse_t + c);
        const float2 d2 = *reinterpret_cast<const float2*>(dl_t + c);
        const float ls[2] = {l2.x * kLog2e, l2.y * kLog2e};
        const float dl[2] = {d2.x, d2.y};
        float p[4], ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = fast_exp2(fmaf(st[4 * i + e], scale_log2, -ls[e & 1]));
          if (edge) {
            const int q = q0 + c + (e & 1);
            const int key = e < 2 ? key_a : key_b;
            if (q >= Sq || (causal && key > q)) p[e] = 0.f;
          }
          ds[e] = p[e] * (dpt[4 * i + e] - dl[e & 1]) * scale;
        }
        pa[i / 2][2 * (i % 2)] = T::pack(p[0], p[1]);
        pa[i / 2][2 * (i % 2) + 1] = T::pack(p[2], p[3]);
        da[i / 2][2 * (i % 2)] = T::pack(ds[0], ds[1]);
        da[i / 2][2 * (i % 2) + 1] = T::pack(ds[2], ds[3]);
      }

      // dv += P^T dO and dk += dS^T Q: dO and Q [queries, D] are MN-major.
      const uint64_t dod_mn = desc_mnmajor(do_t, BQ * 128);
      const uint64_t qd_mn = desc_mnmajor(q_t, BQ * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        wgmma_rs<D, T::kIsBf16>(dv_acc, pa[kk], desc_add(dod_mn, kk * 16 * 128));
        wgmma_rs<D, T::kIsBf16>(dk_acc, da[kk], desc_add(qd_mn, kk * 16 * 128));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dk_acc);
      fence_regs(dv_acc);
      if (lane == 0) mbar_arrive(empty0 + 8 * s);
    }

    uint16_t* dkg = dk + (size_t)bh * Sk * D;
    uint16_t* dvg = dv + (size_t)bh * Sk * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + 2 * t;
      if (key_a < Sk) {
        *reinterpret_cast<uint32_t*>(dkg + (size_t)key_a * D + col) =
            T::pack(dk_acc[4 * i], dk_acc[4 * i + 1]);
        *reinterpret_cast<uint32_t*>(dvg + (size_t)key_a * D + col) =
            T::pack(dv_acc[4 * i], dv_acc[4 * i + 1]);
      }
      if (key_b < Sk) {
        *reinterpret_cast<uint32_t*>(dkg + (size_t)key_b * D + col) =
            T::pack(dk_acc[4 * i + 2], dk_acc[4 * i + 3]);
        *reinterpret_cast<uint32_t*>(dvg + (size_t)key_b * D + col) =
            T::pack(dv_acc[4 * i + 2], dv_acc[4 * i + 3]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout,
                   const float* lse, const float* delta, int ld, void* dk, void* dv,
                   int B, int H, int Sq, int Sk, int causal, float scale,
                   cudaStream_t stream) {
  using C = Bwd<D>;
  const uint64_t bh = (uint64_t)B * H;
  const CUtensorMapDataType f32 = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta;
  cudaError_t err;
  if ((err = make_map(&tq, T::kMapType, 2, q, D, Sq, bh, D, 64, C::kBQ, true)) ||
      (err = make_map(&tdo, T::kMapType, 2, dout, D, Sq, bh, D, 64, C::kBQ, true)) ||
      (err = make_map(&tk, T::kMapType, 2, k, D, Sk, bh, D, 64, kBN, true)) ||
      (err = make_map(&tv, T::kMapType, 2, v, D, Sk, bh, D, 64, kBN, true)) ||
      (err = make_map(&tlse, f32, 4, lse, Sq, bh, 1, ld, C::kBQ, 1, false)) ||
      (err = make_map(&tdelta, f32, 4, delta, Sq, bh, 1, ld, C::kBQ, 1, false)) ||
      (err = prepare<L, flash_bwd_dkdv_kernel<T, D>, C::kSmem>()))
    return err;
  dim3 grid(B * H, (Sk + kBN - 1) / kBN);
  flash_bwd_dkdv_kernel<T, D><<<grid, L::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, tdo, tlse, tdelta, static_cast<uint16_t*>(dk),
      static_cast<uint16_t*>(dv), Sq, Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rtt

// Returns the launch's cudaError_t (0 on success). is_bf16: 1 bf16, 0 fp16.
// lse and delta rows are `ld` floats apart (ld >= Sq, a multiple of 4).
extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, int ld, void* dk, void* dv,
                              int B, int H, int Sq, int Sk, int D, int causal,
                              float scale, int is_bf16, void* stream) {
  using namespace rtt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (ld < Sq || ld % 4) return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return is_bf16 ? launch<sm90::Bf16, 64>(q, k, v, dout, lse, delta, ld, dk, dv, B, H, Sq, Sk, causal, scale, s)
                   : launch<sm90::Fp16, 64>(q, k, v, dout, lse, delta, ld, dk, dv, B, H, Sq, Sk, causal, scale, s);
  if (D == 128)
    return is_bf16 ? launch<sm90::Bf16, 128>(q, k, v, dout, lse, delta, ld, dk, dv, B, H, Sq, Sk, causal, scale, s)
                   : launch<sm90::Fp16, 128>(q, k, v, dout, lse, delta, ld, dk, dv, B, H, Sq, Sk, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
