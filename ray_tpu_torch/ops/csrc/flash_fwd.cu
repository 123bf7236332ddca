// K1 flash_fwd: o = softmax(q k^T * scale) v and lse = m + log(l).
//
// Replaces the Pallas forward bodies of ray_tpu/ops/attention.py,
// _flash_fwd_single_pass_kernel (Sk <= 2048) and _flash_fwd_kernel (online
// softmax, Sk > 2048), both launched by _flash_fwd_pallas. One kernel
// covers both ranges: the single-pass/online split and the head folding
// there were choices for VMEM and the TPU's per-program overhead.
//
// Layout: q [B,H,Sq,D], k/v [B,H,Sk,D] (bf16 or fp16, contiguous),
// o like q, lse fp32 [B,H,Sq]. D is 64 or 128. Masks: causal at absolute
// positions (q >= k); keys past Sk score -inf (they are not part of the
// row), causally masked keys score -1e30 as in the reference, and l == 0
// reads as 1.
//
// Bound on the H100: causal at the GPT-2 shape (S 1024, D 64) the work is
// 2*S*S*D flops per (b, h) against 8*S*D bytes of q, k, v and o, S/4 = 256
// flops a byte, just under the card's ~295: the bytes bound it, and the
// tensor cores nearly so. So the design aims at the tensor cores' rate
// with every byte read once per block:
//   - a block owns 64 query rows of one (b, h) at D 64 (one consumer
//     warpgroup; two blocks share an SM, so one's loads, prologue and
//     epilogue run beside the other's loop) or 128 at D 128 (two consumer
//     warpgroups). A producer warpgroup, of which one thread issues the TMA
//     loads (Q once, then K and V tiles of 128 keys into a ring of two
//     stages, with full and empty mbarriers for K and for V), runs ahead
//     of the consumers; setmaxnreg moves its registers to them;
//   - S = Q K^T runs on wgmma with both operands in shared memory, the
//     online softmax in fp32 registers with exp2 and the scale folded into
//     one FMA, and O += P V on wgmma with P repacked from the accumulator
//     into the register A operand and V read MN-major;
//   - tiles past the diagonal are never loaded, and the mask is evaluated
//     only on tiles that cross the diagonal or the Sk edge;
//   - blocks of the longest rows are launched first.
#include "hopper.cuh"

namespace rtt {
namespace {

using namespace sm90;

constexpr int kBN = 128;    // keys per tile
constexpr int kStages = 2;  // K/V ring depth

// D 64: one consumer warpgroup of 64 rows and two blocks an SM, so one
// block's loads, prologue and epilogue run beside the other's loop. D 128:
// two consumer warpgroups (128 rows) in one block, which has the registers
// for their accumulators without spilling.
template <int D>
struct Fwd {
  static constexpr int kWGs = D == 64 ? 1 : 2;
  using L = Layout<kWGs, D == 64 ? 2 : 1>;
  static constexpr int kBM = 64 * kWGs;           // query rows per block
  static constexpr int kBoxes = D / 64;            // 64-column boxes per row
  static constexpr int kQBytes = kBM * D * 2;
  static constexpr int kTileBytes = kBN * D * 2;   // one K or V tile
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024;
};

// Barriers: Q full, then K full, V full, K empty, V empty for each stage.
struct Bars {
  uint32_t base;
  __device__ uint32_t q() const { return base; }
  __device__ uint32_t k_full(int s) const { return base + 8 * (1 + s); }
  __device__ uint32_t v_full(int s) const { return base + 8 * (1 + kStages + s); }
  __device__ uint32_t k_empty(int s) const { return base + 8 * (1 + 2 * kStages + s); }
  __device__ uint32_t v_empty(int s) const { return base + 8 * (1 + 3 * kStages + s); }
};

template <typename T, int D>
__global__ void __launch_bounds__(Fwd<D>::L::kThreads, Fwd<D>::L::kBlocksPerSM)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv, uint16_t* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int causal,
                 float scale_log2) {
  using C = Fwd<D>;
  using L = typename C::L;
  constexpr int kBM = C::kBM;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bar_mem[1 + 4 * kStages];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t k_s = q_s + C::kQBytes;  // stage s at + s * kTileBytes
  const uint32_t v_s = k_s + kStages * C::kTileBytes;
  const Bars bars{smem_u32(bar_mem)};

  const int bh = blockIdx.x;
  const int m0 = (gridDim.y - 1 - blockIdx.y) * kBM;  // longest rows first
  int n_tiles = (Sk + kBN - 1) / kBN;
  if (causal) n_tiles = min(n_tiles, (min(m0 + kBM, Sq) - 1) / kBN + 1);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(bars.q(), 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bars.k_full(s), 1);
      mbar_init(bars.v_full(s), 1);
      mbar_init(bars.k_empty(s), L::kConsumerWarps);
      mbar_init(bars.v_empty(s), L::kConsumerWarps);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= L::kConsumerWarps) {
    // ---- producer: Q, then K and V of each tile as their stage frees ----
    reg_dealloc<L::kProducerRegs>();
    if (warp == L::kConsumerWarps && lane == 0) {
      prefetch_map(&tq);
      prefetch_map(&tk);
      prefetch_map(&tv);
      mbar_expect_tx(bars.q(), C::kQBytes);
      for (int b = 0; b < C::kBoxes; ++b)
        tma_load_3d(q_s + b * kBM * 128, &tq, bars.q(), b * 64, m0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % kStages;
        const uint32_t ph = ((j / kStages) - 1) & 1;
        if (j >= kStages) mbar_wait(bars.k_empty(s), ph);
        mbar_expect_tx(bars.k_full(s), C::kTileBytes);
        for (int b = 0; b < C::kBoxes; ++b)
          tma_load_3d(k_s + s * C::kTileBytes + b * kBN * 128, &tk, bars.k_full(s),
                      b * 64, j * kBN, bh);
        if (j >= kStages) mbar_wait(bars.v_empty(s), ph);
        mbar_expect_tx(bars.v_full(s), C::kTileBytes);
        for (int b = 0; b < C::kBoxes; ++b)
          tma_load_3d(v_s + s * C::kTileBytes + b * kBN * 128, &tv, bars.v_full(s),
                      b * 64, j * kBN, bh);
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
    const uint64_t q_desc = desc_kmajor(q_s + wg * 64 * 128);

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

    mbar_wait(bars.q(), 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % kStages;
      const uint32_t ph = (j / kStages) & 1;
      mbar_wait(bars.k_full(s), ph);

      // S = Q K^T: 64 x 128 per warpgroup, fp32.
      float sc[kBN / 2];
      const uint64_t qd = opaque(q_desc), kd = desc_kmajor(k_s + s * C::kTileBytes);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss<kBN, T::kIsBf16>(sc, desc_add(qd, (ks / 4) * kBM * 128 + col),
                                  desc_add(kd, (ks / 4) * kBN * 128 + col), ks);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      if (lane == 0) mbar_arrive(bars.k_empty(s));

      const int n0 = j * kBN;
      if (n0 + kBN > Sk || (causal && n0 + kBN - 1 > r0)) {
#pragma unroll
        for (int i = 0; i < kBN / 8; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = n0 + i * 8 + 2 * t + (e & 1);
            const int row = e < 2 ? row_a : row_b;
            if (col >= Sk) sc[4 * i + e] = -INFINITY;
            else if (causal && col > row) sc[4 * i + e] = kNegInf;
          }
      }
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        mx_a = fmaxf(mx_a, fmaxf(sc[4 * i], sc[4 * i + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[4 * i + 2], sc[4 * i + 3]));
      }
      mx_a = quad_max(mx_a);
      mx_b = quad_max(mx_b);
      const float alpha_a = fast_exp2((m_a - mx_a) * scale_log2);
      const float alpha_b = fast_exp2((m_b - mx_b) * scale_log2);
      m_a = mx_a;
      m_b = mx_b;

      // P = exp2(S scale log2e - m scale log2e), packed into A fragments.
      const float ms_a = m_a * scale_log2, ms_b = m_b * scale_log2;
      uint32_t pa[kBN / 16][4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int i = 0; i < kBN / 8; ++i) {
        const float p0 = fast_exp2(fmaf(sc[4 * i], scale_log2, -ms_a));
        const float p1 = fast_exp2(fmaf(sc[4 * i + 1], scale_log2, -ms_a));
        const float p2 = fast_exp2(fmaf(sc[4 * i + 2], scale_log2, -ms_b));
        const float p3 = fast_exp2(fmaf(sc[4 * i + 3], scale_log2, -ms_b));
        sum_a += p0 + p1;
        sum_b += p2 + p3;
        pa[i / 2][2 * (i % 2)] = T::pack(p0, p1);
        pa[i / 2][2 * (i % 2) + 1] = T::pack(p2, p3);
      }
      l_a = l_a * alpha_a + sum_a;  // per-thread partial; reduced at the end
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        acc[4 * i] *= alpha_a;
        acc[4 * i + 1] *= alpha_a;
        acc[4 * i + 2] *= alpha_b;
        acc[4 * i + 3] *= alpha_b;
      }

      // O += P V: V [keys, D] is MN-major for this product.
      mbar_wait(bars.v_full(s), ph);
      const uint64_t vd = desc_mnmajor(v_s + s * C::kTileBytes, kBN * 128);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<D, T::kIsBf16>(acc, pa[kk], desc_add(vd, kk * 16 * 128));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) mbar_arrive(bars.v_empty(s));
    }

    l_a = quad_sum(l_a);
    l_b = quad_sum(l_b);
    if (l_a == 0.f) l_a = 1.f;
    if (l_b == 0.f) l_b = 1.f;
    const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
    uint16_t* og = o + (size_t)bh * Sq * D;
#pragma unroll
    for (int i = 0; i < D / 8; ++i) {
      const int col = i * 8 + 2 * t;
      if (row_a < Sq)
        *reinterpret_cast<uint32_t*>(og + (size_t)row_a * D + col) =
            T::pack(acc[4 * i] * inv_a, acc[4 * i + 1] * inv_a);
      if (row_b < Sq)
        *reinterpret_cast<uint32_t*>(og + (size_t)row_b * D + col) =
            T::pack(acc[4 * i + 2] * inv_b, acc[4 * i + 3] * inv_b);
    }
    if (t == 0) {
      if (row_a < Sq) lse[(size_t)bh * Sq + row_a] = (m_a * scale_log2 + log2f(l_a)) * kLn2;
      if (row_b < Sq) lse[(size_t)bh * Sq + row_b] = (m_b * scale_log2 + log2f(l_b)) * kLn2;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   int B, int H, int Sq, int Sk, int causal, float scale,
                   cudaStream_t stream) {
  using C = Fwd<D>;
  const uint64_t bh = (uint64_t)B * H;
  CUtensorMap tq, tk, tv;
  cudaError_t err;
  if ((err = make_map(&tq, T::kMapType, 2, q, D, Sq, bh, D, 64, C::kBM, true)) ||
      (err = make_map(&tk, T::kMapType, 2, k, D, Sk, bh, D, 64, kBN, true)) ||
      (err = make_map(&tv, T::kMapType, 2, v, D, Sk, bh, D, 64, kBN, true)) ||
      (err = prepare<typename C::L, flash_fwd_kernel<T, D>, C::kSmem>()))
    return err;
  dim3 grid(B * H, (Sq + C::kBM - 1) / C::kBM);
  flash_fwd_kernel<T, D><<<grid, C::L::kThreads, C::kSmem, stream>>>(
      tq, tk, tv, static_cast<uint16_t*>(o), lse, Sq, Sk, causal, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rtt

// Returns the launch's cudaError_t (0 on success). is_bf16: 1 bf16, 0 fp16.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int H, int Sq, int Sk, int D,
                         int causal, float scale, int is_bf16, void* stream) {
  using namespace rtt;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return is_bf16 ? launch<sm90::Bf16, 64>(q, k, v, o, lse, B, H, Sq, Sk, causal, scale, s)
                   : launch<sm90::Fp16, 64>(q, k, v, o, lse, B, H, Sq, Sk, causal, scale, s);
  if (D == 128)
    return is_bf16 ? launch<sm90::Bf16, 128>(q, k, v, o, lse, B, H, Sq, Sk, causal, scale, s)
                   : launch<sm90::Fp16, 128>(q, k, v, o, lse, B, H, Sq, Sk, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
