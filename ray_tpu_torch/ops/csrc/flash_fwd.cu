// K1 flash_fwd: o = softmax(q k^T * scale) v and lse = m + log(l).
//
// Replaces the Pallas forward bodies of ray_tpu/ops/attention.py,
// _flash_fwd_single_pass_kernel (Sk <= 2048) and _flash_fwd_kernel (online
// softmax, Sk > 2048), both launched by _flash_fwd_pallas. One kernel
// covers both ranges: the single-pass/online split and the head folding
// there were choices for VMEM and the TPU's per-program overhead.
//
// Layout: q [B,H,Sq,D], k/v [B,H,Sk,D] (bf16 or fp16, contiguous),
// o like q, lse fp32 [B,H,Sq]. D is 64 or 128.
//
// A block of 4 warps owns 64 query rows of one (b, h); each warp owns 16.
// It walks 64-key tiles of K and V staged in shared memory, keeps the
// online softmax state (m, l, acc) in fp32 registers, and skips the key
// tiles past the diagonal under the causal mask (absolute positions,
// q >= k). Ragged Sq and Sk are masked in the kernel: keys past Sk score
// -inf (they are not part of the row), causally masked keys score -1e30
// as in the reference, and l == 0 is treated as 1.
//
// Bound on the H100: causal at the GPT-2 shape (S 1024, D 64) the work is
// 2*S*S*D flops per (b, h) against 8*S*D bytes of q, k, v and o, S/4 = 256
// flops a byte, just under the card's ~295, so the bytes bound it (and the
// flops nearly so). The design keeps the S x S scores out of device
// memory and reads each K/V tile once per 64 query rows. This first
// version runs mma.sync without double buffering, so it is limited by
// issue and latency well before either bound.
#include "flash_common.cuh"

namespace rtt {

constexpr int kBM = 64;  // query rows per block
constexpr int kBN = 64;  // keys per tile

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const uint16_t* __restrict__ q, const uint16_t* __restrict__ k,
                 const uint16_t* __restrict__ v, uint16_t* __restrict__ o,
                 float* __restrict__ lse, int H, int Sq, int Sk, int causal,
                 float scale) {
  constexpr int LD = Ld<D>::value;
  constexpr int kNT = kBN / 8;   // score n-tiles per key tile
  constexpr int kDT = D / 8;     // output n-tiles
  constexpr int kKD = D / 16;    // k-steps over the head dim
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;
  uint16_t* ks = qs + kBM * LD;
  uint16_t* vs = ks + kBN * LD;

  const int m_block = gridDim.x - 1 - blockIdx.x;  // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const uint16_t* qg = q + bh * Sq * D;
  const uint16_t* kg = k + bh * Sk * D;
  const uint16_t* vg = v + bh * Sk * D;
  const int m0 = m_block * kBM;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int row_a = m0 + warp * 16 + g;  // this thread's two rows
  const int row_b = row_a + 8;

  load_tile<D, kBM>(qs, qg, m0, Sq);

  float m_a = kNegInf, m_b = kNegInf, l_a = 0.f, l_b = 0.f;
  float acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  int n_tiles = (Sk + kBN - 1) / kBN;
  if (causal) {
    const int last_q = min(m0 + kBM, Sq) - 1;
    n_tiles = min(n_tiles, last_q / kBN + 1);
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kBN;
    __syncthreads();  // previous tile fully consumed
    load_tile<D, kBN>(ks, kg, n0, Sk);
    load_tile<D, kBN>(vs, vg, n0, Sk);
    __syncthreads();

    float s[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      uint32_t a[4];
      load_a<LD>(a, qs, warp * 16, kk * 16);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t b0, b1;
        load_b_t<LD>(b0, b1, ks, nt * 8, kk * 16);
        T::mma(s[nt], a, b0, b1);
      }
    }

    float mx_a = kNegInf, mx_b = kNegInf;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        const int row = (e < 2) ? row_a : row_b;
        float x = s[nt][e] * scale;
        if (col >= Sk) x = -INFINITY;
        else if (causal && col > row) x = kNegInf;
        s[nt][e] = x;
      }
      mx_a = fmaxf(mx_a, fmaxf(s[nt][0], s[nt][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[nt][2], s[nt][3]));
    }
    const float mn_a = fmaxf(m_a, quad_max(mx_a));
    const float mn_b = fmaxf(m_b, quad_max(mx_b));
    const float alpha_a = __expf(m_a - mn_a), alpha_b = __expf(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      s[nt][0] = __expf(s[nt][0] - m_a);
      s[nt][1] = __expf(s[nt][1] - m_a);
      s[nt][2] = __expf(s[nt][2] - m_b);
      s[nt][3] = __expf(s[nt][3] - m_b);
      sum_a += s[nt][0] + s[nt][1];
      sum_b += s[nt][2] + s[nt][3];
    }
    l_a = l_a * alpha_a + sum_a;  // per-thread partial; reduced at the end
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int dt = 0; dt < kDT; ++dt) {
      acc[dt][0] *= alpha_a;
      acc[dt][1] *= alpha_a;
      acc[dt][2] *= alpha_b;
      acc[dt][3] *= alpha_b;
    }
#pragma unroll
    for (int kc = 0; kc < kNT / 2; ++kc) {
      uint32_t a[4];
      c_to_a<T>(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        uint32_t b0, b1;
        load_b<LD>(b0, b1, vs, kc * 16, dt * 8);
        T::mma(acc[dt], a, b0, b1);
      }
    }
  }

  l_a = quad_sum(l_a);
  l_b = quad_sum(l_b);
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  uint16_t* og = o + bh * Sq * D;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_a < Sq)
      *reinterpret_cast<uint32_t*>(og + (size_t)row_a * D + col) =
          T::pack(acc[dt][0] * inv_a, acc[dt][1] * inv_a);
    if (row_b < Sq)
      *reinterpret_cast<uint32_t*>(og + (size_t)row_b * D + col) =
          T::pack(acc[dt][2] * inv_b, acc[dt][3] * inv_b);
  }
  if (t == 0) {
    if (row_a < Sq) lse[bh * Sq + row_a] = m_a + logf(l_a == 0.f ? 1.f : l_a);
    if (row_b < Sq) lse[bh * Sq + row_b] = m_b + logf(l_b == 0.f ? 1.f : l_b);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Sq, int Sk, int causal,
                   float scale, cudaStream_t stream) {
  const int smem = (kBM + 2 * kBN) * Ld<D>::value * (int)sizeof(uint16_t);
  cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<uint16_t*>(o), lse, H, Sq,
      Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace rtt

// Returns the launch's cudaError_t (0 on success). is_bf16: 1 bf16, 0 fp16.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, void* o,
                         float* lse, int B, int H, int Sq, int Sk, int D,
                         int causal, float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return is_bf16 ? rtt::launch<rtt::BF16, 64>(q, k, v, o, lse, B, H, Sq, Sk, causal, scale, s)
                   : rtt::launch<rtt::F16, 64>(q, k, v, o, lse, B, H, Sq, Sk, causal, scale, s);
  if (D == 128)
    return is_bf16 ? rtt::launch<rtt::BF16, 128>(q, k, v, o, lse, B, H, Sq, Sk, causal, scale, s)
                   : rtt::launch<rtt::F16, 128>(q, k, v, o, lse, B, H, Sq, Sk, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
