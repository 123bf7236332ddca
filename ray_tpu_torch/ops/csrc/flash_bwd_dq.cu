// K3 flash_bwd_dq: dq = sum_k dS k, dS = P (dP - delta) scale,
// P = exp(q k^T scale - lse), dP = dO v^T.
//
// Replaces the dq half of the Pallas backward body _flash_bwd_fused_kernel
// in ray_tpu/ops/attention.py (launched by _flash_bwd_pallas). The TPU
// fuses dq, dk and dv into one program to save launch overhead; here dq
// has its own kernel, with a block per (b, h, 64 query rows), so that each
// dq row is written by one block and no atomics are needed (the result is
// deterministic). K2 (flash_bwd_dkdv.cu) computes dk and dv.
//
// Inputs: q, dO [B,H,Sq,D], k, v [B,H,Sk,D] (bf16 or fp16, contiguous),
// lse and delta = rowsum(dO o) fp32 [B,H,Sq]. Output dq like q.
//
// Each warp owns 16 query rows. The block walks 64-key tiles staged in
// shared memory, up to the diagonal under the causal mask, recomputes P
// from the saved lse, and accumulates dq in fp32 registers.
//
// Bound on the H100: causal at S 1024, D 64 the kernel does 3 products of
// S*S*D/2 multiply-adds per (b, h) (s, dP, dq) against the bytes of q, k,
// v, dO and dq, 3*S/10 = 307 flops a byte, at the card's ~295, so
// flops and bytes bound it about equally. Recomputing P costs one more
// product than a stored P would, to keep the S x S tile out of memory.
#include "flash_common.cuh"

namespace rtt {

constexpr int kBM = 64;  // query rows per block
constexpr int kBN = 64;  // keys per tile

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const uint16_t* __restrict__ q,
                    const uint16_t* __restrict__ k,
                    const uint16_t* __restrict__ v,
                    const uint16_t* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, uint16_t* __restrict__ dq,
                    int H, int Sq, int Sk, int causal, float scale) {
  constexpr int LD = Ld<D>::value;
  constexpr int kNT = kBN / 8;
  constexpr int kDT = D / 8;
  constexpr int kKD = D / 16;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* qs = smem;
  uint16_t* dos = qs + kBM * LD;
  uint16_t* ks = dos + kBM * LD;
  uint16_t* vs = ks + kBN * LD;

  const int m_block = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const int m0 = m_block * kBM;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int row_a = m0 + warp * 16 + g;
  const int row_b = row_a + 8;
  const uint16_t* kg = k + bh * Sk * D;
  const uint16_t* vg = v + bh * Sk * D;

  load_tile<D, kBM>(qs, q + bh * Sq * D, m0, Sq);
  load_tile<D, kBM>(dos, dout + bh * Sq * D, m0, Sq);
  const float lse_a = row_a < Sq ? lse[bh * Sq + row_a] : 0.f;
  const float lse_b = row_b < Sq ? lse[bh * Sq + row_b] : 0.f;
  const float dl_a = row_a < Sq ? delta[bh * Sq + row_a] : 0.f;
  const float dl_b = row_b < Sq ? delta[bh * Sq + row_b] : 0.f;

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
    __syncthreads();
    load_tile<D, kBN>(ks, kg, n0, Sk);
    load_tile<D, kBN>(vs, vg, n0, Sk);
    __syncthreads();

    float s[kNT][4], dp[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      uint32_t aq[4], ado[4];
      load_a<LD>(aq, qs, warp * 16, kk * 16);
      load_a<LD>(ado, dos, warp * 16, kk * 16);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t b0, b1;
        load_b_t<LD>(b0, b1, ks, nt * 8, kk * 16);
        T::mma(s[nt], aq, b0, b1);
        load_b_t<LD>(b0, b1, vs, nt * 8, kk * 16);
        T::mma(dp[nt], ado, b0, b1);
      }
    }
    // dS = P (dP - delta) scale, rounded to the operand type.
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + nt * 8 + 2 * t + (e & 1);
        const int row = (e < 2) ? row_a : row_b;
        const bool keep = col < Sk && row < Sq && !(causal && col > row);
        const float p = keep ? __expf(s[nt][e] * scale - (e < 2 ? lse_a : lse_b)) : 0.f;
        s[nt][e] = p * (dp[nt][e] - (e < 2 ? dl_a : dl_b)) * scale;
      }
    }
#pragma unroll
    for (int kc = 0; kc < kNT / 2; ++kc) {
      uint32_t a[4];
      c_to_a<T>(a, s[2 * kc], s[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        uint32_t b0, b1;
        load_b<LD>(b0, b1, ks, kc * 16, dt * 8);
        T::mma(acc[dt], a, b0, b1);
      }
    }
  }

  uint16_t* dqg = dq + bh * Sq * D;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (row_a < Sq)
      *reinterpret_cast<uint32_t*>(dqg + (size_t)row_a * D + col) =
          T::pack(acc[dt][0], acc[dt][1]);
    if (row_b < Sq)
      *reinterpret_cast<uint32_t*>(dqg + (size_t)row_b * D + col) =
          T::pack(acc[dt][2], acc[dt][3]);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int H, int Sq, int Sk, int causal,
                   float scale, cudaStream_t stream) {
  const int smem = (2 * kBM + 2 * kBN) * Ld<D>::value * (int)sizeof(uint16_t);
  cudaError_t err = allow_smem(flash_bwd_dq_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + kBM - 1) / kBM, H, B);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      lse, delta, static_cast<uint16_t*>(dq), H, Sq, Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace rtt

extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int H, int Sq,
                            int Sk, int D, int causal, float scale, int is_bf16,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return is_bf16 ? rtt::launch<rtt::BF16, 64>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, scale, s)
                   : rtt::launch<rtt::F16, 64>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, scale, s);
  if (D == 128)
    return is_bf16 ? rtt::launch<rtt::BF16, 128>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, scale, s)
                   : rtt::launch<rtt::F16, 128>(q, k, v, dout, lse, delta, dq, B, H, Sq, Sk, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
