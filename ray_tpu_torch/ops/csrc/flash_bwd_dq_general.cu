// K6 flash_bwd_dq_general: dq for the inputs K3 does not take (fp32, or a
// head_dim other than 64 and 128; 1 to 256, fp32/bf16/fp16).
//
// Replaces, for those inputs, the dq half of the Pallas body
// _flash_bwd_fused_kernel (ray_tpu/ops/attention.py, launched by
// _flash_bwd_pallas), which computes every dtype and head_dim itself.
//
// For each query i and key j (j <= i when causal):
//   dS = exp(q.k * scale - lse_i) (dO_i.v_j - delta_i) * scale,
//   dq_i += dS k_j,
// with dS rounded to the operand type before the product, as the reference
// rounds it. Bound: like K4, the operations on the CUDA cores at fp32.
// Design (general.cuh): a block owns 16 query rows of one (b, h) (q and dO
// in shared memory, dq in a warp's registers) and streams k and v in tiles
// of 32 keys, one a lane, up to the causal diagonal. Each dq row is written
// once, by one block: no atomics.
#include "general.cuh"

namespace rtt {
namespace general {
namespace {

template <typename T, int DL>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Sq, int Sk, int D, int causal,
              float scale) {
  extern __shared__ float smem[];
  const int ldk = D + 1;
  float* Qs = smem;               // [kRows][D]
  float* dOs = Qs + kRows * D;    // [kRows][D]
  float* Ks = dOs + kRows * D;    // [kTile][D + 1]
  float* Vs = Ks + kTile * ldk;   // [kTile][D + 1]
  const size_t bh = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  q += bh * Sq * D;
  dout += bh * Sq * D;
  dq += bh * Sq * D;
  lse += bh * Sq;
  delta += bh * Sq;
  k += bh * Sk * D;
  v += bh * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows(Qs, D, q, r0, kRows, Sq, D);
  load_rows(dOs, D, dout, r0, kRows, Sq, D);
  float lse_r[kRowsPerWarp], delta_r[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = r0 + warp * kRowsPerWarp + rr;
    lse_r[rr] = i < Sq ? lse[i] : 0.f;
    delta_r[rr] = i < Sq ? delta[i] : 0.f;
#pragma unroll
    for (int t = 0; t < DL; ++t) acc[rr][t] = 0.f;
  }
  // Row i sees keys j <= i: keys past the block's last row are all masked.
  const int kend = causal ? min(Sk, r0 + kRows) : Sk;
  for (int j0 = 0; j0 < kend; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_rows(Ks, ldk, k, j0, kTile, Sk, D);
    load_rows(Vs, ldk, v, j0, kTile, Sk, D);
    __syncthreads();
    const int j = j0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int i = r0 + r;
      if (i >= Sq) continue;  // the same for the whole warp
      float s = dot(Qs + r * D, Ks + lane * ldk, D) * scale;
      const float dp = dot(dOs + r * D, Vs + lane * ldk, D);
      if (causal && j > i) s = kMasked;
      const float p = j < Sk ? expf(s - lse_r[rr]) : 0.f;
      const float ds = round_to<T>(p * (dp - delta_r[rr]) * scale);
      for (int jj = 0; jj < kTile; ++jj) {
        const float dsj = __shfl_sync(kFull, ds, jj);
        const float* kr = Ks + jj * ldk;
#pragma unroll
        for (int t = 0; t < DL; ++t) {
          const int d = lane + 32 * t;
          if (d < D) acc[rr][t] = fmaf(dsj, kr[d], acc[rr][t]);
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = r0 + warp * kRowsPerWarp + rr;
    if (i >= Sq) continue;
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      const int d = lane + 32 * t;
      if (d < D) dq[static_cast<size_t>(i) * D + d] = from_f<T>(acc[rr][t]);
    }
  }
}

template <typename T, int DL>
int run(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dq, int BH, int Sq,
        int Sk, int D, int causal, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * kRows * D + 2 * kTile * (D + 1));
  return launch(dq_kernel<T, DL>, BH, Sq, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                delta, static_cast<T*>(dq), Sq, Sk, D, causal, scale);
}

}  // namespace
}  // namespace general
}  // namespace rtt

// dtype: 0 fp32, 1 bf16, 2 fp16. lse and delta: fp32 [B,H,Sq], contiguous.
extern "C" int flash_bwd_dq_general(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dq, int B, int H, int Sq, int Sk,
                                    int D, int causal, float scale, int dtype,
                                    void* stream) {
  using namespace rtt::general;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RTT_GENERAL_DISPATCH(dtype, D, run, q, k, v, dout, lse, delta, dq, B * H,
                       Sq, Sk, D, causal, scale, s);
}
