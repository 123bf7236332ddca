// K5 flash_bwd_dkdv_general: dk and dv for the inputs K2 does not take
// (fp32, or a head_dim other than 64 and 128; 1 to 256, fp32/bf16/fp16).
//
// Replaces, for those inputs, the dk/dv half of the Pallas body
// _flash_bwd_fused_kernel (ray_tpu/ops/attention.py, launched by
// _flash_bwd_pallas), which computes every dtype and head_dim itself.
//
// For each key j and query i (i >= j when causal):
//   P = exp(q.k * scale - lse_i), dS = P (dO_i.v_j - delta_i) * scale,
//   dv_j += P dO_i, dk_j += dS q_i,
// with P and dS rounded to the operand type before the products, as the
// reference rounds them. Bound: like K4, the operations on the CUDA cores
// at fp32. Design (general.cuh): a block owns 16 key rows of one (b, h)
// (their k and v in shared memory, dk and dv in a warp's registers) and
// streams q, dO, lse and delta in tiles of 32 queries, one a lane; query
// tiles wholly before the block's first key are skipped when causal. Each
// dk and dv row is written once, by one block: no atomics.
#include "general.cuh"

namespace rtt {
namespace general {
namespace {

template <typename T, int DL>
__global__ void __launch_bounds__(kThreads)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int Sq, int Sk, int D, int causal,
                float scale) {
  extern __shared__ float smem[];
  const int ldq = D + 1;
  float* Ks = smem;                // [kRows][D]
  float* Vs = Ks + kRows * D;      // [kRows][D]
  float* Qs = Vs + kRows * D;      // [kTile][D + 1]
  float* dOs = Qs + kTile * ldq;   // [kTile][D + 1]
  float* Ls = dOs + kTile * ldq;   // [kTile]
  float* Ds = Ls + kTile;          // [kTile]
  const size_t bh = blockIdx.x;
  const int c0 = blockIdx.y * kRows;
  q += bh * Sq * D;
  dout += bh * Sq * D;
  lse += bh * Sq;
  delta += bh * Sq;
  k += bh * Sk * D;
  v += bh * Sk * D;
  dk += bh * Sk * D;
  dv += bh * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows(Ks, D, k, c0, kRows, Sk, D);
  load_rows(Vs, D, v, c0, kRows, Sk, D);
  float dka[kRowsPerWarp][DL], dva[kRowsPerWarp][DL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr)
#pragma unroll
    for (int t = 0; t < DL; ++t) dka[rr][t] = dva[rr][t] = 0.f;

  // Query i sees key j only if i >= j: no query before c0 sees the block.
  const int i_start = causal ? c0 / kTile * kTile : 0;
  for (int i0 = i_start; i0 < Sq; i0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_rows(Qs, ldq, q, i0, kTile, Sq, D);
    load_rows(dOs, ldq, dout, i0, kTile, Sq, D);
    if (threadIdx.x < kTile) {
      const int i = i0 + threadIdx.x;
      Ls[threadIdx.x] = i < Sq ? lse[i] : 0.f;
      Ds[threadIdx.x] = i < Sq ? delta[i] : 0.f;
    }
    __syncthreads();
    const int i = i0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int c = warp * kRowsPerWarp + rr;
      const int j = c0 + c;
      if (j >= Sk) continue;  // the same for the whole warp
      float s = dot(Qs + lane * ldq, Ks + c * D, D) * scale;
      const float dp = dot(dOs + lane * ldq, Vs + c * D, D);
      if (causal && j > i) s = kMasked;
      float p = i < Sq ? expf(s - Ls[lane]) : 0.f;
      float ds = p * (dp - Ds[lane]) * scale;
      p = round_to<T>(p);
      ds = round_to<T>(ds);
      for (int ii = 0; ii < kTile; ++ii) {
        const float p_i = __shfl_sync(kFull, p, ii);
        const float dsi = __shfl_sync(kFull, ds, ii);
        const float* qr = Qs + ii * ldq;
        const float* dor = dOs + ii * ldq;
#pragma unroll
        for (int t = 0; t < DL; ++t) {
          const int d = lane + 32 * t;
          if (d < D) {
            dva[rr][t] = fmaf(p_i, dor[d], dva[rr][t]);
            dka[rr][t] = fmaf(dsi, qr[d], dka[rr][t]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int j = c0 + warp * kRowsPerWarp + rr;
    if (j >= Sk) continue;
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      const int d = lane + 32 * t;
      if (d < D) {
        dk[static_cast<size_t>(j) * D + d] = from_f<T>(dka[rr][t]);
        dv[static_cast<size_t>(j) * D + d] = from_f<T>(dva[rr][t]);
      }
    }
  }
}

template <typename T, int DL>
int run(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dk, void* dv, int BH,
        int Sq, int Sk, int D, int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kRows * D + 2 * kTile * (D + 1) + 2 * kTile);
  return launch(dkdv_kernel<T, DL>, BH, Sk, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<const T*>(dout), lse,
                delta, static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, D,
                causal, scale);
}

}  // namespace
}  // namespace general
}  // namespace rtt

// dtype: 0 fp32, 1 bf16, 2 fp16. lse and delta: fp32 [B,H,Sq], contiguous.
extern "C" int flash_bwd_dkdv_general(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* delta,
                                      void* dk, void* dv, int B, int H,
                                      int Sq, int Sk, int D, int causal,
                                      float scale, int dtype, void* stream) {
  using namespace rtt::general;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RTT_GENERAL_DISPATCH(dtype, D, run, q, k, v, dout, lse, delta, dk, dv,
                       B * H, Sq, Sk, D, causal, scale, s);
}
