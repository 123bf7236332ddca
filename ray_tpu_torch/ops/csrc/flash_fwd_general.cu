// K4 flash_fwd_general: o = softmax(q k^T * scale) v and lse = m + log(l),
// for the inputs K1 does not take: fp32, or a head_dim other than 64 and
// 128 (1 to 256), in fp32, bf16 or fp16.
//
// Replaces, for those inputs, the Pallas forward bodies of
// ray_tpu/ops/attention.py, _flash_fwd_single_pass_kernel and
// _flash_fwd_kernel (launched by _flash_fwd_pallas), which compute every
// dtype and head_dim in their own body.
//
// Layout and masks as K1: q [B,H,Sq,D], k/v [B,H,Sk,D] contiguous, o like
// q, lse fp32 [B,H,Sq]; causal at absolute positions (q >= k) with
// masked keys at -1e30 as in the reference, keys past Sk left out.
//
// Bound: at fp32 the work is 4*D flops per (query, key) pair on the CUDA
// cores (67 TFLOP/s) against 4*S*D*4 bytes: for S in the hundreds the
// operations bound it. The design (general.cuh) is the simple one: the
// query rows of a block in shared memory, K and V tiles of 32 keys streamed
// through shared memory (each read once a block), an online softmax a row
// in a warp's registers, every sum in fp32. Tiles past the causal diagonal
// are not loaded.
#include "general.cuh"

namespace rtt {
namespace general {
namespace {

template <typename T, int DL>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk, int D, int causal,
               float scale) {
  extern __shared__ float smem[];
  const int ldk = D + 1;
  float* Qs = smem;              // [kRows][D]
  float* Ks = Qs + kRows * D;    // [kTile][D + 1]
  float* Vs = Ks + kTile * ldk;  // [kTile][D]
  const size_t bh = blockIdx.x;
  const int r0 = blockIdx.y * kRows;
  q += bh * Sq * D;
  k += bh * Sk * D;
  v += bh * Sk * D;
  o += bh * Sq * D;
  lse += bh * Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  load_rows(Qs, D, q, r0, kRows, Sq, D);
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DL];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -INFINITY;
    l[rr] = 0.f;
#pragma unroll
    for (int t = 0; t < DL; ++t) acc[rr][t] = 0.f;
  }
  // Row i sees keys j <= i: keys past the block's last row are all masked.
  const int kend = causal ? min(Sk, r0 + kRows) : Sk;
  for (int j0 = 0; j0 < kend; j0 += kTile) {
    __syncthreads();  // the previous tile is consumed
    load_rows(Ks, ldk, k, j0, kTile, Sk, D);
    load_rows(Vs, D, v, j0, kTile, Sk, D);
    __syncthreads();
    const int j = j0 + lane;
#pragma unroll
    for (int rr = 0; rr < kRowsPerWarp; ++rr) {
      const int r = warp * kRowsPerWarp + rr;
      const int i = r0 + r;
      if (i >= Sq) continue;  // the same for the whole warp
      float s = dot(Qs + r * D, Ks + lane * ldk, D) * scale;
      if (j >= Sk)
        s = -INFINITY;
      else if (causal && j > i)
        s = kMasked;
      // j0 < Sk, so lane 0's key is real and mn is finite.
      const float mn = fmaxf(m[rr], warp_max(s));
      const float p = expf(s - mn);
      const float alpha = expf(m[rr] - mn);
      l[rr] = l[rr] * alpha + warp_sum(p);
      m[rr] = mn;
#pragma unroll
      for (int t = 0; t < DL; ++t) acc[rr][t] *= alpha;
      // P rounded to the operand type before P V, as K1 and the reference
      // round it (a no-op at fp32); l sums it unrounded.
      const float pr = round_to<T>(p);
      for (int jj = 0; jj < kTile; ++jj) {
        const float pj = __shfl_sync(kFull, pr, jj);
        const float* vr = Vs + jj * D;
#pragma unroll
        for (int t = 0; t < DL; ++t) {
          const int d = lane + 32 * t;
          if (d < D) acc[rr][t] = fmaf(pj, vr[d], acc[rr][t]);
        }
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int i = r0 + warp * kRowsPerWarp + rr;
    if (i >= Sq) continue;
    const float ll = l[rr] > 0.f ? l[rr] : 1.f;
    const float inv = 1.f / ll;
#pragma unroll
    for (int t = 0; t < DL; ++t) {
      const int d = lane + 32 * t;
      if (d < D) o[static_cast<size_t>(i) * D + d] = from_f<T>(acc[rr][t] * inv);
    }
    if (lane == 0) lse[i] = m[rr] + logf(ll);
  }
}

template <typename T, int DL>
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        int BH, int Sq, int Sk, int D, int causal, float scale,
        cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (kRows * D + kTile * (D + 1) + kTile * D);
  return launch(fwd_kernel<T, DL>, BH, Sq, smem, stream,
                static_cast<const T*>(q), static_cast<const T*>(k),
                static_cast<const T*>(v), static_cast<T*>(o), lse, Sq, Sk, D,
                causal, scale);
}

}  // namespace
}  // namespace general
}  // namespace rtt

// dtype: 0 fp32, 1 bf16, 2 fp16.
extern "C" int flash_fwd_general(const void* q, const void* k, const void* v,
                                 void* o, float* lse, int B, int H, int Sq,
                                 int Sk, int D, int causal, float scale,
                                 int dtype, void* stream) {
  using namespace rtt::general;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RTT_GENERAL_DISPATCH(dtype, D, run, q, k, v, o, lse, B * H, Sq, Sk, D,
                       causal, scale, s);
}
