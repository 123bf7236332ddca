// K2 flash_bwd_dkdv: dv = sum_q P^T dO and dk = sum_q dS^T q, with
// P = exp(q k^T scale - lse), dS = P (dO v^T - delta) scale.
//
// Replaces the dk/dv half of the Pallas backward body
// _flash_bwd_fused_kernel in ray_tpu/ops/attention.py (launched by
// _flash_bwd_pallas). On the TPU one program walks the Q blocks in order
// and carries dk/dv in VMEM scratch from one grid step to the next; blocks
// on the H100 run in parallel and in no order, so here a block owns 64
// keys of one (b, h) and loops over the query tiles itself, from the
// diagonal down under the causal mask, accumulating dk and dv in fp32
// registers. Each dk/dv row is written by one block: no atomics, and the
// result is deterministic. K3 (flash_bwd_dq.cu) computes dq.
//
// Inputs: q, dO [B,H,Sq,D], k, v [B,H,Sk,D] (bf16 or fp16, contiguous),
// lse and delta = rowsum(dO o) fp32 [B,H,Sq]. Outputs dk, dv like k.
//
// Bound on the H100: causal at S 1024, D 64 the kernel does 4 products of
// S*S*D/2 multiply-adds per (b, h) (s, dP, dv, dk) against the bytes of
// q, k, v, dO, dk and dv, 4*S/12 = 341 flops a byte, above the card's ~295,
// so the flops bound it. Recomputing P and dP costs two products that a
// stored S x S tile would save, and keeps that tile out of memory.
#include "flash_common.cuh"

namespace rtt {

constexpr int kBN = 64;  // keys per block

// Query rows per tile: 32 at D 128 keeps the fp32 dk and dv accumulators
// plus the two score tiles within the register file.
template <int D>
struct Bq {
  static constexpr int value = D == 64 ? 64 : 32;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const uint16_t* __restrict__ q,
                      const uint16_t* __restrict__ k,
                      const uint16_t* __restrict__ v,
                      const uint16_t* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      uint16_t* __restrict__ dk, uint16_t* __restrict__ dv,
                      int H, int Sq, int Sk, int causal, float scale) {
  constexpr int LD = Ld<D>::value;
  constexpr int BQ = Bq<D>::value;
  constexpr int kNT = BQ / 8;   // score n-tiles (over queries)
  constexpr int kDT = D / 8;
  constexpr int kKD = D / 16;
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* ks = smem;
  uint16_t* vs = ks + kBN * LD;
  uint16_t* qs = vs + kBN * LD;
  uint16_t* dos = qs + BQ * LD;
  float* lse_s = reinterpret_cast<float*>(dos + BQ * LD);
  float* dl_s = lse_s + BQ;

  const int n_block = gridDim.x - 1 - blockIdx.x;  // keys near the start see the most queries
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const int n0 = n_block * kBN;
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const int key_a = n0 + warp * 16 + g;
  const int key_b = key_a + 8;
  const uint16_t* qg = q + bh * Sq * D;
  const uint16_t* dog = dout + bh * Sq * D;

  load_tile<D, kBN>(ks, k + bh * Sk * D, n0, Sk);
  load_tile<D, kBN>(vs, v + bh * Sk * D, n0, Sk);

  float dk_acc[kDT][4], dv_acc[kDT][4];
#pragma unroll
  for (int i = 0; i < kDT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[i][e] = dv_acc[i][e] = 0.f;

  const int n_qt = (Sq + BQ - 1) / BQ;
  const int first = causal ? n0 / BQ : 0;
  for (int i = first; i < n_qt; ++i) {
    const int q0 = i * BQ;
    __syncthreads();
    load_tile<D, BQ>(qs, qg, q0, Sq);
    load_tile<D, BQ>(dos, dog, q0, Sq);
    if (threadIdx.x < BQ) {
      const int r = q0 + threadIdx.x;
      lse_s[threadIdx.x] = r < Sq ? lse[bh * Sq + r] : 0.f;
      dl_s[threadIdx.x] = r < Sq ? delta[bh * Sq + r] : 0.f;
    }
    __syncthreads();

    // s^T = k q^T and dP^T = v dO^T for this warp's 16 keys.
    float st[kNT][4], dpt[kNT][4];
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKD; ++kk) {
      uint32_t ak[4], av[4];
      load_a<LD>(ak, ks, warp * 16, kk * 16);
      load_a<LD>(av, vs, warp * 16, kk * 16);
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        uint32_t b0, b1;
        load_b_t<LD>(b0, b1, qs, nt * 8, kk * 16);
        T::mma(st[nt], ak, b0, b1);
        load_b_t<LD>(b0, b1, dos, nt * 8, kk * 16);
        T::mma(dpt[nt], av, b0, b1);
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = nt * 8 + 2 * t + (e & 1);  // query within the tile
        const int qr = q0 + cl;
        const int key = (e < 2) ? key_a : key_b;
        const bool keep = qr < Sq && !(causal && key > qr);
        const float p = keep ? __expf(st[nt][e] * scale - lse_s[cl]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - dl_s[cl]) * scale;
      }
    }
#pragma unroll
    for (int kc = 0; kc < kNT / 2; ++kc) {
      uint32_t ap[4], ads[4];
      c_to_a<T>(ap, st[2 * kc], st[2 * kc + 1]);
      c_to_a<T>(ads, dpt[2 * kc], dpt[2 * kc + 1]);
#pragma unroll
      for (int dt = 0; dt < kDT; ++dt) {
        uint32_t b0, b1;
        load_b<LD>(b0, b1, dos, kc * 16, dt * 8);
        T::mma(dv_acc[dt], ap, b0, b1);
        load_b<LD>(b0, b1, qs, kc * 16, dt * 8);
        T::mma(dk_acc[dt], ads, b0, b1);
      }
    }
  }

  uint16_t* dkg = dk + bh * Sk * D;
  uint16_t* dvg = dv + bh * Sk * D;
#pragma unroll
  for (int dt = 0; dt < kDT; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (key_a < Sk) {
      *reinterpret_cast<uint32_t*>(dkg + (size_t)key_a * D + col) =
          T::pack(dk_acc[dt][0], dk_acc[dt][1]);
      *reinterpret_cast<uint32_t*>(dvg + (size_t)key_a * D + col) =
          T::pack(dv_acc[dt][0], dv_acc[dt][1]);
    }
    if (key_b < Sk) {
      *reinterpret_cast<uint32_t*>(dkg + (size_t)key_b * D + col) =
          T::pack(dk_acc[dt][2], dk_acc[dt][3]);
      *reinterpret_cast<uint32_t*>(dvg + (size_t)key_b * D + col) =
          T::pack(dv_acc[dt][2], dv_acc[dt][3]);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dk, void* dv, int B, int H, int Sq, int Sk,
                   int causal, float scale, cudaStream_t stream) {
  constexpr int BQ = Bq<D>::value;
  const int smem = (2 * kBN + 2 * BQ) * Ld<D>::value * (int)sizeof(uint16_t) +
                   2 * BQ * (int)sizeof(float);
  cudaError_t err = allow_smem(flash_bwd_dkdv_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sk + kBN - 1) / kBN, H, B);
  flash_bwd_dkdv_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(k),
      static_cast<const uint16_t*>(v), static_cast<const uint16_t*>(dout),
      lse, delta, static_cast<uint16_t*>(dk), static_cast<uint16_t*>(dv), H,
      Sq, Sk, causal, scale);
  return cudaGetLastError();
}

}  // namespace rtt

extern "C" int flash_bwd_dkdv(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, void* dk, void* dv, int B,
                              int H, int Sq, int Sk, int D, int causal,
                              float scale, int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return is_bf16 ? rtt::launch<rtt::BF16, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, causal, scale, s)
                   : rtt::launch<rtt::F16, 64>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, causal, scale, s);
  if (D == 128)
    return is_bf16 ? rtt::launch<rtt::BF16, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, causal, scale, s)
                   : rtt::launch<rtt::F16, 128>(q, k, v, dout, lse, delta, dk, dv, B, H, Sq, Sk, causal, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
