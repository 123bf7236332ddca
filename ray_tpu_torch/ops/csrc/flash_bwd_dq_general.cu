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
// rounds it; sums in fp32. Each dq row is written once, by one block: no
// atomics.
//
// Bound: 6 * D flops a (query, key) pair the mask keeps, on the CUDA cores
// at 67 TFLOP/s fp32 (H100 SXM): 0.2887 ms at [8,12,1024,64] fp32 causal,
// where the bytes take 0.04 ms. Why not the tensor cores: see K4
// (flash_fwd_general.cu).
//
// Design: K4's (general.cuh), with one product more and no softmax state.
// A block of four warps owns BM query rows of one (b, h): Q and dO in
// shared memory, lse and delta of the thread's TM rows in registers, dq
// in a TM x 4 DL register tile. K and V stream in tiles of BN keys, up to
// the causal diagonal; only the diagonal tile and the Sk edge are masked.
// Per tile: dP = dO V^T and S = Q K^T (row_products), P = exp2 with log2(e)
// folded into the scale and lse, dS rounded to T and written to the warp's
// slice of shared memory, then dq += dS K (acc_products). K is read by two
// products and V by one, so one buffer each is enough for a stagger: K's
// tile t lands while dP is computed from V's, and V's tile t + 1 while S
// and dS K are computed from K's. Two __syncthreads a tile and one
// __syncwarp (a warp reads only its own rows of dS). Row tiles are
// launched longest causal work first. Shared memory at fp32 D 64: 61 KB a
// block, three an SM.
#include "general.cuh"

namespace rtt {
namespace general {
namespace {

// K4's query rows (FwdTile), with key tiles of 32: a thread's S and dP
// tiles are then 32 floats together, and the kernel fits three blocks an
// SM (key tiles of 64 took 254 registers and ran 1.25x slower).
template <int DL>
using DqTile = Tile<FwdTile<DL>::TM, 4>;

template <typename T, int DL>
size_t dq_smem(int D) {
  using F = DqTile<DL>;
  return sizeof(T) * static_cast<size_t>(smem_ld<T>(D)) *
             (2 * F::BM + 2 * F::BN) +
         sizeof(float) * F::BN * F::LDP;
}

template <typename T, int DL>
__global__ void __launch_bounds__(kThreads)
    dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const T* __restrict__ dout,
              const float* __restrict__ lse, const float* __restrict__ delta,
              T* __restrict__ dq, int Sq, int Sk, int D, int causal,
              float scale, float scale_log2, int copy_bytes) {
  using F = DqTile<DL>;
  constexpr int TM = F::TM, TN = F::TN, BM = F::BM, BN = F::BN;
  extern __shared__ uint4 smem_raw[];
  const int ld = smem_ld<T>(D);
  const int D4 = (D + 3) & ~3;
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BM][ld]
  T* dOs = Qs + BM * ld;                   // [BM][ld]
  T* Ks = dOs + BM * ld;                   // [BN][ld]
  T* Vs = Ks + BN * ld;                    // [BN][ld]
  float* dSs = reinterpret_cast<float*>(Vs + BN * ld);  // [BN][LDP]

  const size_t bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest rows first
  q += bh * Sq * D;
  dout += bh * Sq * D;
  dq += bh * Sq * D;
  lse += bh * Sq;
  delta += bh * Sq;
  k += bh * Sk * D;
  v += bh * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, cg = lane % 8;
  const int row0 = warp * 4 * TM + rg;       // rows row0 + 4 a
  const int prow = warp * 4 * TM + rg * TM;  // the rows' slice of dS

  zero_pad(Qs, ld, 2 * BM + 2 * BN, D);
  const CopyPlan plan = copy_plan<T>(D, copy_bytes);
  copy_rows(Qs, ld, q, r0, BM, Sq, D, plan);
  copy_rows(dOs, ld, dout, r0, BM, Sq, D, plan);
  copy_rows(Vs, ld, v, 0, BN, Sk, D, plan);

  float lse2[TM], dlt[TM], acc[TM][DL][4];
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int i = r0 + row0 + 4 * a;
    lse2[a] = i < Sq ? lse[i] * kLog2e : 0.f;
    dlt[a] = i < Sq ? delta[i] : 0.f;
#pragma unroll
    for (int e = 0; e < DL; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][e][c] = 0.f;
  }
  // Row i sees keys j <= i: keys past the block's last row are all masked.
  const int kend = causal ? min(Sk, r0 + BM) : Sk;
  const int ntiles = (kend + BN - 1) / BN;
  for (int t = 0; t < ntiles; ++t) {
    const int j0 = t * BN;
    // V's tile t has landed, and every warp is done with K's tile t - 1:
    // K's tile t lands while dP is computed.
    cp_async_wait_all();
    __syncthreads();
    copy_rows(Ks, ld, k, j0, BN, Sk, D, plan);
    float dp[TM][TN];
    row_products<DL>(dp, dOs + row0 * ld, Vs + cg * ld, ld, D4);

    // K's tile t has landed and every warp is done with V's tile t: V's
    // tile t + 1 lands while S and dq are computed.
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < ntiles) copy_rows(Vs, ld, v, j0 + BN, BN, Sk, D, plan);
    float s[TM][TN];
    row_products<DL>(s, Qs + row0 * ld, Ks + cg * ld, ld, D4);

    // dS, with P = 0 past the causal diagonal and the Sk edge.
    const bool edge = (causal && j0 + BN - 1 > r0) || j0 + BN > Sk;
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        float p = exp2f(s[a][b] * scale_log2 - lse2[a]);
        if (edge) {
          const int i = r0 + row0 + 4 * a, j = j0 + cg + 8 * b;
          if (j >= Sk || (causal && j > i)) p = 0.f;
        }
        s[a][b] = round_to<T>(p * (dp[a][b] - dlt[a]) * scale);
      }
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      float db[TM];
#pragma unroll
      for (int a = 0; a < TM; ++a) db[a] = s[a][b];
      store_vec<TM>(dSs + (cg + 8 * b) * F::LDP + prow, db);
    }
    __syncwarp();
    // dq += dS K over the tile's keys (dS is 0 past kend and past Sk).
    acc_products<BN, DL>(acc, dSs + prow, F::LDP, Ks + 4 * cg, ld,
                         D4 - 4 * cg);
  }
  store_rows<DL>(dq + static_cast<size_t>(r0 + row0) * D + 4 * cg, acc,
                 Sq - r0 - row0, D, 4 * cg);
}

template <typename T, int DL>
int run(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dq, int BH, int Sq,
        int Sk, int D, int causal, float scale, cudaStream_t stream) {
  using F = DqTile<DL>;
  const dim3 grid(BH, (Sq + F::BM - 1) / F::BM);
  return launch_grid(dq_kernel<T, DL>, grid, dq_smem<T, DL>(D), stream,
                     static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<const T*>(dout),
                     lse, delta, static_cast<T*>(dq), Sq, Sk, D, causal,
                     scale, scale * kLog2e,
                     copy_size(sizeof(T) * D, q, k, v, dout));
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
