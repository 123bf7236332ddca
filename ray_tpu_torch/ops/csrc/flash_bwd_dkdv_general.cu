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
// with P and dS rounded to the operand type before the products (dS from
// the unrounded P), as the reference rounds them; sums in fp32. Each dk
// and dv row is written once, by one block: no atomics.
//
// Bound: 8 * D flops a (query, key) pair the mask keeps, on the CUDA cores
// at 67 TFLOP/s fp32 (H100 SXM): 0.3850 ms at [8,12,1024,64] fp32 causal,
// where the bytes take 0.05 ms. Why not the tensor cores: see K4
// (flash_fwd_general.cu).
//
// Design: K4's shapes (general.cuh) with the roles of queries and keys
// swapped. A block of four warps owns BM key rows of one (b, h): K and V in
// shared memory, dk and dv in two TM x 4 DL register tiles. Q, dO, lse and
// delta stream in tiles of BN queries from the block's first key on (when
// causal, earlier queries see none of its keys); only the diagonal tile
// and the Sq edge are masked. Per tile: S^T = K Q^T and dP^T = V dO^T
// (row_products), P^T and dS^T rounded to T and written to shared memory
// laid out [query][key], the thread's keys adjacent, then dk += dS^T Q
// and dv += P^T dO (acc_products). Q and dO are each read by two products,
// so with one buffer each the copies are staggered: dO's tile t (with lse
// and delta, 4-byte copies: a tile of them starts at any float) lands while
// S^T is computed, Q's tile t + 1 while dv is. Three __syncthreads a tile
// and one __syncwarp (a warp reads only its own keys of P and dS). The
// blocks with the most query tiles, the first keys when causal, launch
// first.
//
// Two accumulators make registers the limit: a thread holds 4 keys at DL
// 1-2, 2 at DL 4 and 1 at DL 8, so that dk and dv are at most 64 floats
// (K4's FwdTile holds 4 query rows up to DL 4), and 4 queries of a tile of
// 32 (with 8, S^T and dP^T took 64 floats, 254 registers and 1.8x the time).
// Shared memory at fp32 D 64: 70 KB a block, three an SM.
#include "general.cuh"

namespace rtt {
namespace general {
namespace {

template <int DL>
using DkdvTile = Tile<DL <= 2 ? 4 : DL == 4 ? 2 : 1, 4>;

template <typename T, int DL>
size_t dkdv_smem(int D) {
  using F = DkdvTile<DL>;
  return sizeof(T) * static_cast<size_t>(smem_ld<T>(D)) *
             (2 * F::BM + 2 * F::BN) +
         sizeof(float) * 2 * F::BN * (F::LDP + 1);
}

// At DL 1, told of three blocks an SM (what the shared memory allows),
// ptxas takes 168 registers, where left alone it took 128 and spilled 12
// bytes. Elsewhere 0, no bound: three blocks at DL 2 kept 168 registers
// but ran 4-6% slower, and at DL 4 raised 16-bit registers from 160 to
// 182 and the time by 28% (two blocks an SM instead of three).
template <typename T, int DL>
__global__ void __launch_bounds__(kThreads, DL == 1 ? 3 : 0)
    dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dk,
                T* __restrict__ dv, int Sq, int Sk, int D, int causal,
                float scale, float scale_log2, int copy_bytes) {
  using F = DkdvTile<DL>;
  constexpr int TM = F::TM, TN = F::TN, BM = F::BM, BN = F::BN;
  extern __shared__ uint4 smem_raw[];
  const int ld = smem_ld<T>(D);
  const int D4 = (D + 3) & ~3;
  T* Ks = reinterpret_cast<T*>(smem_raw);  // [BM][ld]
  T* Vs = Ks + BM * ld;                    // [BM][ld]
  T* Qs = Vs + BM * ld;                    // [BN][ld]
  T* dOs = Qs + BN * ld;                   // [BN][ld]
  float* Ps = reinterpret_cast<float*>(dOs + BN * ld);  // [BN][LDP]
  float* dSs = Ps + BN * F::LDP;                         // [BN][LDP]
  float* Ls = dSs + BN * F::LDP;                         // [BN]
  float* Ds = Ls + BN;                                   // [BN]

  const size_t bh = blockIdx.x;
  const int c0 = blockIdx.y * BM;  // the first keys have the most work
  q += bh * Sq * D;
  dout += bh * Sq * D;
  lse += bh * Sq;
  delta += bh * Sq;
  k += bh * Sk * D;
  v += bh * Sk * D;
  dk += bh * Sk * D;
  dv += bh * Sk * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, cg = lane % 8;
  const int row0 = warp * 4 * TM + rg;       // keys row0 + 4 a
  const int prow = warp * 4 * TM + rg * TM;  // the keys' slice of P, dS

  // Query i sees key j only if i >= j: no query before c0 sees the block.
  const int i_first = causal ? c0 : 0;
  const int ntiles = Sq > i_first ? (Sq - i_first + BN - 1) / BN : 0;
  zero_pad(Ks, ld, 2 * BM + 2 * BN, D);
  const CopyPlan plan = copy_plan<T>(D, copy_bytes);
  if (ntiles > 0) {  // else dk and dv are zeros; no copy is left in flight
    copy_rows(Ks, ld, k, c0, BM, Sk, D, plan);
    copy_rows(Vs, ld, v, c0, BM, Sk, D, plan);
    copy_rows(Qs, ld, q, i_first, BN, Sq, D, plan);
  }

  float dka[TM][DL][4], dva[TM][DL][4];
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int e = 0; e < DL; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) dka[a][e][c] = dva[a][e][c] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    const int i0 = i_first + t * BN;
    // Q's tile t has landed, and every warp is done with dO's tile t - 1
    // and with P, dS, lse and delta: dO's tile t lands while S^T is
    // computed.
    cp_async_wait_all();
    __syncthreads();
    copy_rows(dOs, ld, dout, i0, BN, Sq, D, plan);
    if (threadIdx.x < 2 * BN) {
      const int x = threadIdx.x % BN, i = i0 + x;
      const float* src = threadIdx.x < BN ? lse : delta;
      cp_async<4>(threadIdx.x < BN ? Ls + x : Ds + x, src + (i < Sq ? i : 0),
                  i < Sq);
    }
    float s[TM][TN];
    row_products<DL>(s, Ks + row0 * ld, Qs + cg * ld, ld, D4);

    // dO's tile t, lse and delta have landed.
    cp_async_wait_all();
    __syncthreads();
    float dp[TM][TN];
    row_products<DL>(dp, Vs + row0 * ld, dOs + cg * ld, ld, D4);

    // P^T and dS^T, with P = 0 past the Sq edge and before the causal
    // diagonal (query i < key j).
    const bool edge = (causal && c0 + BM - 1 > i0) || i0 + BN > Sq;
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      const int x = cg + 8 * b;
      const float l2 = Ls[x] * kLog2e, dl = Ds[x];
      float pb[TM], db[TM];
#pragma unroll
      for (int a = 0; a < TM; ++a) {
        float p = exp2f(s[a][b] * scale_log2 - l2);
        if (edge) {
          const int i = i0 + x, j = c0 + row0 + 4 * a;
          if (i >= Sq || (causal && j > i)) p = 0.f;
        }
        db[a] = round_to<T>(p * (dp[a][b] - dl) * scale);
        pb[a] = round_to<T>(p);
      }
      store_vec<TM>(Ps + x * F::LDP + prow, pb);
      store_vec<TM>(dSs + x * F::LDP + prow, db);
    }
    __syncwarp();
    // dk += dS^T Q over the tile's queries (dS is 0 past Sq).
    acc_products<BN, DL>(dka, dSs + prow, F::LDP, Qs + 4 * cg, ld,
                         D4 - 4 * cg);
    // Every warp is done with Q's tile t: Q's tile t + 1 lands while dv is
    // accumulated.
    __syncthreads();
    if (t + 1 < ntiles) copy_rows(Qs, ld, q, i0 + BN, BN, Sq, D, plan);
    acc_products<BN, DL>(dva, Ps + prow, F::LDP, dOs + 4 * cg, ld,
                         D4 - 4 * cg);
  }
  const size_t first = static_cast<size_t>(c0 + row0) * D + 4 * cg;
  store_rows<DL>(dk + first, dka, Sk - c0 - row0, D, 4 * cg);
  store_rows<DL>(dv + first, dva, Sk - c0 - row0, D, 4 * cg);
}

template <typename T, int DL>
int run(const void* q, const void* k, const void* v, const void* dout,
        const float* lse, const float* delta, void* dk, void* dv, int BH,
        int Sq, int Sk, int D, int causal, float scale, cudaStream_t stream) {
  using F = DkdvTile<DL>;
  const dim3 grid(BH, (Sk + F::BM - 1) / F::BM);
  return launch_grid(dkdv_kernel<T, DL>, grid, dkdv_smem<T, DL>(D), stream,
                     static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<const T*>(dout),
                     lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
                     Sq, Sk, D, causal, scale, scale * kLog2e,
                     copy_size(sizeof(T) * D, q, k, v, dout));
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
