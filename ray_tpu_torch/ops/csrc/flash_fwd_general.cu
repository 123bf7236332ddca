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
// masked keys at kMasked = -1e30 as in the reference, keys past Sk left
// out. P is rounded to the operand type before P V; l sums it unrounded.
//
// Bound: 4 * D flops a (query, key) pair the mask keeps, on the CUDA cores
// at 67 TFLOP/s fp32 (H100 SXM): 0.1925 ms at [8,12,1024,64] fp32 causal,
// where the bytes (4 * 25 MB) take 0.03 ms. Why CUDA cores and not the
// tensor cores: the card holds this kernel to 1e-5 of the plain version in
// fp32, as the reference computes fp32 in fp32. TF32 keeps ~3 digits, and
// an exact 3xTF32 split needs hi/lo copies of every operand and a
// transposed V for wgmma's K-major B, for twelve instantiations: too much
// for one step. 16-bit inputs share this fp32 path.
//
// Design. A block of four warps owns BM = 16 TM query rows of one (b, h)
// and streams K and V in tiles of BN = 8 TN keys. Each thread holds a
// TM x TN micro-tile of S = Q K^T and a TM x 4 DL micro-tile of O (its TM
// rows, columns 32 e + 4 cg + c), both in registers, so the two products
// are outer products over shared memory:
//   - Q K^T: Q and K stay row-major in shared memory (the layout cp.async
//     can fill) and a k-step takes 4 head-dim columns: one 16-byte load (8
//     for 16-bit, widened to fp32 in registers) per row of Q and of K
//     feeds 4 TM TN FMAs, 10.7 FMAs a load at TM 4, TN 8 (the SIMT kernel
//     did 2 loads an FMA). smem_ld pads rows to an odd number of 16-byte
//     units, so the 8 rows a load instruction touches hit 8 bank groups.
//   - P V: each thread writes its P (rounded to T) to a per-warp slice of
//     shared memory, its TM rows adjacent, and reads them back as one
//     vector per key beside DL 16-byte loads of V: 10.7 FMAs a load at
//     DL 2.
//   - Softmax: a row is shared by the 8 threads of a column group, so its
//     max and sum take 3 shuffles (the SIMT kernel: 5 per row and key
//     tile of 32, per warp); exp2 with log2(e) folded into the scale. 64
//     query rows a block (the SIMT kernel: 16) read each K/V tile a
//     quarter as often.
//   - What is left: per head-dim column (or key) a thread reads TM + TN
//     words for TM TN FMAs, 12 for 32 at 4 x 8, so the SM's 32 words a
//     cycle of shared memory cap both products at 2/3 of the FMA rate.
//     8 x 8 micro-tiles would lift that, but with this layout they take
//     255 registers, spill, and measured twice as slow on an H100.
// Copies run by cp.async (16 bytes where the rows and pointers allow, 4
// otherwise, plain loads for 16-bit inputs at odd head dims) into one
// buffer each for K and V, staggered: V's tile t lands while S is
// computed from K's, and K's tile t + 1 while O is accumulated from V's.
// Two __syncthreads a tile; one buffer each keeps a block small enough
// for three an SM at D 64 (the SIMT kernel's copies were synchronous).
// Row tiles are launched longest causal work first; no tile past the
// diagonal is loaded, and only the diagonal tile and the Sk edge are
// masked.
//
// Tiles by DL = ceil(D / 32) rounded to a power of two (fp32 shared
// memory a block, and the blocks an SM it leaves room for):
//   DL 1, 2: TM 4, TN 8 (BM 64, BN 64), 68 KB at D 64: 3;
//   DL 4:    TM 4, TN 4 (BM 64, BN 32), 74.5 KB at D 128: 3;
//   DL 8:    TM 2, TN 4 (BM 32, BN 32), 102 KB at D 256: 2.
#include "general.cuh"

namespace rtt {
namespace general {
namespace {

constexpr float kLn2 = 0.6931471805599453f;

template <typename T, int DL>
size_t fwd_smem(int D) {
  using F = FwdTile<DL>;
  return sizeof(T) * static_cast<size_t>(smem_ld<T>(D)) * (F::BM + 2 * F::BN) +
         sizeof(float) * F::BN * F::LDP;
}

template <typename T, int DL>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o,
               float* __restrict__ lse, int Sq, int Sk, int D, int causal,
               float scale_log2, int copy_bytes) {
  using F = FwdTile<DL>;
  constexpr int TM = F::TM, TN = F::TN, BM = F::BM, BN = F::BN;
  extern __shared__ uint4 smem_raw[];
  const int ld = smem_ld<T>(D);
  const int D4 = (D + 3) & ~3;
  T* Qs = reinterpret_cast<T*>(smem_raw);  // [BM][ld]
  T* Ks = Qs + BM * ld;                    // [BN][ld]
  T* Vs = Ks + BN * ld;                    // [BN][ld]
  float* Ps = reinterpret_cast<float*>(Vs + BN * ld);  // [BN][LDP]

  const size_t bh = blockIdx.x;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * BM;  // longest rows first
  q += bh * Sq * D;
  k += bh * Sk * D;
  v += bh * Sk * D;
  o += bh * Sq * D;
  lse += bh * Sq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rg = lane / 8, cg = lane % 8;
  // This thread's rows are row0 + 4 a (a < TM), its keys in a tile cg +
  // 8 b (b < TN), its columns of O 32 e + 4 cg + c (e < DL, c < 4); its
  // rows sit side by side in P's columns from prow.
  const int row0 = warp * 4 * TM + rg;
  const int prow = warp * 4 * TM + rg * TM;

  zero_pad(Qs, ld, BM + 2 * BN, D);
  const CopyPlan plan = copy_plan<T>(D, copy_bytes);
  copy_rows(Qs, ld, q, r0, BM, Sq, D, plan);
  copy_rows(Ks, ld, k, 0, BN, Sk, D, plan);

  float m[TM], l[TM], acc[TM][DL][4];
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    m[a] = -INFINITY;
    l[a] = 0.f;
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
    // K's tile t has landed, and every warp is done with V's tile t - 1
    // and with its slice of P: V's tile t lands while S is computed.
    cp_async_wait_all();
    __syncthreads();
    copy_rows(Vs, ld, v, j0, BN, Sk, D, plan);

    // S = Q K^T, 4 head-dim columns a step.
    float s[TM][TN];
    row_products<DL>(s, Qs + row0 * ld, Ks + cg * ld, ld, D4);

    // Scores in log2 units; the causal diagonal and the Sk edge masked.
    const bool edge = (causal && j0 + BN - 1 > r0) || j0 + BN > Sk;
#pragma unroll
    for (int a = 0; a < TM; ++a)
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        float x = s[a][b] * scale_log2;
        if (edge) {
          const int i = r0 + row0 + 4 * a, j = j0 + cg + 8 * b;
          if (j >= Sk)
            x = -INFINITY;
          else if (causal && j > i)
            x = kMasked;
        }
        s[a][b] = x;
      }

    // Online softmax. Key 0 is in tile 0 and every row sees it, so the
    // running max is finite from the first tile on.
#pragma unroll
    for (int a = 0; a < TM; ++a) {
      float mx = s[a][0];
#pragma unroll
      for (int b = 1; b < TN; ++b) mx = fmaxf(mx, s[a][b]);
      const float mn = fmaxf(m[a], group_max<8>(mx));
      const float alpha = exp2f(m[a] - mn);
      float sum = 0.f;
#pragma unroll
      for (int b = 0; b < TN; ++b) {
        const float p = exp2f(s[a][b] - mn);
        sum += p;
        s[a][b] = round_to<T>(p);  // as the reference rounds P for P V
      }
      l[a] = l[a] * alpha + group_sum<8>(sum);
      m[a] = mn;
#pragma unroll
      for (int e = 0; e < DL; ++e)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][e][c] *= alpha;
    }
#pragma unroll
    for (int b = 0; b < TN; ++b) {
      float pb[TM];
#pragma unroll
      for (int a = 0; a < TM; ++a) pb[a] = s[a][b];
      store_vec<TM>(Ps + (cg + 8 * b) * F::LDP + prow, pb);
    }
    // V's tile t has landed and P is written, and every warp is done with
    // K's tile t: K's tile t + 1 lands while O is accumulated.
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < ntiles) copy_rows(Ks, ld, k, j0 + BN, BN, Sk, D, plan);

    // O += P V over the tile's keys. Past kend P is 0, and past Sk V's
    // rows are zeros too.
    acc_products<BN, DL>(acc, Ps + prow, F::LDP, Vs + 4 * cg, ld,
                         D4 - 4 * cg);
  }

#pragma unroll
  for (int a = 0; a < TM; ++a) {
    const int i = r0 + row0 + 4 * a;
    if (i >= Sq) continue;
    const float ll = l[a] > 0.f ? l[a] : 1.f;
    const float inv = 1.f / ll;
    T* orow = o + static_cast<size_t>(i) * D;
#pragma unroll
    for (int e = 0; e < DL; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 32 * e + 4 * cg + c;
        if (col < D) orow[col] = from_f<T>(acc[a][e][c] * inv);
      }
    if (cg == 0) lse[i] = m[a] * kLn2 + logf(ll);
  }
}

template <typename T, int DL>
int run(const void* q, const void* k, const void* v, void* o, float* lse,
        int BH, int Sq, int Sk, int D, int causal, float scale,
        cudaStream_t stream) {
  using F = FwdTile<DL>;
  const dim3 grid(BH, (Sq + F::BM - 1) / F::BM);
  return launch_grid(fwd_kernel<T, DL>, grid, fwd_smem<T, DL>(D), stream,
                     static_cast<const T*>(q), static_cast<const T*>(k),
                     static_cast<const T*>(v), static_cast<T*>(o), lse, Sq,
                     Sk, D, causal, scale * kLog2e,
                     copy_size(sizeof(T) * D, q, k, v));
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
