// The Mamba-2 scan within each chunk, forward and backward (see ssd.cuh
// for the layouts, what the kernels replace and what bounds them).
//
// One block a (head, chunk, batch row), 8 warps, each warp 16 rows i of the
// chunk at a time (row tiles w and 15 - w of 16 at chunk 256, so that the
// causal work is even). For rows i and columns j of the chunk:
//   forward:  y_i = sum_{j <= i} (C_i . B_j) exp(cs_i - cs_j) dt_j x_j
//                   + exp(cs_i) (C_i . e^T), e the state entering the chunk;
//   backward: dxd_i = sum_{j >= i} (B_i . C_j) exp(cs_j - cs_i) dy_j
//                   + exp(cs_end - cs_i) (B_i . g^T), g the gradient of the
//             state leaving the chunk; dx_i = dt_i dxd_i and
//             ddt_i = x_i . dxd_i + A da_i, with da_u the gradient of the
//             chunk's cumulative sum dt A at u, summed over what it decays:
//               da_u = sum_{s < u <= t} P[t][s]   (P[t][s] = (C_t . B_s)
//                        exp(cs_t - cs_s) dt_s (dy_t . x_s), within)
//                    + sum_{t >= u} dy_t . exp(cs_t) (C_t . e^T)  (entering)
//                    + sum_{s < u} dt_s (x_s . the state term of dxd_s)
//                    + exp(cs_end) <g, e>          (state_pass's parts);
//             and the chunk's part of dA, sum_u dt_u da_u.
// Each term of da is a sum of what it counts: the form as differences of
// row and column sums of P (dy . y - ...) cancels to a small da from large
// sums and loses it to bf16 rounding. The first term's rows are suffix sums
// along each row of P^T (j-blocks taken from the last), masked to s < u
// and summed down the rows, a partial a warp in shared memory, the warps
// added in order.
// The chunk's C B^T (B C^T backward) is shared by every head: the caller
// computes it once a (batch row, chunk) in fp32 and each warp reads its
// 16 x 32 pieces as accumulator fragments, multiplies them by their decays
// and dt and masks them in registers, splits them into bf16 hi and lo
// parts and feeds them as the A operand of the product with the values (x,
// or dy's hi and lo parts, staged once in shared memory and read by
// ldmatrix): no [chunk, chunk] block a head exists anywhere. The row
// operand of the state's term (C forward, B backward) sits in registers as
// fragments, the state's two parts in shared memory. Staging loads several
// pieces a thread before it stores any; three blocks an SM forward overlap
// one block's loads with another's products (backward: one).
#include "ssd.cuh"

namespace rtt {
namespace ssd {

// Backward, one 16 x 32 block of K^T (k, rows i of the tile at i0, columns
// j from j0; after its decays and mask): P^T[i][j] = k[i][j] dt_i (x_i .
// dy_j) on the tensor cores from x's fragments and dy's rows (zs: the hi
// parts, then Q rows of the lo parts), then each row's sums over t >= u
// from the right (carry: the columns past the block), masked to i < u and
// summed down the warp's rows into part[u].
template <int P, int Q, int kYld>
__device__ __forceinline__ void da_block(const float (&k)[4][4],
                                         const uint32_t (&xr)[P / 8][2],
                                         const uint16_t* zs, const float* dts,
                                         float* part, float (&carry)[2],
                                         int i0, int j0) {
  const int lane = threadIdx.x % 32, g = lane / 4, q4 = lane % 4;
  float pv[4][4] = {};
#pragma unroll
  for (int ks = 0; ks < P / 16; ++ks) {
    const uint32_t af[4] = {xr[2 * ks][0], xr[2 * ks][1], xr[2 * ks + 1][0],
                            xr[2 * ks + 1][1]};
#pragma unroll
    for (int nt = 0; nt < 4; nt += 2) {
      const uint16_t* yq = zs + (j0 + 8 * nt) * kYld + 16 * ks;
      uint32_t d[4];
      ldsm4<false>(yq, kYld, d);
      const uint32_t h0[2] = {d[0], d[2]}, h1[2] = {d[1], d[3]};
      ldsm4<false>(yq + Q * kYld, kYld, d);
      const uint32_t l0[2] = {d[0], d[2]}, l1[2] = {d[1], d[3]};
      mma(pv[nt], af, h0);
      mma(pv[nt], af, l0);
      mma(pv[nt + 1], af, h1);
      mma(pv[nt + 1], af, l1);
    }
  }
  const float dt_row[2] = {dts[i0 + g], dts[i0 + g + 8]};
  float col[4][2];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) col[nt][0] = col[nt][1] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = i0 + g + 8 * r;
    float run = carry[r];
#pragma unroll
    for (int nt = 3; nt >= 0; --nt) {
      const float v0 = k[nt][2 * r] * dt_row[r] * pv[nt][2 * r];
      const float v1 = k[nt][2 * r + 1] * dt_row[r] * pv[nt][2 * r + 1];
      // Sums of the pairs over this lane's quad from q4 on, and past it.
      float incl = v0 + v1;
      float u = __shfl_sync(kFull, incl, q4 < 3 ? lane + 1 : lane);
      if (q4 < 3) incl += u;
      u = __shfl_sync(kFull, incl, q4 < 2 ? lane + 2 : lane);
      if (q4 < 2) incl += u;
      float after = __shfl_sync(kFull, incl, q4 < 3 ? lane + 1 : lane);
      if (q4 == 3) after = 0.f;
      const float total = __shfl_sync(kFull, incl, lane & ~3);
      const float r1 = run + after + v1;  // column j0 + 8 nt + 2 q4 + 1
      const float r0 = r1 + v0;           // column j0 + 8 nt + 2 q4
      const int j = j0 + 8 * nt + 2 * q4;
      if (i < j) col[nt][0] += r0;
      if (i < j + 1) col[nt][1] += r1;
      run += total;
    }
    carry[r] = run;
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = col[nt][e];
      v += __shfl_xor_sync(kFull, v, 4);
      v += __shfl_xor_sync(kFull, v, 8);
      v += __shfl_xor_sync(kFull, v, 16);
      if (g == 0) part[j0 + 8 * nt + 2 * q4 + e] += v;
    }
}

template <int P, int N, int Q>
struct ScanShape {
  static constexpr int kWarps = 8, kTiles = Q / 16, kJB = 32;
  static constexpr int kHld = N + 8, kYld = P + 8;
  // The state's hi and lo parts [2][P][kHld], cs and dt, the values (x
  // forward, dy's hi part backward) [Q][kYld]: ~72 KB at the cell's
  // widths, three blocks an SM.
  static constexpr size_t kFwdSmem =
      (static_cast<size_t>(Q) * kYld + 2 * P * kHld) * 2 + 2 * Q * 4;
  // Backward: dy's lo part, three row arrays and the warps' partials of
  // da (~119 KB: one block an SM). Before dy is staged, the entering
  // state's hi and lo parts sit in dy's hi part's place.
  static constexpr size_t kBwdSmem =
      kFwdSmem + static_cast<size_t>(Q) * kYld * 2 + (3 + kWarps) * Q * 4;
  static_assert(2 * P * kHld <= Q * kYld, "two states in dy's part");
  static_assert(P % 16 == 0 && N % 16 == 0 && Q % kJB == 0,
                "chunk_scan tiling");
};

template <int P, int N, int Q, bool kFwd>
__global__ void __launch_bounds__(256, kFwd ? 3 : 1) chunk_scan(Args a) {
  using Sh = ScanShape<P, N, Q>;
  extern __shared__ uint4 smem_raw[];
  uint16_t* hs = reinterpret_cast<uint16_t*>(smem_raw);  // [P][kHld]
  uint16_t* hl = hs + P * Sh::kHld;                       // [P][kHld]
  float* css = reinterpret_cast<float*>(hl + P * Sh::kHld);  // [Q]
  float* dts = css + Q;                                       // [Q]
  uint16_t* zs = reinterpret_cast<uint16_t*>(dts + Q);       // [Q][kYld]
  // Backward only: zs is dy's hi part, zl its lo part; before them, the
  // entering state's hi and lo parts in zs.
  uint16_t* zl = zs + Q * Sh::kYld;
  uint16_t* eh = zs;                    // [P][kHld]
  uint16_t* el = zs + P * Sh::kHld;     // [P][kHld]
  float* row_dd = reinterpret_cast<float*>(zl + Q * Sh::kYld);  // x . dxd
  float* row_q = row_dd + Q;    // dt (x . the state term of dxd)
  float* row_off = row_q + Q;   // dy . exp(cs) (C . e^T)
  float* xw = row_off + Q;      // [kWarps][Q]: each warp's part of da
  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z, c = gridDim.y;
  const int H = a.H, S = a.S;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q4 = lane % 4;
  const int t0 = k * Q, valid = min(Q, S - t0);
  const size_t bhk = (static_cast<size_t>(b) * H + h) * c + k;
  const size_t pos0 = static_cast<size_t>(b) * S + t0;
  const size_t hp = static_cast<size_t>(H) * P;  // position stride of y, dy
  const uint16_t* U = kFwd ? a.C : a.B;
  // The chunk's C B^T (forward) or B C^T (backward), [Q, Q] fp32.
  const float* G = a.G + (static_cast<size_t>(b) * c + k) * Q * Q;
  const float* none = nullptr;  // no scale

  for (int i = threadIdx.x; i < Q; i += blockDim.x) {
    css[i] = a.cs[bhk * Q + i];
    dts[i] = i < valid ? a.dt[(pos0 + i) * H + h] : 0.f;
  }
  stage_rows_split(hs, hl, Sh::kHld, a.st + bhk * P * N, N, P, N, P, none);
  if (kFwd) {
    stage_rows(zs, Sh::kYld, a.x + pos0 * a.xs + h * P, a.xs, Q, P, valid);
  } else {
    stage_rows_split(eh, el, Sh::kHld, a.ent + bhk * P * N, N, P, N, P, none);
    for (int i = threadIdx.x; i < Sh::kWarps * Q; i += blockDim.x) xw[i] = 0.f;
  }
  __syncthreads();
  const float cs_end = css[Q - 1];

  if (!kFwd) {
    // The two state terms of da for every row, with the states as hi + lo
    // parts (one rounding of either moves dA by ~0.1%): dy_i . exp(cs_i)
    // (C_i . e^T), and dt_i x_i . exp(cs_end - cs_i) (B_i . g^T). Then dy,
    // hi and lo, in their place.
    for (int r = 0; r < Sh::kTiles; r += 2 * Sh::kWarps) {
      for (int side = 0; side < 2; ++side) {
        const int tile = r + (side ? 2 * Sh::kWarps - 1 - warp : warp);
        if (tile >= Sh::kTiles) continue;  // the whole warp
        const int ia = 16 * tile + g, ib = ia + 8;
        const bool oka = ia < valid, okb = ib < valid;
        const size_t ya = (pos0 + ia) * hp + h * P + 2 * q4;
        const size_t yb = (pos0 + ib) * hp + h * P + 2 * q4;
        const size_t xa = (pos0 + ia) * a.xs + h * P + 2 * q4;
        const size_t xb = (pos0 + ib) * a.xs + h * P + 2 * q4;
        for (int term = 0; term < 2; ++term) {
          const uint16_t* R = term ? a.B : a.C;  // the rows' operand
          const uint16_t* Th = term ? hs : eh;   // the state, hi and lo
          const uint16_t* Tl = term ? hl : el;
          float tacc[P / 8][4] = {};
#pragma unroll
          for (int ks = 0; ks < N / 16; ++ks) {
            const uint16_t* ra = R + (pos0 + ia) * a.bs + 16 * ks + 2 * q4;
            const uint16_t* rb = R + (pos0 + ib) * a.bs + 16 * ks + 2 * q4;
            const uint32_t rf[4] = {oka ? ld32(ra) : 0u, okb ? ld32(rb) : 0u,
                                    oka ? ld32(ra + 8) : 0u,
                                    okb ? ld32(rb + 8) : 0u};
#pragma unroll
            for (int jt = 0; jt < P / 8; jt += 2) {
              const int off = 8 * jt * Sh::kHld + 16 * ks;
              uint32_t d[4];
              ldsm4<false>(Th + off, Sh::kHld, d);
              const uint32_t h0[2] = {d[0], d[2]}, h1[2] = {d[1], d[3]};
              ldsm4<false>(Tl + off, Sh::kHld, d);
              const uint32_t l0[2] = {d[0], d[2]}, l1[2] = {d[1], d[3]};
              mma(tacc[jt], rf, h0);
              mma(tacc[jt], rf, l0);
              mma(tacc[jt + 1], rf, h1);
              mma(tacc[jt + 1], rf, l1);
            }
          }
          float va = 0.f, vb = 0.f;  // dy (first term) or x (second) . tacc
#pragma unroll
          for (int jt = 0; jt < P / 8; ++jt) {
            float za[2] = {0.f, 0.f}, zb[2] = {0.f, 0.f};
            if (term == 0) {
              if (oka) ld2(a.dy + ya + 8 * jt, za[0], za[1]);
              if (okb) ld2(a.dy + yb + 8 * jt, zb[0], zb[1]);
            } else {
              const uint32_t wa = oka ? ld32(a.x + xa + 8 * jt) : 0u;
              const uint32_t wb = okb ? ld32(a.x + xb + 8 * jt) : 0u;
              za[0] = lo(wa);
              za[1] = hi(wa);
              zb[0] = lo(wb);
              zb[1] = hi(wb);
            }
            va += za[0] * tacc[jt][0] + za[1] * tacc[jt][1];
            vb += zb[0] * tacc[jt][2] + zb[1] * tacc[jt][3];
          }
          va = quad_sum(va);
          vb = quad_sum(vb);
          if (q4 == 0) {
            if (term == 0) {
              row_off[ia] = va * ex(css[ia]);
              row_off[ib] = vb * ex(css[ib]);
            } else {
              row_q[ia] = dts[ia] * ex(cs_end - css[ia]) * va;
              row_q[ib] = dts[ib] * ex(cs_end - css[ib]) * vb;
            }
          }
        }
      }
    }
    __syncthreads();
    stage_rows_split(zs, zl, Sh::kYld, a.dy + pos0 * hp + h * P, hp, Q, P,
                     valid, none);
    __syncthreads();
  }

  for (int r = 0; r < Sh::kTiles; r += 2 * Sh::kWarps) {
    for (int side = 0; side < 2; ++side) {
      const int tile = r + (side ? 2 * Sh::kWarps - 1 - warp : warp);
      if (tile >= Sh::kTiles) continue;  // the whole warp
      const int i0 = 16 * tile, ia = i0 + g, ib = ia + 8;
      const bool oka = ia < valid, okb = ib < valid;
      const size_t ya = (pos0 + ia) * hp + h * P + 2 * q4;  // y, dy, dx
      const size_t yb = (pos0 + ib) * hp + h * P + 2 * q4;
      // The rows of U as A fragments over n.
      uint32_t ua[N / 16][4];
      const uint16_t* u_a = U + (pos0 + ia) * a.bs + 2 * q4;
      const uint16_t* u_b = U + (pos0 + ib) * a.bs + 2 * q4;
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks) {
        ua[ks][0] = oka ? ld32(u_a + 16 * ks) : 0u;
        ua[ks][1] = okb ? ld32(u_b + 16 * ks) : 0u;
        ua[ks][2] = oka ? ld32(u_a + 16 * ks + 8) : 0u;
        ua[ks][3] = okb ? ld32(u_b + 16 * ks + 8) : 0u;
      }
      // The state's term: (U_i . st^T) times exp(cs_i) (forward) or
      // exp(cs_end - cs_i) (backward).
      float acc[P / 8][4] = {};
#pragma unroll
      for (int ks = 0; ks < N / 16; ++ks)
#pragma unroll
        for (int jt = 0; jt < P / 8; jt += 2) {
          const int off = 8 * jt * Sh::kHld + 16 * ks;
          uint32_t d[4];
          ldsm4<false>(hs + off, Sh::kHld, d);
          const uint32_t h0[2] = {d[0], d[2]}, h1[2] = {d[1], d[3]};
          ldsm4<false>(hl + off, Sh::kHld, d);
          const uint32_t l0[2] = {d[0], d[2]}, l1[2] = {d[1], d[3]};
          mma(acc[jt], ua[ks], h0);
          mma(acc[jt], ua[ks], l0);
          mma(acc[jt + 1], ua[ks], h1);
          mma(acc[jt + 1], ua[ks], l1);
        }
      const float fa = kFwd ? ex(css[ia]) : ex(cs_end - css[ia]);
      const float fb = kFwd ? ex(css[ib]) : ex(cs_end - css[ib]);
#pragma unroll
      for (int jt = 0; jt < P / 8; ++jt) {
        acc[jt][0] *= fa;
        acc[jt][1] *= fa;
        acc[jt][2] *= fb;
        acc[jt][3] *= fb;
      }
      // Backward: x at the lane's places (also the A fragments of x_i .
      // dy_j).
      uint32_t xr[P / 8][2];
      if (!kFwd) {
        const uint16_t* x_a = a.x + (pos0 + ia) * a.xs + h * P + 2 * q4;
        const uint16_t* x_b = a.x + (pos0 + ib) * a.xs + h * P + 2 * q4;
#pragma unroll
        for (int jt = 0; jt < P / 8; ++jt) {
          xr[jt][0] = oka ? ld32(x_a + 8 * jt) : 0u;
          xr[jt][1] = okb ? ld32(x_b + 8 * jt) : 0u;
        }
      }
      // Within the chunk, 32 columns at a time from the last: forward
      // j <= i, backward j >= i.
      const int j_lo = kFwd ? 0 : (i0 / Sh::kJB) * Sh::kJB;
      const int j_hi = kFwd ? ((i0 + 15) / Sh::kJB) * Sh::kJB : Q - Sh::kJB;
      float carry[2] = {0.f, 0.f};  // backward: sum_{t >= j0 + 32} P^T[i][t]
      for (int j0 = j_hi; j0 >= j_lo; j0 -= Sh::kJB) {
        float gacc[4][4];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int j = j0 + 8 * nt + 2 * q4;
          ld2(G + static_cast<size_t>(ia) * Q + j, gacc[nt][0], gacc[nt][1]);
          ld2(G + static_cast<size_t>(ib) * Q + j, gacc[nt][2], gacc[nt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = i0 + g + 8 * (e / 2);
            const int j = j0 + 8 * nt + 2 * q4 + e % 2;
            float w = 0.f;
            if (kFwd ? j <= i : j >= i)
              w = kFwd ? ex(css[i] - css[j]) * dts[j] : ex(css[j] - css[i]);
            gacc[nt][e] *= w;
          }
        if (!kFwd)
          da_block<P, Q, Sh::kYld>(gacc, xr, zs, dts, xw + warp * Q, carry,
                                   i0, j0);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          // This block's decays times C B^T (times dt forward) as hi and lo
          // parts, times x (exact in bf16) or dy (hi and lo; lo x lo left
          // out).
          uint32_t kh[4], kl[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float* v = gacc[2 * q + r / 2] + 2 * (r % 2);
            split(v[0], v[1], kh[r], kl[r]);
          }
#pragma unroll
          for (int jt = 0; jt < P / 8; jt += 2) {
            const int off = (j0 + 16 * q) * Sh::kYld + 8 * jt;
            uint32_t d[4];
            ldsm4<true>(zs + off, Sh::kYld, d);
            const uint32_t b0[2] = {d[0], d[1]}, b1[2] = {d[2], d[3]};
            mma(acc[jt], kh, b0);
            mma(acc[jt], kl, b0);
            mma(acc[jt + 1], kh, b1);
            mma(acc[jt + 1], kl, b1);
            if (!kFwd) {
              ldsm4<true>(zl + off, Sh::kYld, d);
              const uint32_t c0[2] = {d[0], d[1]}, c1[2] = {d[2], d[3]};
              mma(acc[jt], kh, c0);
              mma(acc[jt + 1], kh, c1);
            }
          }
        }
      }
      if (kFwd) {
#pragma unroll
        for (int jt = 0; jt < P / 8; ++jt) {
          if (oka) st2(a.y + ya + 8 * jt, acc[jt][0], acc[jt][1]);
          if (okb) st2(a.y + yb + 8 * jt, acc[jt][2], acc[jt][3]);
        }
      } else {
        // acc is dxd: x . dxd, and dx = dt dxd.
        const float dta = dts[ia], dtb = dts[ib];
        float dda = 0.f, ddb = 0.f;
#pragma unroll
        for (int jt = 0; jt < P / 8; ++jt) {
          dda += lo(xr[jt][0]) * acc[jt][0] + hi(xr[jt][0]) * acc[jt][1];
          ddb += lo(xr[jt][1]) * acc[jt][2] + hi(xr[jt][1]) * acc[jt][3];
          if (oka)
            *reinterpret_cast<uint32_t*>(a.dx + ya + 8 * jt) =
                pack(dta * acc[jt][0], dta * acc[jt][1]);
          if (okb)
            *reinterpret_cast<uint32_t*>(a.dx + yb + 8 * jt) =
                pack(dtb * acc[jt][2], dtb * acc[jt][3]);
        }
        dda = quad_sum(dda);
        ddb = quad_sum(ddb);
        if (q4 == 0) {
          row_dd[ia] = dda;
          row_dd[ib] = ddb;
        }
      }
    }
  }
  if (kFwd) return;

  // Backward: da over the chunk (the design note's four terms), then ddt
  // and dA's part.
  __syncthreads();
  if (warp != 0) return;
  constexpr int kPer = Q / 32;
  float dec = 0.f;
  for (int part = 0; part < a.parts; ++part)
    dec += a.ddec[bhk * a.parts + part];
  float off[kPer], pre[kPer], run = 0.f;
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int u = lane * kPer + m;
    off[m] = row_off[u];
    pre[m] = run;  // sum of row_q over the lane's positions before u
    run += row_q[u];
  }
#pragma unroll
  for (int m = kPer - 2; m >= 0; --m) off[m] += off[m + 1];
  const float off_incl = warp_suffix(off[0]);
  float off_after = __shfl_sync(kFull, off_incl, lane < 31 ? lane + 1 : 31);
  if (lane == 31) off_after = 0.f;
  const float q_incl = warp_prefix(run);
  float q_before = __shfl_sync(kFull, q_incl, lane ? lane - 1 : 0);
  if (lane == 0) q_before = 0.f;
  const float A = a.A[h];
  float dA = 0.f;
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int u = lane * kPer + m;
    float within = 0.f;
    for (int w = 0; w < Sh::kWarps; ++w) within += xw[w * Q + u];
    const float da = within + (off[m] + off_after) + (pre[m] + q_before) + dec;
    if (u < valid) a.ddt[(pos0 + u) * H + h] = row_dd[u] + A * da;
    dA += dts[u] * da;
  }
  dA = warp_sum(dA);
  if (lane == 0) a.dA[bhk] = dA;
}

template <int P, int N, int Q>
int launch_scan(bool fwd, const Args& a, int b, cudaStream_t stream) {
  const int c = (a.S + Q - 1) / Q;
  const size_t smem = fwd ? ScanShape<P, N, Q>::kFwdSmem
                           : ScanShape<P, N, Q>::kBwdSmem;
  auto kern = fwd ? &chunk_scan<P, N, Q, true> : &chunk_scan<P, N, Q, false>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.H, c, b), dim3(256), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ssd
}  // namespace rtt

// fwd 1 forward (y), 0 backward (dx, ddt, dA's parts). Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a shape without an instantiation).
extern "C" int ssd_scan_launch(int kernel, int fwd, RTT_SSD_ARGS) {
  using namespace rtt::ssd;
  Args a;
  RTT_SSD_FILL(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel != 0) return cudaErrorInvalidValue;
  if (P == 64 && N == 128 && Q == 256)
    return launch_scan<64, 128, 256>(fwd, a, b, s);
  if (P == 32 && N == 16 && Q == 64)
    return launch_scan<32, 16, 64>(fwd, a, b, s);
  return cudaErrorInvalidValue;
}
