// The Mamba-2 scan's gradients that are sums over the heads: of C B^T
// within each chunk (dG) and the state terms of dB and dC (see ssd.cuh for
// the layouts, what the kernels replace and what bounds them). Each block
// loops over the heads in order and keeps its sums in the warps'
// accumulators, so the same inputs give the same bits. Derived operands
// (dy, the weighted rows, the states) enter the products as bf16 hi and lo
// parts (the lo x lo product left out), near fp32.
//
// chunk_dg, one block a 64 x 64 tile (t, s) of a chunk's causal half, 4
// warps of 16 rows t:
//   dG[t][s] = sum_h dt_s exp(cs_t - cs_s) (dy_t . x_s), s <= t.
// The caller then adds dG B to dC and dG^T C to dB (two plain products).
//
// chunk_bc, one block 128 rows i of a chunk (the chunk if shorter), 8 warps
// of 16 rows:
//   dc: out_i[n] = sum_h exp(cs_i) sum_p dy_i[p] e[p][n], e the state
//       entering the chunk (C's gradient through the state);
//   db: out_i[n] = sum_h exp(cs_end - cs_i) dt_i sum_p x_i[p] g[p][n], g the
//       gradient of the state leaving the chunk (B's).
#include "ssd.cuh"

namespace rtt {
namespace ssd {

constexpr int kTile = 64;

template <int P>
struct DgShape {
  static constexpr int kXld = P + 8;
  static constexpr size_t kSmem = kTile * kXld * 2 + 3 * kTile * 4;
  static_assert(P % 16 == 0, "chunk_dg tiling");
};

template <int P, int Q>
__global__ void __launch_bounds__(128) chunk_dg(Args a) {
  using Sh = DgShape<P>;
  extern __shared__ uint4 smem_raw[];
  uint16_t* xs = reinterpret_cast<uint16_t*>(smem_raw);  // [kTile][kXld]
  float* dt_s = reinterpret_cast<float*>(xs + kTile * Sh::kXld);
  float* cs_s = dt_s + kTile;
  float* cs_t = cs_s + kTile;
  int si = blockIdx.x, ti = 0;  // the block's tile pair, si <= ti
  while (si > ti) si -= ++ti;
  const int k = blockIdx.y, b = blockIdx.z, c = gridDim.y;
  const int H = a.H, S = a.S;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q4 = lane % 4;
  const int t0 = k * Q, valid = min(Q, S - t0);
  const int tb = ti * kTile, sb = si * kTile;
  const size_t pos0 = static_cast<size_t>(b) * S + t0;
  const size_t hp = static_cast<size_t>(H) * P;
  const int ia = tb + 16 * warp + g, ib = ia + 8;  // the lane's rows t
  const bool oka = ia < valid, okb = ib < valid;
  float acc[kTile / 8][4] = {};
  for (int h = 0; h < H; ++h) {
    const size_t bhk = (static_cast<size_t>(b) * H + h) * c + k;
    stage_rows(xs, Sh::kXld, a.x + (pos0 + sb) * a.xs + h * P, a.xs, kTile,
               P, valid - sb);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      dt_s[i] = sb + i < valid ? a.dt[(pos0 + sb + i) * H + h] : 0.f;
      cs_s[i] = a.cs[bhk * Q + sb + i];
      cs_t[i] = a.cs[bhk * Q + tb + i];
    }
    // dy's rows t as A fragments over p, hi and lo parts.
    uint32_t dh[P / 16][4], dl[P / 16][4];
    const float* dy_a = a.dy + (pos0 + ia) * hp + h * P + 2 * q4;
    const float* dy_b = a.dy + (pos0 + ib) * hp + h * P + 2 * q4;
#pragma unroll
    for (int ks = 0; ks < P / 16; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float* p = (r % 2 ? dy_b : dy_a) + 16 * ks + 8 * (r / 2);
        float v0 = 0.f, v1 = 0.f;
        if (r % 2 ? okb : oka) ld2(p, v0, v1);
        split(v0, v1, dh[ks][r], dl[ks][r]);
      }
    __syncthreads();
    float sacc[kTile / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < P / 16; ++ks)
#pragma unroll
      for (int nt = 0; nt < kTile / 8; nt += 2) {
        uint32_t d[4];
        ldsm4<false>(xs + 8 * nt * Sh::kXld + 16 * ks, Sh::kXld, d);
        const uint32_t b0[2] = {d[0], d[2]}, b1[2] = {d[1], d[3]};
        mma(sacc[nt], dh[ks], b0);
        mma(sacc[nt], dl[ks], b0);
        mma(sacc[nt + 1], dh[ks], b1);
        mma(sacc[nt + 1], dl[ks], b1);
      }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 16 * warp + g + 8 * (e / 2);  // in the t tile
        const int j = 8 * nt + 2 * q4 + e % 2;      // in the s tile
        if (sb + j <= tb + i)
          acc[nt][e] += sacc[nt][e] * ex(cs_t[i] - cs_s[j]) * dt_s[j];
      }
    __syncthreads();
  }
  float* o = a.dG + (static_cast<size_t>(b) * c + k) * Q * Q;
#pragma unroll
  for (int nt = 0; nt < kTile / 8; ++nt) {
    const int s = sb + 8 * nt + 2 * q4;
    st2(o + static_cast<size_t>(ia) * Q + s, acc[nt][0], acc[nt][1]);
    st2(o + static_cast<size_t>(ib) * Q + s, acc[nt][2], acc[nt][3]);
  }
}

template <int P, int N, int Q>
struct BcShape {
  static constexpr int kRows = Q < 128 ? Q : 128, kMld = P + 8;
  static constexpr size_t kSmem = 2 * static_cast<size_t>(N) * kMld * 2;
  static_assert(P % 16 == 0 && N % 16 == 0 && Q % kRows == 0 &&
                    kRows % 16 == 0,
                "chunk_bc tiling");
};

template <int P, int N, int Q, bool kDC>
__global__ void __launch_bounds__(256) chunk_bc(Args a) {
  using Sh = BcShape<P, N, Q>;
  extern __shared__ uint4 smem_raw[];
  uint16_t* mt = reinterpret_cast<uint16_t*>(smem_raw);  // [2][N][kMld]
  const int k = blockIdx.y, b = blockIdx.z, c = gridDim.y;
  const int H = a.H, S = a.S;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q4 = lane % 4;
  const int t0 = k * Q, valid = min(Q, S - t0);
  const size_t pos0 = static_cast<size_t>(b) * S + t0;
  const bool live = 16 * warp < Sh::kRows;  // the whole warp
  const int ia = blockIdx.x * Sh::kRows + 16 * warp + g, ib = ia + 8;
  const bool oka = live && ia < valid, okb = live && ib < valid;
  const float* M = kDC ? a.ent : a.st;
  float acc[N / 8][4] = {};
  for (int h = 0; h < H; ++h) {
    const size_t bhk = (static_cast<size_t>(b) * H + h) * c + k;
    stage_transposed(mt, mt + N * Sh::kMld, Sh::kMld, M + bhk * P * N, N, P,
                     N, P);
    const float* cs = a.cs + bhk * Q;
    float fa = 0.f, fb = 0.f;
    if (kDC) {
      if (oka) fa = ex(cs[ia]);
      if (okb) fb = ex(cs[ib]);
    } else {
      if (oka) fa = ex(cs[Q - 1] - cs[ia]) * a.dt[(pos0 + ia) * H + h];
      if (okb) fb = ex(cs[Q - 1] - cs[ib]) * a.dt[(pos0 + ib) * H + h];
    }
    // The rows i of dy (dc) or x (db), times f_i, as A fragments over p,
    // hi and lo parts.
    uint32_t zh[P / 16][4], zl[P / 16][4];
#pragma unroll
    for (int ks = 0; ks < P / 16; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = r % 2 ? ib : ia, p = 16 * ks + 8 * (r / 2) + 2 * q4;
        const float f = r % 2 ? fb : fa;
        float v0 = 0.f, v1 = 0.f;
        if (r % 2 ? okb : oka) {
          if (kDC) {
            ld2(a.dy + ((pos0 + i) * H + h) * P + p, v0, v1);
          } else {
            const uint32_t w = ld32(a.x + (pos0 + i) * a.xs + h * P + p);
            v0 = lo(w);
            v1 = hi(w);
          }
        }
        split(f * v0, f * v1, zh[ks][r], zl[ks][r]);
      }
    __syncthreads();
    if (live) {
#pragma unroll
      for (int ks = 0; ks < P / 16; ++ks)
#pragma unroll
        for (int nt = 0; nt < N / 8; nt += 2) {
          uint32_t d[4];
          const uint16_t* mq = mt + 8 * nt * Sh::kMld + 16 * ks;
          ldsm4<false>(mq, Sh::kMld, d);
          const uint32_t h0[2] = {d[0], d[2]}, h1[2] = {d[1], d[3]};
          ldsm4<false>(mq + N * Sh::kMld, Sh::kMld, d);
          const uint32_t l0[2] = {d[0], d[2]}, l1[2] = {d[1], d[3]};
          mma(acc[nt], zh[ks], h0);
          mma(acc[nt], zh[ks], l0);
          mma(acc[nt], zl[ks], h0);
          mma(acc[nt + 1], zh[ks], h1);
          mma(acc[nt + 1], zh[ks], l1);
          mma(acc[nt + 1], zl[ks], h1);
        }
    }
    __syncthreads();
  }
  if (!live) return;
  float* o = a.out + (static_cast<size_t>(b) * c * Q + t0) * N;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
    const int n = 8 * nt + 2 * q4;
    st2(o + static_cast<size_t>(ia) * N + n, acc[nt][0], acc[nt][1]);
    st2(o + static_cast<size_t>(ib) * N + n, acc[nt][2], acc[nt][3]);
  }
}

template <int P, int N, int Q>
int launch_grad(int kernel, bool mode, const Args& a, int b,
                cudaStream_t stream) {
  const int c = (a.S + Q - 1) / Q;
  if (kernel == 0) {
    const size_t smem = DgShape<P>::kSmem;
    const int tiles = Q / kTile;
    auto kern = &chunk_dg<P, Q>;
    cudaError_t e = allow_smem(kern, smem);
    if (e != cudaSuccess) return e;
    kern<<<dim3(tiles * (tiles + 1) / 2, c, b), dim3(128), smem, stream>>>(a);
    return cudaGetLastError();
  }
  const size_t smem = BcShape<P, N, Q>::kSmem;
  const int blocks = Q / BcShape<P, N, Q>::kRows;
  auto kern = mode ? &chunk_bc<P, N, Q, true> : &chunk_bc<P, N, Q, false>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(blocks, c, b), dim3(256), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ssd
}  // namespace rtt

// kernel 0: chunk_dg; 1: chunk_bc, mode 1 dc, 0 db. Returns the launch's
// cudaError_t (cudaErrorInvalidValue for a shape without an
// instantiation).
extern "C" int ssd_grad_launch(int kernel, int mode, RTT_SSD_ARGS) {
  using namespace rtt::ssd;
  Args a;
  RTT_SSD_FILL(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 128 && Q == 256)
    return launch_grad<64, 128, 256>(kernel, mode, a, b, s);
  if (P == 32 && N == 16 && Q == 64)
    return launch_grad<32, 16, 64>(kernel, mode, a, b, s);
  return cudaErrorInvalidValue;
}
