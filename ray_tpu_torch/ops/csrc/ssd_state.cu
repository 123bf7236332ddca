// The Mamba-2 scan's chunk states and the pass that carries them across
// chunks (see ssd.cuh for the layouts, what the kernels replace and what
// bounds them).
//
// chunk_state, one block a (head, chunk, batch row), 4 warps:
//   forward:  cs_t = sum_{u <= t} dt_u A over the chunk (written to cs),
//             st[p][n] = sum_s exp(cs_end - cs_s) dt_s x_s[p] B_s[n];
//   backward: st[p][n] = sum_t exp(cs_t) dy_t[p] C_t[n] (cs read).
// The weighted rows are staged 64 positions at a time as two bf16 parts
// (hi, and lo the rest: the states feed dA's sums, where one rounding
// moves it by ~0.1%), each part's product taken on the tensor cores, and
// the [P, N] fp32 sum stays in the warps' accumulators.
//
// state_pass, one block a 512-element slice of a (head, batch row)'s
// states, sequential over the chunks (the one pass along S):
//   forward:  st_k <- e_k, the state entering chunk k: e_0 = 0,
//             e_{k+1} = exp(cs_end_k) e_k + st_k;
//   backward: st_k <- g_{k+1}, the gradient of the state leaving chunk k:
//             g_c = 0, g_k = exp(cs_end_k) g_{k+1} + st_k; and ddec[k] the
//             slice's part of exp(cs_end_k) <g_{k+1}, e_k>, the gradient of
//             the chunk's total decay through the carried state (the parts
//             summed in a fixed order by chunk_scan's backward).
#include "ssd.cuh"

namespace rtt {
namespace ssd {

template <int P, int N, int Q>
struct StateShape {
  static constexpr int kSlab = Q < 64 ? Q : 64;  // positions staged at once
  static constexpr int kRowTiles = P / 16;        // warps along p
  static constexpr int kColGroups = 4 / kRowTiles;
  static constexpr int kCols = N / kColGroups;    // n columns a warp
  static constexpr int kTilesN = kCols / 8;
  static constexpr int kZld = P + 8, kVld = N + 8;
  static constexpr size_t kSmem = 2 * Q * 4 + kSlab * (2 * kZld + kVld) * 2;
  static_assert(P % 16 == 0 && 4 % kRowTiles == 0 && kCols % 8 == 0 &&
                    Q % 32 == 0 && Q % kSlab == 0 && N % 8 == 0,
                "chunk_state tiling");
};

template <int P, int N, int Q, bool kFwd>
__global__ void __launch_bounds__(128) chunk_state(Args a) {
  using Sh = StateShape<P, N, Q>;
  extern __shared__ uint4 smem_raw[];
  float* css = reinterpret_cast<float*>(smem_raw);  // [Q]
  float* wt = css + Q;                               // [Q]
  uint16_t* zs = reinterpret_cast<uint16_t*>(wt + Q);  // [2][kSlab][kZld]
  uint16_t* vs = zs + 2 * Sh::kSlab * Sh::kZld;        // [kSlab][kVld]
  const int h = blockIdx.x, k = blockIdx.y, b = blockIdx.z, c = gridDim.y;
  const int H = a.H, S = a.S;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q4 = lane % 4;
  const int t0 = k * Q, valid = min(Q, S - t0);
  const size_t bhk = (static_cast<size_t>(b) * H + h) * c + k;
  const size_t pos0 = static_cast<size_t>(b) * S + t0;
  float* cs = a.cs + bhk * Q;

  if (kFwd) {
    if (warp == 0) {  // the cumulative sum, Q / 32 positions a lane
      constexpr int kPer = Q / 32;
      const float A = a.A[h];
      float pre[kPer], run = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int t = lane * kPer + i;
        const float d = t < valid ? a.dt[(pos0 + t) * H + h] : 0.f;
        wt[t] = d;
        run += d * A;
        pre[i] = run;
      }
      const float incl = warp_prefix(run);
      float before = __shfl_sync(kFull, incl, lane ? lane - 1 : 0);
      if (lane == 0) before = 0.f;
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        css[lane * kPer + i] = before + pre[i];
        cs[lane * kPer + i] = before + pre[i];
      }
    }
  } else {
    for (int i = threadIdx.x; i < Q; i += blockDim.x) css[i] = cs[i];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < Q; i += blockDim.x)
    wt[i] = kFwd ? ex(css[Q - 1] - css[i]) * wt[i] : ex(css[i]);
  __syncthreads();

  // The warp's tile of st: rows p0.., columns n0..
  const int p0 = 16 * (warp % Sh::kRowTiles);
  const int n0 = (warp / Sh::kRowTiles) * Sh::kCols;
  const uint16_t* V = kFwd ? a.B : a.C;
  float acc[Sh::kTilesN][4] = {};
  for (int s0 = 0; s0 < Q; s0 += Sh::kSlab) {
    uint16_t* zl = zs + Sh::kSlab * Sh::kZld;
    if (kFwd)
      stage_rows_split(zs, zl, Sh::kZld, a.x + (pos0 + s0) * a.xs + h * P,
                       a.xs, Sh::kSlab, P, valid - s0, wt + s0);
    else
      stage_rows_split(zs, zl, Sh::kZld, a.dy + ((pos0 + s0) * H + h) * P,
                       static_cast<size_t>(H) * P, Sh::kSlab, P, valid - s0,
                       wt + s0);
    stage_rows(vs, Sh::kVld, V + (pos0 + s0) * a.bs, a.bs, Sh::kSlab, N,
               valid - s0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < Sh::kSlab; kk += 16) {
      // A = z^T (rows p, columns s), B = V (rows s, columns n), both
      // stored with s as the row.
      uint32_t d[4];
      ldsm4<true>(zs + kk * Sh::kZld + p0, Sh::kZld, d);
      const uint32_t ah[4] = {d[0], d[2], d[1], d[3]};
      ldsm4<true>(zs + (Sh::kSlab + kk) * Sh::kZld + p0, Sh::kZld, d);
      const uint32_t al[4] = {d[0], d[2], d[1], d[3]};
#pragma unroll
      for (int j = 0; j + 1 < Sh::kTilesN; j += 2) {
        ldsm4<true>(vs + kk * Sh::kVld + n0 + 8 * j, Sh::kVld, d);
        const uint32_t b0[2] = {d[0], d[1]}, b1[2] = {d[2], d[3]};
        mma(acc[j], ah, b0);
        mma(acc[j], al, b0);
        mma(acc[j + 1], ah, b1);
        mma(acc[j + 1], al, b1);
      }
      if (Sh::kTilesN % 2) {  // the last tile alone
        const int j = Sh::kTilesN - 1;
        const uint16_t* v0 = vs + (kk + 2 * q4) * Sh::kVld + n0 + 8 * j + g;
        const uint32_t bf[2] = {pair(v0[0], v0[Sh::kVld]),
                                pair(v0[8 * Sh::kVld], v0[9 * Sh::kVld])};
        mma(acc[j], ah, bf);
        mma(acc[j], al, bf);
      }
    }
    __syncthreads();
  }
  float* o = a.st + bhk * P * N;
#pragma unroll
  for (int j = 0; j < Sh::kTilesN; ++j) {
    const int n = n0 + 8 * j + 2 * q4;
    st2(o + (p0 + g) * N + n, acc[j][0], acc[j][1]);
    st2(o + (p0 + g + 8) * N + n, acc[j][2], acc[j][3]);
  }
}

// Four consecutive elements of a (head, batch row)'s states a thread; the
// next chunk's values are loaded before this chunk's are stored, so that a
// load is always in flight.
template <bool kFwd>
__global__ void __launch_bounds__(128) state_pass(Args a, int PN, int Q) {
  extern __shared__ uint4 smem_raw[];
  float* red = reinterpret_cast<float*>(smem_raw);  // [4]
  const int h = blockIdx.y, b = blockIdx.z, c = (a.S + Q - 1) / Q;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const size_t bh = static_cast<size_t>(b) * a.H + h;
  const int e0 = (blockIdx.x * 128 + threadIdx.x) * 4;
  float v[4] = {0.f, 0.f, 0.f, 0.f};
  float s[4], e[4] = {0.f, 0.f, 0.f, 0.f}, dcy;
  int k = kFwd ? 0 : c - 1;
  {
    const float* p = a.st + (bh * c + k) * PN + e0;
    const float* q = a.ent + (bh * c + k) * PN + e0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      s[i] = p[i];
      if (!kFwd) e[i] = q[i];
    }
    dcy = ex(a.cs[(bh * c + k) * Q + Q - 1]);
  }
  for (int step = 0; step < c; ++step) {
    const int kn = kFwd ? k + 1 : k - 1;
    float sn[4] = {0.f, 0.f, 0.f, 0.f}, en[4] = {0.f, 0.f, 0.f, 0.f};
    float dn = 0.f;
    if (step + 1 < c) {
      const float* p = a.st + (bh * c + kn) * PN + e0;
      const float* q = a.ent + (bh * c + kn) * PN + e0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        sn[i] = p[i];
        if (!kFwd) en[i] = q[i];
      }
      dn = ex(a.cs[(bh * c + kn) * Q + Q - 1]);
    }
    if (!kFwd) {
      float d = v[0] * e[0] + v[1] * e[1] + v[2] * e[2] + v[3] * e[3];
      d = warp_sum(d);
      if (lane == 0) red[warp] = d;
      __syncthreads();
      if (threadIdx.x == 0)
        a.ddec[(bh * c + k) * gridDim.x + blockIdx.x] =
            dcy * (((red[0] + red[1]) + red[2]) + red[3]);
      __syncthreads();
    }
    float* p = a.st + (bh * c + k) * PN + e0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      p[i] = v[i];
      v[i] = dcy * v[i] + s[i];
      s[i] = sn[i];
      e[i] = en[i];
    }
    dcy = dn;
    k = kn;
  }
}

template <int P, int N, int Q>
int launch_state(bool fwd, const Args& a, int b, cudaStream_t stream) {
  const int c = (a.S + Q - 1) / Q;
  const size_t smem = StateShape<P, N, Q>::kSmem;
  auto kern = fwd ? &chunk_state<P, N, Q, true> : &chunk_state<P, N, Q, false>;
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<dim3(a.H, c, b), dim3(128), smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace ssd
}  // namespace rtt

// kernel 0: chunk_state, 1: state_pass; fwd 1 forward, 0 backward. Returns
// the launch's cudaError_t (cudaErrorInvalidValue for a shape without an
// instantiation).
extern "C" int ssd_state_launch(int kernel, int fwd, RTT_SSD_ARGS) {
  using namespace rtt::ssd;
  Args a;
  RTT_SSD_FILL(a);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 1) {
    const int PN = P * N;
    if (PN % 512 != 0) return cudaErrorInvalidValue;
    auto kern = fwd ? &state_pass<true> : &state_pass<false>;
    kern<<<dim3(PN / 512, H, b), dim3(128), 16, s>>>(a, PN, Q);
    return cudaGetLastError();
  }
  if (P == 64 && N == 128 && Q == 256)
    return launch_state<64, 128, 256>(fwd, a, b, s);
  if (P == 32 && N == 16 && Q == 64)
    return launch_state<32, 16, 64>(fwd, a, b, s);
  return cudaErrorInvalidValue;
}
