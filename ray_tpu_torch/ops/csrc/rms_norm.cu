// RMSNorm over the last dimension of a [rows, d] input, in two forms that
// share one forward kernel (rms_fwd) and one backward (rms_bwd: a kernel
// over the rows, then a fixed-order sum of its per-block column partials):
//   - plain: out = x * rsqrt(mean(x^2) + eps) * scale;
//   - gated, Mamba-2's, with its skip: u = (y + D[head] * x) * silu(z), then
//     out = u * rsqrt(mean(u^2) + eps) * scale, where y is the scan's fp32
//     output, x the scan's input and z the gate; x and z are read in place
//     at their own row strides (the splits of the mixer's projections).
// Everything is computed in fp32 and the output rounded once to the
// input's (plain) or the gate's (gated) type.
//
// It replaces no TPU kernel. The JAX package's rms_norm
// (ray_tpu/models/common.py) is plain jnp that XLA fuses into one pass;
// PyTorch runs the same composite eagerly: ~7 passes forward and ~15
// backward over fp32 copies of [rows, d] for the plain form, ~10 and ~30 of
// fp32 [rows, 8192] for the gated one in a Granite layer. Normalisation does
// a few operations a byte, far below the H100's ~295, so it is bound by
// bytes, and the design moves each byte once:
//   - A row lives with a group of up to 512 threads, 16 elements a
//     thread, so d up to 8192 without staging the row in shared memory:
//     forward in registers, two blocks an SM; backward one block an SM
//     looping over rows. Loads and stores are 16-byte vectors where d, the
//     head size and every pointer and row stride allow, else element by
//     element.
//   - The forward reads its inputs once and writes the output and the
//     row's fp32 rstd once; nothing intermediate goes to memory.
//   - The backward reads the inputs, the output's gradient and rstd from
//     memory once, makes u again, and writes each input's gradient once
//     (the scan's y in fp32, x and z in their type). A row stays in
//     registers across its sum (128 a thread; the gated form's 16 elements
//     of four inputs spill a few words), and the block asks L2 for the
//     next row's inputs before it works on this one's, so that one block
//     an SM keeps memory busy. A thread's columns are the same in every
//     row, so it sums dout * u * rstd for dscale in fp32 in shared memory,
//     and in the gated form ds * x for D (ds = du * silu(z)) a vector at a
//     time in registers (a vector never crosses a head); the block adds
//     its groups' sums in group order and writes one partial row, the
//     gated form also its heads' sums; a second kernel adds the partial
//     rows in a fixed order. No atomics: the same inputs on the same card
//     give the same bits.
//   - Threads a row and the vector width follow d, the head size, the
//     dtype and the alignment (the wrapper's plan, ray_tpu_torch/ops/
//     norm.py); no model is named here.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace rtt {
namespace rms {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFwdThreads = 512;   // a forward block; a row's group 32-512
constexpr int kBwdThreads = 512;   // a backward block; a row's group 32-512
constexpr int kFwdElems = 16;      // elements of a row a thread holds forward
constexpr int kBwdElems = 16;      // and backward
constexpr int kSumThreads = 512;   // the column sums: 32 columns x 16 slices
constexpr int kSlices = kSumThreads / 32;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// V consecutive elements, loaded and stored as 16-byte accesses (one, or
// two for 8 floats) or as one smaller access.
template <typename T, int V>
struct alignas(sizeof(T) * V > 16 ? 16 : sizeof(T) * V) Pack {
  T v[V];
};

// The sum of v over the row's threads, the same bits in each: a butterfly
// in each warp, then the row's warps in order through ``red`` (a float a
// warp of the block). Every thread of the block calls it.
__device__ __forceinline__ float row_sum(float v, float* red, int row_warps) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  if (row_warps == 1) return v;
  const int warp = threadIdx.x / 32;
  const int first = warp - warp % row_warps;
  __syncthreads();  // the last reads of red are done
  if (threadIdx.x % 32 == 0) red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < row_warps; ++w) s += red[first + w];
  return s;
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}

// The pointers of a call, with x's and z's row strides in elements (the
// gated form's; y, the output and the gradients are contiguous rows of d).
// Plain: x is the input and the gated fields are null.
template <typename T, typename P>
struct Args {
  const T* x;
  const float* y;
  const P* D;
  const T* z;
  const P* scale;
  const float* rstd_in;  // backward
  const T* dout;         // backward
  T* out;                // forward: the output; backward: dx
  float* rstd;           // forward
  float* dy;             // gated backward
  T* dz;                 // gated backward
  float* partial;        // backward: [blocks, d] then [blocks, heads]
  int rows, d, head_dim, x_stride, z_stride, row_threads;
  float eps;
};

// A vector of a row's inputs: x, and (gated) y and z.
template <typename T, int V>
struct Loaded {
  Pack<T, V> x;
  Pack<float, V> y;
  Pack<T, V> z;
};

template <bool kGated, typename T, typename P, int V>
__device__ __forceinline__ void load(const Args<T, P>& a, size_t row, int j,
                                     Loaded<T, V>& in) {
  in.x = reinterpret_cast<const Pack<T, V>*>(
      a.x + row * static_cast<size_t>(a.x_stride))[j];
  if (kGated) {
    in.y = reinterpret_cast<const Pack<float, V>*>(
        a.y + row * static_cast<size_t>(a.d))[j];
    in.z = reinterpret_cast<const Pack<T, V>*>(
        a.z + row * static_cast<size_t>(a.z_stride))[j];
  }
}

// u of element k of a loaded vector in fp32: x (plain), or (y + D x)
// silu(z) (gated), ``dk`` being D of the vector's head.
template <bool kGated, typename T, int V>
__device__ __forceinline__ float u_of(const Loaded<T, V>& in, int k,
                                      float dk) {
  const float xf = to_f(in.x.v[k]);
  if (!kGated) return xf;
  const float zf = to_f(in.z.v[k]);
  return (in.y.v[k] + dk * xf) * (zf * sigmoid(zf));
}

// D of the head of vector j (gated; 0 plain).
template <bool kGated, int V, typename T, typename P>
__device__ __forceinline__ float head_d(const Args<T, P>& a, int j) {
  return kGated ? to_f(a.D[j * V / a.head_dim]) : 0.f;
}

// One row a group of row_threads threads; thread t holds vectors t,
// t + row_threads, ... of the row.
template <typename T, typename P, int V, bool kGated>
__global__ void __launch_bounds__(kFwdThreads, 2) rms_fwd(Args<T, P> a) {
  constexpr int kSlots = kFwdElems / V;
  extern __shared__ float smem[];
  const int t = threadIdx.x % a.row_threads;
  const int row = blockIdx.x * (blockDim.x / a.row_threads) +
                  threadIdx.x / a.row_threads;
  const bool live = row < a.rows;
  const int nvec = a.d / V;
  const size_t r = live ? row : 0;
  float u[kSlots][V];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int j = t + i * a.row_threads;
    if (live && j < nvec) {
      Loaded<T, V> in;
      load<kGated>(a, r, j, in);
      const float dk = head_d<kGated, V>(a, j);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        u[i][k] = u_of<kGated>(in, k, dk);
        ss += u[i][k] * u[i][k];
      }
    }
  }
  const float sum = row_sum(ss, smem, a.row_threads / 32);
  const float rs = 1.f / sqrtf(sum / a.d + a.eps);
  if (!live) return;
  auto* o = reinterpret_cast<Pack<T, V>*>(a.out + r * a.d);
  const auto* g = reinterpret_cast<const Pack<P, V>*>(a.scale);
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int j = t + i * a.row_threads;
    if (j < nvec) {
      const Pack<P, V> gv = g[j];
      Pack<T, V> ov;
#pragma unroll
      for (int k = 0; k < V; ++k)
        ov.v[k] = from_f<T>(u[i][k] * rs * to_f(gv.v[k]));
      o[j] = ov;
    }
  }
  if (t == 0) a.rstd[row] = rs;
}

// Asks L2 for the line of p, ahead of its load (a no-op in a host build).
__device__ __forceinline__ void prefetch_l2(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#endif
}

// Rows a backward block asks L2 for ahead of the one it works on.
constexpr int kAhead = 1;

// Rows blockIdx.x * groups + group, then every gridDim.x * groups rows.
// With a = dout scale: du = rstd (a - u rstd^2 mean(a u)); plain dx = du;
// gated ds = du silu(z), dy = ds, dx = D ds, dz = du s silu'(z) with
// s = y + D x. One block an SM works on one row a group at a time, so it
// asks L2 for its next row's inputs before it works on this one's: their
// bytes stream from memory meanwhile. The block's sums of dout u rstd a
// column go to partial [gridDim.x, d], and (gated) of ds x a head to
// [gridDim.x, heads] after. A thread's column sums live in shared memory,
// its element e of each group at acc[(group * kBwdElems + e) * rt + t],
// so that a warp's threads touch neighbouring words.
template <typename T, typename P, int V, bool kGated>
__global__ void __launch_bounds__(kBwdThreads, 1) rms_bwd(Args<T, P> a) {
  constexpr int kSlots = kBwdElems / V;
  extern __shared__ float smem[];
  float* acc = smem + kBwdThreads / 32;  // kBwdThreads * kBwdElems floats
  const int rt = a.row_threads;
  const int t = threadIdx.x % rt;
  const int group = threadIdx.x / rt;
  const int groups = blockDim.x / rt;
  const int stride = gridDim.x * groups;
  const int nvec = a.d / V;
  const int row_warps = rt / 32;
  float* mine = acc + group * kBwdElems * rt + t;  // element e at e * rt
  const auto* gp = reinterpret_cast<const Pack<P, V>*>(a.scale);
  float dk[kSlots], acc_d[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int j = t + i * rt;
    dk[i] = j < nvec ? head_d<kGated, V>(a, j) : 0.f;
    acc_d[i] = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) mine[(i * V + k) * rt] = 0.f;
  }
  const int iters = (a.rows + stride - 1) / stride;
  for (int it = 0; it < iters; ++it) {
    const int row = blockIdx.x * groups + group + it * stride;
    const bool live = row < a.rows;
    const size_t r = live ? row : 0;
    const auto* dor = reinterpret_cast<const Pack<T, V>*>(a.dout + r * a.d);
    Loaded<T, V> in[kSlots];
    Pack<T, V> dv[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int j = t + i * rt;
      if (live && j < nvec) {
        load<kGated>(a, r, j, in[i]);
        dv[i] = dor[j];
      }
    }
    const size_t next = static_cast<size_t>(row) + kAhead * stride;
    if (next < static_cast<size_t>(a.rows)) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int j = t + i * rt;
        if (j < nvec) {
          prefetch_l2(a.x + next * a.x_stride + j * V);
          prefetch_l2(a.dout + next * a.d + j * V);
          if (kGated) {
            prefetch_l2(a.y + next * a.d + j * V);
            prefetch_l2(a.z + next * a.z_stride + j * V);
          }
        }
      }
    }
    const float rs = live ? a.rstd_in[row] : 0.f;
    Pack<P, V> gv[kSlots];
    float sau = 0.f;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int j = t + i * rt;
      if (live && j < nvec) {
        gv[i] = gp[j];
#pragma unroll
        for (int k = 0; k < V; ++k)
          sau += to_f(dv[i].v[k]) * to_f(gv[i].v[k]) *
                 u_of<kGated>(in[i], k, dk[i]);
      }
    }
    sau = row_sum(sau, smem, row_warps);
    if (!live) continue;
    const float c = rs * rs * (sau / a.d);
    auto* dxr = reinterpret_cast<Pack<T, V>*>(a.out + r * a.d);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int j = t + i * rt;
      if (j < nvec) {
        Pack<T, V> dxv;
        Pack<float, V> dyv;
        Pack<T, V> dzv;
        const Loaded<T, V>& q = in[i];
        const Pack<T, V>& dq = dv[i];
        const Pack<P, V>& gq = gv[i];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xf = to_f(q.x.v[k]);
          const float dof = to_f(dq.v[k]);
          const float av = dof * to_f(gq.v[k]);
          float* cell = mine + (i * V + k) * rt;
          if (!kGated) {
            const float du = rs * (av - xf * c);
            *cell += dof * (xf * rs);
            dxv.v[k] = from_f<T>(du);
          } else {
            const float zf = to_f(q.z.v[k]);
            const float sg = sigmoid(zf);
            const float gate = zf * sg;
            const float s = q.y.v[k] + dk[i] * xf;
            const float u = s * gate;
            const float du = rs * (av - u * c);
            const float ds = du * gate;
            *cell += dof * (u * rs);
            acc_d[i] += ds * xf;
            dyv.v[k] = ds;
            dxv.v[k] = from_f<T>(ds * dk[i]);
            dzv.v[k] = from_f<T>(du * s * (sg * (1.f + zf * (1.f - sg))));
          }
        }
        dxr[j] = dxv;
        if (kGated) {
          reinterpret_cast<Pack<float, V>*>(a.dy + r * a.d)[j] = dyv;
          reinterpret_cast<Pack<T, V>*>(a.dz + r * a.d)[j] = dzv;
        }
      }
    }
  }
  __syncthreads();
  // The block's column sums: its groups' in group order.
  float* pg = a.partial + static_cast<size_t>(blockIdx.x) * a.d;
  for (int col = threadIdx.x; col < a.d; col += blockDim.x) {
    const int j = col / V, e = (j / rt) * V + col % V;
    const float* cell = acc + e * rt + j % rt;
    float sum = 0.f;
    for (int g = 0; g < groups; ++g) sum += cell[g * kBwdElems * rt];
    pg[col] = sum;
  }
  if (!kGated) return;
  // D's: each vector's groups in group order, then each head's vectors in
  // order.
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int j = t + i * rt;
    if (j < nvec) acc[group * nvec + j] = acc_d[i];
  }
  __syncthreads();
  const int heads = a.d / a.head_dim, per_head = a.head_dim / V;
  float* pd = a.partial + static_cast<size_t>(gridDim.x) * a.d +
              static_cast<size_t>(blockIdx.x) * heads;
  for (int h = threadIdx.x; h < heads; h += blockDim.x) {
    float sum = 0.f;
    for (int j = h * per_head; j < (h + 1) * per_head; ++j) {
      float vsum = 0.f;
      for (int g = 0; g < groups; ++g) vsum += acc[g * nvec + j];
      sum += vsum;
    }
    pd[h] = sum;
  }
}

// dscale (blockIdx.y 0: d columns) or dD (1: heads columns): the ``blocks``
// partial rows summed in a fixed order (slice by slice, then the slices in
// turn), rounded once.
template <typename P>
__global__ void __launch_bounds__(kSumThreads)
    rms_bwd_cols(const float* partial, int blocks, int d, int heads,
                 P* dscale, P* dD) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % 32, slice = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const int n = blockIdx.y ? heads : d;
  const float* src =
      partial + (blockIdx.y ? static_cast<size_t>(blocks) * d : 0);
  float s = 0.f;
  if (c < n)
    for (int b = slice; b < blocks; b += kSlices)
      s += src[static_cast<size_t>(b) * n + c];
  smem[slice * 32 + lane] = s;
  __syncthreads();
  if (slice == 0 && c < n) {
    float total = 0.f;
    for (int k = 0; k < kSlices; ++k) total += smem[k * 32 + lane];
    (blockIdx.y ? dD : dscale)[c] = from_f<P>(total);
  }
}

template <typename Kernel, typename... Args_>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, Args_... args) {
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Whether the plan (vec, row_threads) covers a row of d with ``elems``
// elements a thread and at most ``max_threads`` threads, and (gated) whole
// vectors a head.
inline bool plan_ok(int rows, int d, int head_dim, int row_threads, int vec,
                    int max_vec, int elems, int max_threads) {
  return rows > 0 && d > 0 && head_dim > 0 && d % head_dim == 0 &&
         (vec == 1 || vec == max_vec) && head_dim % vec == 0 &&
         row_threads % 32 == 0 && row_threads >= 32 &&
         row_threads <= max_threads && d / vec <= (elems / vec) * row_threads;
}

template <typename T, typename P, bool kGated>
int fwd(const Args<T, P>& a, int vec, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (!plan_ok(a.rows, a.d, a.head_dim, a.row_threads, vec, kVec, kFwdElems,
               kFwdThreads))
    return cudaErrorInvalidValue;
  const int groups = kFwdThreads / a.row_threads;
  const dim3 grid((a.rows + groups - 1) / groups);
  const int threads = groups * a.row_threads;
  const size_t smem = kFwdThreads / 32 * sizeof(float);
  if (vec == 1)
    return launch(rms_fwd<T, P, 1, kGated>, grid, threads, smem, stream, a);
  return launch(rms_fwd<T, P, kVec, kGated>, grid, threads, smem, stream, a);
}

template <typename T, typename P, bool kGated>
int bwd(const Args<T, P>& a, int vec, int blocks, void* dscale, void* dD,
        cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (!plan_ok(a.rows, a.d, a.head_dim, a.row_threads, vec, kVec, kBwdElems,
               kBwdThreads) ||
      blocks < 1)
    return cudaErrorInvalidValue;
  const int threads = kBwdThreads / a.row_threads * a.row_threads;
  const size_t smem =
      (kBwdThreads / 32 + kBwdThreads * kBwdElems) * sizeof(float);
  const int err =
      vec == 1 ? launch(rms_bwd<T, P, 1, kGated>, dim3(blocks), threads, smem,
                        stream, a)
               : launch(rms_bwd<T, P, kVec, kGated>, dim3(blocks), threads,
                        smem, stream, a);
  if (err != 0) return err;
  const int heads = kGated ? a.d / a.head_dim : 0;
  const int widest = a.d > heads ? a.d : heads;
  const dim3 grid((widest + 31) / 32, kGated ? 2 : 1);
  const size_t sum_smem = kSumThreads * sizeof(float);
  return launch(rms_bwd_cols<P>, grid, kSumThreads, sum_smem, stream,
                static_cast<const float*>(a.partial), blocks, a.d, heads,
                static_cast<P*>(dscale), static_cast<P*>(dD));
}

template <typename T, typename P>
int plain_fwd(const void* x, const void* scale, void* out, float* rstd,
              int rows, int d, int row_threads, int vec, float eps,
              cudaStream_t stream) {
  Args<T, P> a{};
  a.x = static_cast<const T*>(x);
  a.scale = static_cast<const P*>(scale);
  a.out = static_cast<T*>(out);
  a.rstd = rstd;
  a.rows = rows, a.d = d, a.head_dim = d, a.x_stride = d;
  a.row_threads = row_threads, a.eps = eps;
  return fwd<T, P, false>(a, vec, stream);
}

template <typename T, typename P>
int plain_bwd(const void* dout, const void* x, const void* scale,
              const float* rstd, void* dx, float* partial, void* dscale,
              int rows, int d, int row_threads, int vec, int blocks,
              cudaStream_t stream) {
  Args<T, P> a{};
  a.dout = static_cast<const T*>(dout);
  a.x = static_cast<const T*>(x);
  a.scale = static_cast<const P*>(scale);
  a.rstd_in = rstd;
  a.out = static_cast<T*>(dx);
  a.partial = partial;
  a.rows = rows, a.d = d, a.head_dim = d, a.x_stride = d;
  a.row_threads = row_threads;
  return bwd<T, P, false>(a, vec, blocks, dscale, nullptr, stream);
}

template <typename T, typename P>
Args<T, P> gated_args(const float* y, const void* x, const void* D,
                      const void* z, const void* scale, int rows, int d,
                      int head_dim, int x_stride, int z_stride,
                      int row_threads) {
  Args<T, P> a{};
  a.y = y;
  a.x = static_cast<const T*>(x);
  a.D = static_cast<const P*>(D);
  a.z = static_cast<const T*>(z);
  a.scale = static_cast<const P*>(scale);
  a.rows = rows, a.d = d, a.head_dim = head_dim;
  a.x_stride = x_stride, a.z_stride = z_stride, a.row_threads = row_threads;
  return a;
}

template <typename T, typename P>
int gated_fwd(const float* y, const void* x, const void* D, const void* z,
              const void* scale, void* out, float* rstd, int rows, int d,
              int head_dim, int x_stride, int z_stride, int row_threads,
              int vec, float eps, cudaStream_t stream) {
  Args<T, P> a = gated_args<T, P>(y, x, D, z, scale, rows, d, head_dim,
                                  x_stride, z_stride, row_threads);
  a.out = static_cast<T*>(out);
  a.rstd = rstd;
  a.eps = eps;
  return fwd<T, P, true>(a, vec, stream);
}

template <typename T, typename P>
int gated_bwd(const void* dout, const float* y, const void* x, const void* D,
              const void* z, const void* scale, const float* rstd, float* dy,
              void* dx, void* dz, float* partial, void* dD, void* dscale,
              int rows, int d, int head_dim, int x_stride, int z_stride,
              int row_threads, int vec, int blocks, cudaStream_t stream) {
  Args<T, P> a = gated_args<T, P>(y, x, D, z, scale, rows, d, head_dim,
                                  x_stride, z_stride, row_threads);
  a.dout = static_cast<const T*>(dout);
  a.rstd_in = rstd;
  a.out = static_cast<T*>(dx);
  a.dy = dy;
  a.dz = static_cast<T*>(dz);
  a.partial = partial;
  return bwd<T, P, true>(a, vec, blocks, dscale, dD, stream);
}

}  // namespace rms
}  // namespace rtt

// Types: 0 fp32, 1 bf16, 2 fp16; the parameters' type is the input's or
// fp32.
#define RTT_RMS_DISPATCH(x_type, p_type, FN, ...)            \
  switch ((x_type) * 3 + (p_type)) {                         \
    case 0:                                                  \
      return FN<float, float>(__VA_ARGS__);                  \
    case 3:                                                  \
      return FN<__nv_bfloat16, float>(__VA_ARGS__);          \
    case 4:                                                  \
      return FN<__nv_bfloat16, __nv_bfloat16>(__VA_ARGS__);  \
    case 6:                                                  \
      return FN<__half, float>(__VA_ARGS__);                 \
    case 8:                                                  \
      return FN<__half, __half>(__VA_ARGS__);                \
    default:                                                 \
      return cudaErrorInvalidValue;                          \
  }

// out [rows, d] in x's type and rstd fp32 [rows], x contiguous; ``vec``
// elements a load (16 bytes' worth, or 1) and ``row_threads`` threads a row.
extern "C" int rms_norm_fwd(const void* x, const void* scale, void* out,
                            float* rstd, int rows, int d, int row_threads,
                            int vec, float eps, int x_type, int p_type,
                            void* stream) {
  using namespace rtt::rms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RTT_RMS_DISPATCH(x_type, p_type, plain_fwd, x, scale, out, rstd, rows, d,
                   row_threads, vec, eps, s);
}

// dx [rows, d] in x's type and dscale [d] in the parameters' type;
// ``partial`` is fp32 scratch [blocks, d], ``blocks`` the rows kernel's
// grid.
extern "C" int rms_norm_bwd(const void* dout, const void* x,
                            const void* scale, const float* rstd, void* dx,
                            float* partial, void* dscale, int rows, int d,
                            int row_threads, int vec, int blocks, int x_type,
                            int p_type, void* stream) {
  using namespace rtt::rms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RTT_RMS_DISPATCH(x_type, p_type, plain_bwd, dout, x, scale, rstd, dx,
                   partial, dscale, rows, d, row_threads, vec, blocks, s);
}

// The gated form: y fp32 [rows, d] contiguous, x and z [rows, d] in one type
// at row strides x_stride and z_stride (elements), D [d / head_dim] and
// scale [d] in the parameters' type; out [rows, d] in z's type, rstd fp32
// [rows].
extern "C" int gated_rms_norm_fwd(const float* y, const void* x,
                                  const void* D, const void* z,
                                  const void* scale, void* out, float* rstd,
                                  int rows, int d, int head_dim, int x_stride,
                                  int z_stride, int row_threads, int vec,
                                  float eps, int x_type, int p_type,
                                  void* stream) {
  using namespace rtt::rms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RTT_RMS_DISPATCH(x_type, p_type, gated_fwd, y, x, D, z, scale, out, rstd,
                   rows, d, head_dim, x_stride, z_stride, row_threads, vec,
                   eps, s);
}

// dy fp32, dx and dz in x's type, all [rows, d] contiguous; dD [d /
// head_dim] and dscale [d] in the parameters' type; ``partial`` is fp32
// scratch [blocks, d + d / head_dim].
extern "C" int gated_rms_norm_bwd(const void* dout, const float* y,
                                  const void* x, const void* D, const void* z,
                                  const void* scale, const float* rstd,
                                  float* dy, void* dx, void* dz,
                                  float* partial, void* dD, void* dscale,
                                  int rows, int d, int head_dim, int x_stride,
                                  int z_stride, int row_threads, int vec,
                                  int blocks, int x_type, int p_type,
                                  void* stream) {
  using namespace rtt::rms;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RTT_RMS_DISPATCH(x_type, p_type, gated_bwd, dout, y, x, D, z, scale, rstd,
                   dy, dx, dz, partial, dD, dscale, rows, d, head_dim,
                   x_stride, z_stride, row_threads, vec, blocks, s);
}
