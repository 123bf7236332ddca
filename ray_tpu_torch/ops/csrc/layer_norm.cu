// LayerNorm over the last dimension of x [rows, d]: one kernel forward
// (layer_norm_fwd) and one backward (layer_norm_bwd: a kernel over the
// rows, then a fixed-order sum of its per-block column partials).
//
// It replaces no TPU kernel. The JAX package's layer_norm
// (ray_tpu/models/common.py) is plain jnp that XLA fuses into one pass;
// PyTorch runs the same composite eagerly, as ~10 passes forward and ~20
// backward over fp32 copies of [rows, d] (~68 and ~156 bytes an element in
// bf16). Normalisation does ~10 operations a byte read, far below the
// H100's ~295, so it is bound by bytes, and the design moves each byte
// once:
//   - A row lives in the registers of a group of threads (a warp up to d
//     2048 in bf16 forward; 16 elements a thread backward), loaded with
//     16-byte vectors where d and every pointer allow, else element by
//     element; the tail of a row is masked a vector at a time. The forward
//     reads x once and writes y once (4 bytes an element in bf16) and the
//     row's fp32 mean and rstd.
//   - Mean and variance are fp32, the variance two-pass (the mean of
//     (x - mean)^2 over the registers), as the plain version computes
//     them; y is rounded once to x's type.
//   - The backward reads x, dy, scale, mean and rstd once and writes dx
//     (6 bytes an element in bf16). A thread's columns are the same in
//     every row, so it sums dy * x-hat and dy for dscale and dbias in fp32
//     registers over the rows its group takes; the block adds its groups'
//     sums in group order and writes one partial row; a second kernel adds
//     the partial rows in a fixed order. No atomics: the same inputs on the
//     same card give the same bits.
//   - Threads a row and the vector width follow d and the dtype (the
//     wrapper's plan, ray_tpu_torch/ops/norm.py); no model is named here.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace rtt {
namespace norm {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxThreads = 256;  // a block; a row's group is 32 to 256
constexpr int kFwdElems = 64;     // elements of x a thread holds forward
constexpr int kBwdElems = 16;     // and backward (with dy and two sums each)
constexpr int kSumThreads = 512;  // the column sums: 32 columns x 16 slices
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

// V consecutive elements, loaded and stored as one access.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
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

// One row a group of row_threads threads; thread t holds vectors t,
// t + row_threads, ... of the row.
template <typename T, typename P, int V>
__global__ void __launch_bounds__(kMaxThreads)
    ln_fwd(const T* x, const P* scale, const P* bias, T* y, float* mean,
           float* rstd, int rows, int d, int row_threads, float eps) {
  constexpr int kSlots = kFwdElems / V;
  extern __shared__ float smem[];
  const int t = threadIdx.x % row_threads;
  const int row = blockIdx.x * (blockDim.x / row_threads) +
                  threadIdx.x / row_threads;
  const bool live = row < rows;
  const int nvec = d / V;
  const size_t offset = static_cast<size_t>(live ? row : 0) * d;
  const auto* xr = reinterpret_cast<const Pack<T, V>*>(x + offset);
  Pack<T, V> xv[kSlots];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int j = t + i * row_threads;
    if (live && j < nvec) {
      xv[i] = xr[j];
#pragma unroll
      for (int k = 0; k < V; ++k) s += to_f(xv[i].v[k]);
    }
  }
  const float mu = row_sum(s, smem, row_threads / 32) / d;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (live && t + i * row_threads < nvec) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float c = to_f(xv[i].v[k]) - mu;
        ss += c * c;
      }
    }
  }
  const float var = row_sum(ss, smem, row_threads / 32) / d;
  const float rs = 1.f / sqrtf(var + eps);
  if (!live) return;
  auto* yr = reinterpret_cast<Pack<T, V>*>(y + offset);
  const auto* g = reinterpret_cast<const Pack<P, V>*>(scale);
  const auto* b = reinterpret_cast<const Pack<P, V>*>(bias);
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const int j = t + i * row_threads;
    if (j < nvec) {
      const Pack<P, V> gv = g[j], bv = b[j];
      Pack<T, V> out;
#pragma unroll
      for (int k = 0; k < V; ++k)
        out.v[k] = from_f<T>((to_f(xv[i].v[k]) - mu) * rs * to_f(gv.v[k]) +
                             to_f(bv.v[k]));
      yr[j] = out;
    }
  }
  if (t == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

// Rows blockIdx.x * groups + group, then every gridDim.x * groups rows.
// dx = rstd (g - mean(g) - x-hat mean(g x-hat)) with g = dy scale; the
// block's sums of dy x-hat and dy a column go to partial [2, gridDim.x, d].
template <typename T, typename P, int V>
__global__ void __launch_bounds__(kMaxThreads, 2)
    ln_bwd(const T* dy, const T* x, const P* scale, const float* mean,
           const float* rstd, T* dx, float* partial, int rows, int d,
           int row_threads) {
  constexpr int kSlots = kBwdElems / V;
  extern __shared__ float smem[];
  float* cols = smem + kMaxThreads / 32;  // [2, d] after a float a warp
  const int t = threadIdx.x % row_threads;
  const int group = threadIdx.x / row_threads;
  const int groups = blockDim.x / row_threads;
  const int stride = gridDim.x * groups;
  const int nvec = d / V;
  const int row_warps = row_threads / 32;
  const auto* gp = reinterpret_cast<const Pack<P, V>*>(scale);
  Pack<P, V> gv[kSlots];
  float acc_g[kSlots][V], acc_b[kSlots][V];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    if (t + i * row_threads < nvec) gv[i] = gp[t + i * row_threads];
#pragma unroll
    for (int k = 0; k < V; ++k) acc_g[i][k] = acc_b[i][k] = 0.f;
  }
  const int iters = (rows + stride - 1) / stride;
  for (int it = 0; it < iters; ++it) {
    const int row = blockIdx.x * groups + group + it * stride;
    const bool live = row < rows;
    const size_t offset = static_cast<size_t>(live ? row : 0) * d;
    const auto* xr = reinterpret_cast<const Pack<T, V>*>(x + offset);
    const auto* dyr = reinterpret_cast<const Pack<T, V>*>(dy + offset);
    Pack<T, V> xv[kSlots], dv[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int j = t + i * row_threads;
      if (live && j < nvec) {
        xv[i] = xr[j];
        dv[i] = dyr[j];
      }
    }
    const float mu = live ? mean[row] : 0.f;
    const float rs = live ? rstd[row] : 0.f;
    float sg = 0.f, sgx = 0.f;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (live && t + i * row_threads < nvec) {
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xh = (to_f(xv[i].v[k]) - mu) * rs;
          const float dyf = to_f(dv[i].v[k]);
          const float g = dyf * to_f(gv[i].v[k]);
          sg += g;
          sgx += g * xh;
          acc_g[i][k] += dyf * xh;
          acc_b[i][k] += dyf;
        }
      }
    }
    sg = row_sum(sg, smem, row_warps) / d;
    sgx = row_sum(sgx, smem, row_warps) / d;
    if (!live) continue;
    auto* dxr = reinterpret_cast<Pack<T, V>*>(dx + offset);
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      const int j = t + i * row_threads;
      if (j < nvec) {
        Pack<T, V> out;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const float xh = (to_f(xv[i].v[k]) - mu) * rs;
          const float g = to_f(dv[i].v[k]) * to_f(gv[i].v[k]);
          out.v[k] = from_f<T>(rs * (g - sg - xh * sgx));
        }
        dxr[j] = out;
      }
    }
  }
  // The block's column sums: its groups' in group order.
  for (int gi = 0; gi < groups; ++gi) {
    if (group == gi) {
#pragma unroll
      for (int i = 0; i < kSlots; ++i) {
        const int j = t + i * row_threads;
        if (j < nvec) {
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const int c = j * V + k;
            cols[c] = (gi ? cols[c] : 0.f) + acc_g[i][k];
            cols[d + c] = (gi ? cols[d + c] : 0.f) + acc_b[i][k];
          }
        }
      }
    }
    __syncthreads();
  }
  float* pg = partial + static_cast<size_t>(blockIdx.x) * d;
  float* pb = partial + static_cast<size_t>(gridDim.x + blockIdx.x) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    pg[c] = cols[c];
    pb[c] = cols[d + c];
  }
}

// dscale (blockIdx.y 0) or dbias (1): the ``blocks`` partial rows summed
// in a fixed order (slice by slice, then the slices in turn), rounded once.
template <typename P>
__global__ void __launch_bounds__(kSumThreads)
    ln_bwd_cols(const float* partial, int blocks, int d, P* dscale,
                P* dbias) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x % 32, slice = threadIdx.x / 32;
  const int c = blockIdx.x * 32 + lane;
  const float* src = partial + static_cast<size_t>(blockIdx.y) * blocks * d;
  float s = 0.f;
  if (c < d)
    for (int b = slice; b < blocks; b += kSlices)
      s += src[static_cast<size_t>(b) * d + c];
  smem[slice * 32 + lane] = s;
  __syncthreads();
  if (slice == 0 && c < d) {
    float total = 0.f;
    for (int k = 0; k < kSlices; ++k) total += smem[k * 32 + lane];
    (blockIdx.y ? dbias : dscale)[c] = from_f<P>(total);
  }
}

template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, Args... args) {
  kernel<<<grid, threads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Whether the plan (vec, row_threads) covers a row of d with ``elems``
// elements a thread.
inline bool plan_ok(int rows, int d, int row_threads, int vec, int max_vec,
                    int elems) {
  return rows > 0 && d > 0 && (vec == 1 || vec == max_vec) && d % vec == 0 &&
         row_threads % 32 == 0 && row_threads >= 32 &&
         row_threads <= kMaxThreads &&
         d / vec <= (elems / vec) * row_threads;
}

template <typename T, typename P>
int fwd(const void* x, const void* scale, const void* bias, void* y,
        float* mean, float* rstd, int rows, int d, int row_threads, int vec,
        float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (!plan_ok(rows, d, row_threads, vec, kVec, kFwdElems))
    return cudaErrorInvalidValue;
  const int groups = kMaxThreads / row_threads;
  const dim3 grid((rows + groups - 1) / groups);
  const int threads = groups * row_threads;
  const size_t smem = kMaxThreads / 32 * sizeof(float);
  const T* xt = static_cast<const T*>(x);
  const P* st = static_cast<const P*>(scale);
  const P* bt = static_cast<const P*>(bias);
  T* yt = static_cast<T*>(y);
  if (vec == 1)
    return launch(ln_fwd<T, P, 1>, grid, threads, smem, stream, xt, st, bt,
                  yt, mean, rstd, rows, d, row_threads, eps);
  return launch(ln_fwd<T, P, kVec>, grid, threads, smem, stream, xt, st, bt,
                yt, mean, rstd, rows, d, row_threads, eps);
}

template <typename T, typename P>
int bwd(const void* dy, const void* x, const void* scale, const float* mean,
        const float* rstd, void* dx, float* partial, void* dscale,
        void* dbias, int rows, int d, int row_threads, int vec, int blocks,
        cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  if (!plan_ok(rows, d, row_threads, vec, kVec, kBwdElems) || blocks < 1)
    return cudaErrorInvalidValue;
  const int threads = kMaxThreads / row_threads * row_threads;
  const size_t smem = (kMaxThreads / 32 + 2 * static_cast<size_t>(d)) *
                      sizeof(float);
  const T* dyt = static_cast<const T*>(dy);
  const T* xt = static_cast<const T*>(x);
  const P* st = static_cast<const P*>(scale);
  T* dxt = static_cast<T*>(dx);
  const int err =
      vec == 1
          ? launch(ln_bwd<T, P, 1>, dim3(blocks), threads, smem, stream, dyt,
                   xt, st, mean, rstd, dxt, partial, rows, d, row_threads)
          : launch(ln_bwd<T, P, kVec>, dim3(blocks), threads, smem, stream,
                   dyt, xt, st, mean, rstd, dxt, partial, rows, d,
                   row_threads);
  if (err != 0) return err;
  const dim3 grid((d + 31) / 32, 2);
  const size_t sum_smem = kSumThreads * sizeof(float);
  return launch(ln_bwd_cols<P>, grid, kSumThreads, sum_smem, stream,
                static_cast<const float*>(partial), blocks, d,
                static_cast<P*>(dscale), static_cast<P*>(dbias));
}

}  // namespace norm
}  // namespace rtt

// Types: 0 fp32, 1 bf16, 2 fp16; the parameters' type is x's or fp32.
#define RTT_NORM_DISPATCH(x_type, p_type, FN, ...)           \
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

// y [rows, d] in x's type, mean and rstd fp32 [rows]; ``vec`` elements a
// load (16 bytes' worth, or 1) and ``row_threads`` threads a row.
extern "C" int layer_norm_fwd(const void* x, const void* scale,
                              const void* bias, void* y, float* mean,
                              float* rstd, int rows, int d, int row_threads,
                              int vec, float eps, int x_type, int p_type,
                              void* stream) {
  using namespace rtt::norm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RTT_NORM_DISPATCH(x_type, p_type, fwd, x, scale, bias, y, mean, rstd, rows,
                    d, row_threads, vec, eps, s);
}

// dx [rows, d] in x's type, dscale and dbias [d] in the parameters' type;
// ``partial`` is fp32 scratch [2, blocks, d], ``blocks`` the rows kernel's
// grid.
extern "C" int layer_norm_bwd(const void* dy, const void* x,
                              const void* scale, const float* mean,
                              const float* rstd, void* dx, float* partial,
                              void* dscale, void* dbias, int rows, int d,
                              int row_threads, int vec, int blocks,
                              int x_type, int p_type, void* stream) {
  using namespace rtt::norm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RTT_NORM_DISPATCH(x_type, p_type, bwd, dy, x, scale, mean, rstd, dx,
                    partial, dscale, dbias, rows, d, row_threads, vec, blocks,
                    s);
}
