// Shared by the general flash kernels K4-K6 (flash_fwd_general.cu,
// flash_bwd_dkdv_general.cu, flash_bwd_dq_general.cu).
//
// They take what K1-K3 do not: fp32 as well as bf16 and fp16, and any
// head_dim from 1 to 256, as the Pallas kernels they replace compute every
// dtype and head_dim in their own body. They are plain CUDA cores (SIMT):
// every product and sum is fp32.
//
// K5 and K6 share one shape: a block of four warps owns kRows rows of one
// (b, h) (four a warp, kept in registers) and streams the other operand
// through shared memory in tiles of kTile = 32 rows, one row a lane. A
// lane computes the score (and dP) of its tile row as a dot product over
// D; a warp then broadcasts each lane's P or dS with a shuffle and every
// lane adds it into the columns it owns (d = lane + 32 t, t < DL, with
// DL >= ceil(D / 32) registers a row). The streamed tiles are padded to
// D + 1 floats a row, so the 32 lanes' dot products read 32 banks.
//
// K4 is register-blocked (see flash_fwd_general.cu); its pieces here are
// the asynchronous tile copies (cp_async, copy_plan, copy_rows), vector
// loads from shared memory widened to fp32 (load_vec, store_vec), the row
// stride that keeps those loads free of bank conflicts (smem_ld) and the
// reductions over a row's few threads (group_max, group_sum).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <string.h>

namespace rtt {
namespace general {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // owned rows a block
constexpr int kTile = 32;                     // streamed rows a tile
constexpr int kMaxDL = 8;                     // head_dim <= 256
constexpr float kMasked = -1e30f;             // the reference's causal mask
constexpr unsigned kFull = 0xffffffffu;

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

// x rounded to T and widened again: where the reference rounds P or dS to
// the operand type before a product.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// Rows [r0, r0 + n) of a row-major [*, D] matrix into fp32 shared memory,
// ``ld`` floats a row; rows at or past ``limit`` read as 0.
template <typename T>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          int r0, int n, int limit, int D) {
  for (int i = threadIdx.x; i < n * D; i += blockDim.x) {
    const int r = i / D, c = i - r * D;
    dst[r * ld + c] =
        r0 + r < limit ? to_f(src[static_cast<size_t>(r0 + r) * D + c]) : 0.f;
  }
}

__device__ __forceinline__ float dot(const float* a, const float* b, int D) {
  float s = 0.f;
  for (int d = 0; d < D; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

// Launches ``kernel`` on ``grid`` blocks of kThreads with ``smem`` bytes of
// dynamic shared memory; returns the launch's error.
template <typename Kernel, typename... Args>
int launch_grid(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
                Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Launches ``kernel`` on grid (B * H, ceil(rows / kRows)).
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int BH, int rows, size_t smem, cudaStream_t stream,
           Args... args) {
  return launch_grid(kernel, dim3(BH, (rows + kRows - 1) / kRows), smem,
                     stream, args...);
}

// -- K4's pieces --------------------------------------------------------------

// ``Bytes`` from global to shared memory without a register stage
// (cp.async; 16-byte copies bypass L1), or zeros where !valid. They land
// by cp_async_wait_all. Without the device compiler (a host build of
// these sources, as the CPU harness of the tests makes) the copy is done
// at once and the wait is a no-op.
template <int Bytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  static_assert(Bytes == 4 || Bytes == 16, "cp.async size");
#ifdef __CUDA_ARCH__
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? Bytes : 0;
  if constexpr (Bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
                 "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s),
                 "l"(src), "n"(Bytes), "r"(n)
                 : "memory");
#else
  if (valid)
    memcpy(dst, src, Bytes);
  else
    memset(dst, 0, Bytes);
#endif
}

// Waits for all of this thread's cp.async copies.
__device__ __forceinline__ void cp_async_wait_all() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// How a block's threads copy [*, D] row tiles of T into shared memory:
// cp.async of ``bytes`` (16 or 4; the rows' bytes and the source are
// multiples of it), or element by element at once (0). A warp takes 32 /
// (copies a row) rows at a time where that divides evenly, else one row
// at a time; the thread's first row and column and their strides are
// worked out once.
struct CopyPlan {
  int bytes, r_first, r_step, c_first, c_step;
};

template <typename T>
__device__ __forceinline__ CopyPlan copy_plan(int D, int bytes) {
  const int e = bytes > 0 ? bytes / static_cast<int>(sizeof(T)) : 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int per_row = D / e;
  const int rpw = per_row <= 32 && 32 % per_row == 0 ? 32 / per_row : 1;
  return {bytes, warp * rpw + (rpw > 1 ? lane / per_row : 0), kWarps * rpw,
          (rpw > 1 ? lane % per_row : lane) * e, 32 * e};
}

// Rows [r0, r0 + n) of a row-major [*, D] matrix into shared memory, ``ld``
// elements a row, rows at or past ``limit`` as zeros; columns D and up are
// left alone.
template <int Bytes, typename T>
__device__ __forceinline__ void copy_rows_as(T* dst, int ld, const T* src,
                                             int r0, int n, int limit, int D,
                                             const CopyPlan& p) {
  for (int r = p.r_first; r < n; r += p.r_step) {
    const bool ok = r0 + r < limit;
    const T* s = src + static_cast<size_t>(ok ? r0 + r : 0) * D;
    for (int c = p.c_first; c < D; c += p.c_step) {
      if constexpr (Bytes > 0)
        cp_async<Bytes>(dst + r * ld + c, s + c, ok);
      else
        dst[r * ld + c] = ok ? s[c] : from_f<T>(0.f);
    }
  }
}

template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ld, const T* src,
                                          int r0, int n, int limit, int D,
                                          const CopyPlan& p) {
  if (p.bytes == 16)
    copy_rows_as<16>(dst, ld, src, r0, n, limit, D, p);
  else if (p.bytes == 4)
    copy_rows_as<4>(dst, ld, src, r0, n, limit, D, p);
  else
    copy_rows_as<0>(dst, ld, src, r0, n, limit, D, p);
}

// Shared-memory row stride of a [*, D] tile of T, in elements: D rounded
// up to 4 elements and then to an odd number of 16-byte units, so that
// eight threads reading 16 (or 8) bytes at one column of eight
// consecutive rows hit eight different groups of banks.
template <typename T>
__host__ __device__ __forceinline__ int smem_ld(int D) {
  const int d4 = (D + 3) & ~3;
  const int units = (d4 * static_cast<int>(sizeof(T)) + 15) / 16;
  return (units | 1) * 16 / static_cast<int>(sizeof(T));
}

template <int Bytes>
struct Bits;
template <>
struct Bits<16> { using type = uint4; };
template <>
struct Bits<8> { using type = uint2; };
template <>
struct Bits<4> { using type = unsigned; };

// p[0, N) widened to fp32, in loads of up to 16 bytes (p aligned to one).
template <int N, typename T>
__device__ __forceinline__ void load_vec(float (&x)[N], const T* p) {
  constexpr int C = N * sizeof(T) > 16 ? 16 / sizeof(T) : N;  // a load
  using V = typename Bits<C * sizeof(T)>::type;
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += C) {
    const V w = *reinterpret_cast<const V*>(p + i0);
    T t[C];
    memcpy(t, &w, sizeof(t));
#pragma unroll
    for (int i = 0; i < C; ++i) x[i0 + i] = to_f(t[i]);
  }
}

// x[0, N) to fp32 shared memory at p, in stores of up to 16 bytes.
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[N]) {
  constexpr int C = N > 4 ? 4 : N;  // floats a store
  using V = typename Bits<C * 4>::type;
#pragma unroll
  for (int i0 = 0; i0 < N; i0 += C) {
    V w;
    memcpy(&w, x + i0, sizeof(w));
    *reinterpret_cast<V*>(p + i0) = w;
  }
}

// Max and sum over the G lanes (a power of two, adjacent lanes) that
// share a row.
template <int G>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = G / 2; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

template <int G>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = G / 2; o; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

}  // namespace general
}  // namespace rtt

// Calls LAUNCH<T, DL>(...) for the element type ``dtype`` (0 fp32, 1 bf16,
// 2 fp16) and DL the power of two at or above ceil(D / 32) (1, 2, 4 or 8:
// twelve instantiations a kernel keep nvcc's time down; the kernels mask
// the columns past D); cudaErrorInvalidValue for anything else.
#define RTT_GENERAL_DISPATCH(dtype, D, LAUNCH, ...)                          \
  do {                                                                      \
    const int dl_ = ((D) + 31) / 32;                                        \
    if ((D) < 1 || dl_ > rtt::general::kMaxDL || (dtype) < 0 || (dtype) > 2) \
      return static_cast<int>(cudaErrorInvalidValue);                       \
    const int p2_ = dl_ <= 1 ? 1 : dl_ <= 2 ? 2 : dl_ <= 4 ? 4 : 8;         \
    switch ((dtype) * 16 + p2_) {                                           \
      RTT_GENERAL_CASES(0, float, LAUNCH, __VA_ARGS__)                      \
      RTT_GENERAL_CASES(1, __nv_bfloat16, LAUNCH, __VA_ARGS__)              \
      RTT_GENERAL_CASES(2, __half, LAUNCH, __VA_ARGS__)                     \
    }                                                                       \
    return static_cast<int>(cudaErrorInvalidValue);                         \
  } while (0)

#define RTT_GENERAL_CASE(code, T, dl, LAUNCH, ...) \
  case (code) * 16 + (dl):                         \
    return LAUNCH<T, dl>(__VA_ARGS__);

#define RTT_GENERAL_CASES(code, T, LAUNCH, ...)        \
  RTT_GENERAL_CASE(code, T, 1, LAUNCH, __VA_ARGS__)    \
  RTT_GENERAL_CASE(code, T, 2, LAUNCH, __VA_ARGS__)    \
  RTT_GENERAL_CASE(code, T, 4, LAUNCH, __VA_ARGS__)    \
  RTT_GENERAL_CASE(code, T, 8, LAUNCH, __VA_ARGS__)
