// Shared by the general flash kernels K4-K6 (flash_fwd_general.cu,
// flash_bwd_dkdv_general.cu, flash_bwd_dq_general.cu).
//
// They take what K1-K3 do not: fp32 as well as bf16 and fp16, and any
// head_dim from 1 to 256, as the Pallas kernels they replace compute every
// dtype and head_dim in their own body. They are plain CUDA cores (SIMT):
// operands are widened to fp32 in shared memory and every sum is fp32.
//
// One shape for all three: a block of four warps owns kRows rows of one
// (b, h) (four a warp, kept in registers) and streams the other operand
// through shared memory in tiles of kTile = 32 rows, one row a lane. A
// lane computes the score (and dP) of its tile row as a dot product over
// D; a warp then broadcasts each lane's P or dS with a shuffle and every
// lane adds it into the columns it owns (d = lane + 32 t, t < DL, with
// DL >= ceil(D / 32) registers a row). The streamed tiles are padded to
// D + 1 floats a row, so the 32 lanes' dot products read 32 banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

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

// Launches ``kernel`` on grid (B * H, ceil(rows / kRows)) with ``smem``
// bytes of dynamic shared memory; returns the launch's error.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, int BH, int rows, size_t smem, cudaStream_t stream,
           Args... args) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  dim3 grid(BH, (rows + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
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
