// A CPU stand-in for the parts of the CUDA runtime that the general flash
// kernels (ray_tpu_torch/ops/csrc/*_general.cu, general.cuh) and the
// LayerNorm kernels (layer_norm.cu) use, so that g++ can build their
// sources into a host library whose C entry points run the kernels'
// arithmetic on CPU tensors (tests/test_torch_general_stub.py,
// tests/test_torch_norm.py, through tests/torch_stub_build.py).
//
// A launch runs its blocks one after another; a block is one std::thread
// for each CUDA thread. __syncthreads is a barrier over the block, and
// __syncwarp and every warp shuffle a barrier over the warp's 32 threads
// (a shuffle writes its value, waits, reads its partner's: two slots a
// warp, used in turn, so a shuffle needs one barrier). Two constructs of
// the sources are not C++ and the test rewrites them before compiling:
// ``kernel<<<grid, block, smem, stream>>>(args)`` becomes
// ``rtt_stub::launch(kernel, grid, block, smem, stream, args)`` and
// ``extern __shared__ T name[];`` becomes a pointer to the block's dynamic
// shared memory (rtt_stub::dynamic_smem()). The cp.async helpers copy at
// once without __CUDA_ARCH__.
#pragma once

#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <math.h>
#include <stddef.h>
#include <string.h>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)

using std::max;
using std::min;

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(8) uint2 { unsigned x, y; };

typedef struct CUstream_st* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

template <typename F>
inline cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

// 16-bit floats as their bits; conversions round to nearest even.
struct __nv_bfloat16 { uint16_t x; };
struct __half { uint16_t x; };

inline float __bfloat162float(__nv_bfloat16 h) {
  const uint32_t u = static_cast<uint32_t>(h.x) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if (std::isnan(f)) return {0x7fc0};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<uint16_t>(u >> 16)};
}
inline float __half2float(__half h) {
  _Float16 f;
  memcpy(&f, &h.x, 2);
  return static_cast<float>(f);
}
inline __half __float2half_rn(float f) {
  const _Float16 h = static_cast<_Float16>(f);
  __half r;
  memcpy(&r.x, &h, 2);
  return r;
}

namespace rtt_stub {

struct Warp {
  std::barrier<> bar{32};
  uint64_t slot[2][32];
};

struct Block {
  explicit Block(unsigned threads)
      : bar(threads), warps((threads + 31) / 32) {}
  std::barrier<> bar;
  std::vector<Warp> warps;
  std::vector<uint4> smem;
};

inline thread_local Block* block = nullptr;
inline thread_local int phase = 0;
inline thread_local dim3 thread_idx, block_idx;
inline dim3 block_dim, grid_dim;

inline void* dynamic_smem() { return block->smem.data(); }

template <typename T>
T exchange(T x, int src_lane) {
  static_assert(sizeof(T) <= 8, "shuffle of a value over 8 bytes");
  Warp& w = block->warps[thread_idx.x / 32];
  uint64_t bits = 0;
  memcpy(&bits, &x, sizeof(T));
  const int p = phase;
  phase ^= 1;
  w.slot[p][thread_idx.x % 32] = bits;
  w.bar.arrive_and_wait();
  bits = w.slot[p][src_lane];
  memcpy(&x, &bits, sizeof(T));
  return x;
}

// Runs the grid's blocks in turn, each as block.x threads.
template <typename... Params, typename... Args>
void launch(void (*kernel)(Params...), dim3 grid, dim3 block_shape,
            size_t smem, cudaStream_t, Args... args) {
  const unsigned n = block_shape.x * block_shape.y * block_shape.z;
  block_dim = block_shape;
  grid_dim = grid;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        Block b(n);
        // Shared memory starts as NaNs, as a card leaves it undefined.
        b.smem.assign((smem + 15) / 16, uint4{~0u, ~0u, ~0u, ~0u});
        std::vector<std::thread> threads;
        for (unsigned t = 0; t < n; ++t)
          threads.emplace_back([&, t] {
            block = &b;
            phase = 0;
            thread_idx = dim3(t % block_shape.x,
                              t / block_shape.x % block_shape.y,
                              t / (block_shape.x * block_shape.y));
            block_idx = dim3(bx, by, bz);
            kernel(static_cast<Params>(args)...);
          });
        for (auto& th : threads) th.join();
      }
}

}  // namespace rtt_stub

#define threadIdx (::rtt_stub::thread_idx)
#define blockIdx (::rtt_stub::block_idx)
#define blockDim (::rtt_stub::block_dim)
#define gridDim (::rtt_stub::grid_dim)

inline void __syncthreads() { rtt_stub::block->bar.arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) {
  rtt_stub::block->warps[threadIdx.x / 32].bar.arrive_and_wait();
}
template <typename T>
T __shfl_sync(unsigned, T x, int src_lane) {
  return rtt_stub::exchange(x, src_lane);
}
template <typename T>
T __shfl_xor_sync(unsigned, T x, int mask) {
  return rtt_stub::exchange(x, static_cast<int>(threadIdx.x % 32) ^ mask);
}
