// Shared pieces of the flash-attention kernels (sm_90a).
//
// Operands are 16-bit (bf16 or fp16) and are handled as raw uint16_t in
// device and shared memory; only the tensor-core instruction and the
// float conversions depend on the type, and those live in the two traits
// structs below. Products use mma.sync m16n8k16 with fp32 accumulation.
//
// Fragment layouts of mma.sync.m16n8k16 (g = lane / 4, t = lane % 4):
//   A (16x16, row major), four 32-bit registers of two elements each:
//     a0 = A[g][2t..2t+1]     a1 = A[g+8][2t..2t+1]
//     a2 = A[g][2t+8..2t+9]   a3 = A[g+8][2t+8..2t+9]
//   B (16x8, "col": element pairs run along k):
//     b0 = B[2t..2t+1][g]     b1 = B[2t+8..2t+9][g]
//   C (16x8 fp32): c0,c1 = C[g][2t..2t+1]   c2,c3 = C[g+8][2t..2t+1]
// Two neighbouring C tiles (columns 0-7 and 8-15) therefore hold exactly
// the A fragment of a 16x16 tile once packed to 16 bits, which is how the
// score tile feeds the second product without a trip through memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rtt {

constexpr float kNegInf = -1e30f;  // the reference's finite mask value
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;

struct BF16 {
  static __device__ __forceinline__ float to_f(uint16_t x) {
    return __uint_as_float(static_cast<uint32_t>(x) << 16);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

struct F16 {
  static __device__ __forceinline__ float to_f(uint16_t x) {
    return __half2float(__ushort_as_half(x));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// Shared-memory row stride in elements: 8 elements (16 bytes) of padding
// shift consecutive rows across banks and keep rows 16-byte aligned.
template <int D>
struct Ld {
  static constexpr int value = D + 8;
};

// Copies rows [row0, row0 + ROWS) of a [n_rows, D] matrix into shared
// memory with 16-byte loads; rows past n_rows are zero-filled.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint16_t* __restrict__ dst,
                                          const uint16_t* __restrict__ src,
                                          int row0, int n_rows) {
  constexpr int kVec = D / 8;  // uint4 per row
  constexpr int LD = Ld<D>::value;
  for (int i = threadIdx.x; i < ROWS * kVec; i += kThreads) {
    const int r = i / kVec;
    const int c = (i % kVec) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (row0 + r < n_rows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + c);
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// A fragment of the 16x16 block at (r0, k0) of a row-major smem tile.
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4],
                                       const uint16_t* __restrict__ s,
                                       int r0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint16_t* p = s + (r0 + g) * LD + k0 + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
}

// B fragment for B = M^T where M is a row-major smem tile [n][k]: the
// element pairs along k are contiguous in M's rows (32-bit loads).
template <int LD>
__device__ __forceinline__ void load_b_t(uint32_t& b0, uint32_t& b1,
                                         const uint16_t* __restrict__ s,
                                         int n0, int k0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint16_t* p = s + (n0 + g) * LD + k0 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// B fragment for B = M where M is a row-major smem tile [k][n]: the pairs
// along k sit in two different rows, so each is two 16-bit loads.
template <int LD>
__device__ __forceinline__ void load_b(uint32_t& b0, uint32_t& b1,
                                       const uint16_t* __restrict__ s,
                                       int k0, int n0) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const uint16_t* p = s + (k0 + 2 * t) * LD + n0 + g;
  b0 = static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[LD]) << 16);
  b1 = static_cast<uint32_t>(p[8 * LD]) |
       (static_cast<uint32_t>(p[9 * LD]) << 16);
}

// Packs C tiles 2c and 2c+1 (fp32) into the A fragment of a 16x16 tile.
template <typename T>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c0)[4],
                                       const float (&c1)[4]) {
  a[0] = T::pack(c0[0], c0[1]);
  a[1] = T::pack(c0[2], c0[3]);
  a[2] = T::pack(c1[0], c1[1]);
  a[3] = T::pack(c1[2], c1[3]);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

// Sets the dynamic shared-memory ceiling of a kernel (needed above 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace rtt
