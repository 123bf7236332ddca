// The Mamba-2 chunked scan (SSD) on the card: what the kernels of
// ssd_state.cu, ssd_scan.cu and ssd_grad.cu share. ray_tpu_torch/ops/ssd.py
// launches them and holds the plain version beside them.
//
// They replace no TPU kernel: the JAX package has no Mamba layer. At the
// Granite 4.0-H cell's shape (x [8, 8192, 128, 64] bf16, n 128, chunk 256)
// a call does ~126 operations a byte of its inputs and outputs, under the
// H100's ~295, so it is bound by bytes. The plain version made ~15 fp32
// passes over [b, heads, chunks, 256, 256] blocks (8.6 GB a call); here
// nothing quadratic in the chunk a head reaches device memory:
//   - a chunk's C B^T is one fp32 [chunk, chunk] tile a (batch row, chunk),
//     shared by the heads (a plain product by the caller); each head's
//     decays exp(cs_t - cs_s), dt and the causal mask are applied to it in
//     registers, 16 rows by 32 columns at a time, and it feeds the next
//     product on the tensor cores straight from the accumulators;
//   - what crosses chunks is the [P, N] fp32 state of each (batch, head,
//     chunk), carried by one short sequential pass (state_pass);
//   - sums over the heads (dB, dC, C B^T's gradient) loop over the heads
//     inside one block in a fixed order: no atomics, the same bits on every
//     run.
// Cumulative sums, decays, states and accumulators are fp32; the products
// run on the tensor cores in bf16 (mma.sync m16n8k16, fp32 accumulation).
// x, B and C are bf16 already; a derived operand (a decay times C B^T
// times dt, a decay-weighted x, a state, dy) enters as two bf16 parts, hi
// the nearest bf16 and lo the nearest to the rest, each product taken per
// part (lo x lo left out): near fp32. One rounding of them moves dA, a sum
// over the whole sequence, by 0.1-1%, and the first parameter of A_log
// (the one whose updates bf16 keeps) then moves the other way.
//
// Layouts (elements): x [b, S, H, P] bf16, a position's row at stride xs
// (P per head contiguous); B, C [b, S, N] bf16 at position stride bs; dt
// [b, S, H] and A [H] fp32; y, dy [b, S, H, P] fp32 contiguous. A chunk's
// positions past S read as zeros (dt 0: no decay, no input).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace rtt {
namespace ssd {

constexpr unsigned kFull = 0xffffffffu;

// What every entry point takes; each kernel reads the fields it needs.
struct Args {
  const uint16_t* x;  // [b, S, H, P] bf16, position stride xs
  const uint16_t* B;  // [b, S, N] bf16, position stride bs
  const uint16_t* C;
  const float* dt;    // [b, S, H]
  const float* A;     // [H]
  const float* dy;    // [b, S, H, P]
  float* cs;          // [b, H, c, Q]: cumulative sums of dt A in each chunk
  float* st;          // [b, H, c, P, N]: states (see state_pass)
  const float* ent;   // [b, H, c, P, N]: the states entering each chunk
  float* y;           // [b, S, H, P]
  float* ddec;        // [b, H, c, parts]
  uint16_t* dx;       // [b, S, H, P] bf16
  float* ddt;         // [b, S, H]
  float* dA;          // [b, H, c]
  float* dG;          // [b, c, Q, Q]
  float* out;         // [b, c Q, N]
  const float* G;     // [b, c, Q, Q]: C B^T (forward) or B C^T in each chunk
  long long xs, bs;
  int S, H, parts;
};

// e^x: the card's exponential unit (ex2 of x log2 e), libm's on the host.
__device__ __forceinline__ float ex(float x) {
#ifdef __CUDA_ARCH__
  return __expf(x);
#else
  return expf(x);
#endif
}

__device__ __forceinline__ float as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}

// bf16 bits of f, rounded to nearest even, and back.
__device__ __forceinline__ uint16_t bits(float f) {
  const __nv_bfloat16 h = __float2bfloat16_rn(f);
  uint16_t u;
  memcpy(&u, &h, 2);
  return u;
}
__device__ __forceinline__ float val(uint16_t u) {
  return as_float(static_cast<uint32_t>(u) << 16);
}
__device__ __forceinline__ float lo(uint32_t w) {
  return val(static_cast<uint16_t>(w & 0xffffu));
}
__device__ __forceinline__ float hi(uint32_t w) {
  return val(static_cast<uint16_t>(w >> 16));
}

// Two bf16 in one register, the first in the low half.
__device__ __forceinline__ uint32_t pair(uint16_t a, uint16_t b) {
  return a | (static_cast<uint32_t>(b) << 16);
}
__device__ __forceinline__ uint32_t pack(float a, float b) {
  return pair(bits(a), bits(b));
}
// A pair as hi (the nearest bf16s) and lo (the nearest to the rest).
__device__ __forceinline__ void split(float a, float b, uint32_t& h,
                                      uint32_t& l) {
  h = pack(a, b);
  l = pack(a - lo(h), b - hi(h));
}
__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  p[0] = a;
  p[1] = b;
}
__device__ __forceinline__ void ld2(const float* p, float& a, float& b) {
  a = p[0];
  b = p[1];
}

// D += A B for one warp: m16n8k16, bf16 operands, fp32 accumulators. Lane
// l (g = l / 4, c = l % 4) holds a = {A[g][2c, 2c+1], A[g+8][2c, 2c+1],
// A[g][2c+8, 2c+9], A[g+8][2c+8, 2c+9]}, b = {B[2c, 2c+1][g], B[2c+8,
// 2c+9][g]} and d = {D[g][2c], D[g][2c+1], D[g+8][2c], D[g+8][2c+1]}.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
#else
  // The same product from the warp's fragments, gathered by shuffles.
  const int lane = threadIdx.x % 32, g = lane / 4, c = lane % 4;
  uint32_t ar[4][4], br[2][4][2];
  for (int j = 0; j < 4; ++j) {
    for (int r = 0; r < 4; ++r) ar[j][r] = __shfl_sync(kFull, a[r], 4 * g + j);
    for (int col = 0; col < 2; ++col)
      for (int r = 0; r < 2; ++r)
        br[col][j][r] = __shfl_sync(kFull, b[r], 4 * (2 * c + col) + j);
  }
  for (int i = 0; i < 4; ++i) {
    float s = 0.f;
    for (int k = 0; k < 16; ++k) {
      const uint32_t aw = ar[(k % 8) / 2][i / 2 + 2 * (k / 8)];
      const uint32_t bw = br[i % 2][(k % 8) / 2][k / 8];
      s += (k % 2 ? hi(aw) : lo(aw)) * (k % 2 ? hi(bw) : lo(bw));
    }
    d[i] += s;
  }
#endif
}

// Four 8 x 8 bf16 matrices of shared memory, 2 x 2 from ``base`` (row
// stride ``ld``, rows 16-byte aligned): d[i] holds matrix (rows 8 (i % 2),
// columns 8 (i / 2)), lane l its row l / 4, columns 2 (l % 4) and the next
// (kTrans: column l / 4, rows 2 (l % 4) and the next), as ldmatrix loads
// them. So for B stored [n][k], d = {b of n 0-7 (d0, d2), n 8-15 (d1,
// d3)}; stored [k][n] (kTrans), {n 0-7 (d0, d1), n 8-15 (d2, d3)}; A
// stored [k][m] (kTrans) is {d0, d2, d1, d3}.
template <bool kTrans>
__device__ __forceinline__ void ldsm4(const uint16_t* base, int ld,
                                      uint32_t (&d)[4]) {
  const int lane = threadIdx.x % 32;
#ifdef __CUDA_ARCH__
  const uint16_t* row = base + ((lane / 8) % 2 * 8 + lane % 8) * ld +
                        (lane / 16) * 8;
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  if (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(addr));
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
        : "r"(addr));
#else
  const int g = lane / 4, c = lane % 4;
  for (int i = 0; i < 4; ++i) {
    const uint16_t* m = base + (i % 2) * 8 * ld + (i / 2) * 8;
    d[i] = kTrans ? pair(m[2 * c * ld + g], m[(2 * c + 1) * ld + g])
                  : pair(m[g * ld + 2 * c], m[g * ld + 2 * c + 1]);
  }
#endif
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  return v;
}

// The sum of v over the lanes of a group of four (a row of a fragment).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// Sums of v over lanes 0..lane (prefix) and lane..31 (suffix).
__device__ __forceinline__ float warp_prefix(float v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_sync(kFull, v, lane >= o ? lane - o : lane);
    if (lane >= o) v += u;
  }
  return v;
}
__device__ __forceinline__ float warp_suffix(float v) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_sync(kFull, v, lane + o < 32 ? lane + o : lane);
    if (lane + o < 32) v += u;
  }
  return v;
}

// Eight consecutive elements as floats (zeros where !ok); p 16-byte
// aligned.
__device__ __forceinline__ void load8(const uint16_t* p, bool ok,
                                      float (&f)[8]) {
  uint4 v = {0u, 0u, 0u, 0u};
  if (ok) v = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    f[2 * e] = lo(w[e]);
    f[2 * e + 1] = hi(w[e]);
  }
}
__device__ __forceinline__ void load8(const float* p, bool ok,
                                      float (&f)[8]) {
  uint4 v0 = {0u, 0u, 0u, 0u}, v1 = v0;
  if (ok) {
    v0 = reinterpret_cast<const uint4*>(p)[0];
    v1 = reinterpret_cast<const uint4*>(p)[1];
  }
  const uint32_t w[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = as_float(w[e]);
}

// Shared-memory tiles of bf16, row-major with ``ld`` elements a row, from
// ``rows`` rows of ``cols`` elements at ``stride`` in device memory (rows
// at or past ``valid`` read as zeros); cols a multiple of 8, rows and ld
// 16-byte aligned. A thread loads kBatch pieces of 8 before it converts
// and stores any, so that several loads are in flight.
constexpr int kBatch = 4;

template <typename T>
__device__ __forceinline__ void stage_rows(uint16_t* dst, int ld, const T* src,
                                           size_t stride, int rows, int cols,
                                           int valid) {
  const int per = cols / 8, total = rows * per;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
    float f[kBatch][8];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x, r = i / per, c8 = (i % per) * 8;
      load8(src + r * stride + c8, i < total && r < valid, f[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x, r = i / per, c8 = (i % per) * 8;
      if (i >= total) break;
      const uint4 v = {pack(f[u][0], f[u][1]), pack(f[u][2], f[u][3]),
                       pack(f[u][4], f[u][5]), pack(f[u][6], f[u][7])};
      *reinterpret_cast<uint4*>(dst + r * ld + c8) = v;
    }
  }
}

// The same, each row scaled by w[row] where w is given, as two bf16
// tiles: hi the nearest bf16, lo the nearest to what is left (~16 bits of
// each element in all).
template <typename T>
__device__ __forceinline__ void stage_rows_split(uint16_t* dst_hi,
                                                 uint16_t* dst_lo, int ld,
                                                 const T* src, size_t stride,
                                                 int rows, int cols, int valid,
                                                 const float* w) {
  const int per = cols / 8, total = rows * per;
  for (int i0 = threadIdx.x; i0 < total; i0 += kBatch * blockDim.x) {
    float f[kBatch][8];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x, r = i / per, c8 = (i % per) * 8;
      load8(src + r * stride + c8, i < total && r < valid, f[u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * blockDim.x, r = i / per, c8 = (i % per) * 8;
      if (i >= total) break;
      const float s = w ? w[r] : 1.f;
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float v0 = s * f[u][2 * e], v1 = s * f[u][2 * e + 1];
        h[e] = pack(v0, v1);
        l[e] = pack(v0 - lo(h[e]), v1 - hi(h[e]));
      }
      *reinterpret_cast<uint4*>(dst_hi + r * ld + c8) =
          uint4{h[0], h[1], h[2], h[3]};
      *reinterpret_cast<uint4*>(dst_lo + r * ld + c8) =
          uint4{l[0], l[1], l[2], l[3]};
    }
  }
}

// Unscaled and transposed, dst[col][row], as the two bf16 tiles; rows
// even.
template <typename T>
__device__ __forceinline__ void stage_transposed(uint16_t* dst, uint16_t* lo_dst,
                                                 int ld, const T* src,
                                                 size_t stride, int rows,
                                                 int cols, int valid) {
  const int pairs = rows / 2, total = pairs * (cols / 8);
  for (int i0 = threadIdx.x; i0 < total; i0 += 2 * blockDim.x) {
    float f[2][2][8];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * blockDim.x;
      const int r = 2 * (i % pairs), c8 = (i / pairs) * 8;
      load8(src + r * stride + c8, i < total && r < valid, f[u][0]);
      load8(src + (r + 1) * stride + c8, i < total && r + 1 < valid, f[u][1]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = i0 + u * blockDim.x;
      const int r = 2 * (i % pairs), c8 = (i / pairs) * 8;
      if (i >= total) break;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const uint32_t h = pack(f[u][0][e], f[u][1][e]);
        *reinterpret_cast<uint32_t*>(dst + (c8 + e) * ld + r) = h;
        *reinterpret_cast<uint32_t*>(lo_dst + (c8 + e) * ld + r) =
            pack(f[u][0][e] - lo(h), f[u][1][e] - hi(h));
      }
    }
  }
}

// Lets a kernel take ``bytes`` of dynamic shared memory.
template <typename K>
__host__ __forceinline__ cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace ssd
}  // namespace rtt

// The entry points' common parameters (every field of Args, then the
// batch, the widths P and N, the chunk Q and the stream), and how they
// fill an Args.
#define RTT_SSD_ARGS                                                        \
  const void *x, const void *B, const void *C, const float *dt,             \
      const float *A, const float *dy, float *cs, float *st,                \
      const float *ent, float *y, float *ddec, void *dx, float *ddt,        \
      float *dA, float *dG, float *out, const float *G, long long xs,      \
      long long bs, int b, int S, int H, int P, int N, int Q, int parts,   \
      void *stream

#define RTT_SSD_FILL(a)                                                    \
  a.x = static_cast<const uint16_t*>(x);                                   \
  a.B = static_cast<const uint16_t*>(B);                                   \
  a.C = static_cast<const uint16_t*>(C);                                   \
  a.dt = dt;                                                               \
  a.A = A;                                                                 \
  a.dy = dy;                                                               \
  a.cs = cs;                                                               \
  a.st = st;                                                               \
  a.ent = ent;                                                             \
  a.y = y;                                                                 \
  a.ddec = ddec;                                                           \
  a.dx = static_cast<uint16_t*>(dx);                                       \
  a.ddt = ddt;                                                             \
  a.dA = dA;                                                               \
  a.dG = dG;                                                               \
  a.out = out;                                                             \
  a.G = G;                                                                 \
  a.xs = xs;                                                               \
  a.bs = bs;                                                               \
  a.S = S;                                                                 \
  a.H = H;                                                                 \
  a.parts = parts
