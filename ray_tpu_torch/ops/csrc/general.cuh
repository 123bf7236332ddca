// Shared by the general flash kernels K4-K6 (flash_fwd_general.cu,
// flash_bwd_dq_general.cu, flash_bwd_dkdv_general.cu).
//
// They take what K1-K3 do not: fp32 as well as bf16 and fp16, and any
// head_dim from 1 to 256, as the Pallas kernels they replace compute every
// dtype and head_dim in their own body. They run on the CUDA cores and
// every product and sum is fp32: the card holds them to 1e-5 of the plain
// versions in fp32, which TF32 cannot meet.
//
// The three share one shape. A block of four warps owns BM rows of one
// (b, h) and streams the other operand through shared memory in tiles of
// BN rows (Tile): a thread holds a TM x TN micro-tile of each score tile
// (S, dP, or their transposes) and a TM x 4 DL micro-tile of each output
// (columns 32 e + 4 cg + c), all in registers, so every product is an
// outer product over shared memory:
//   - a score tile takes 4 head-dim columns a step (row_products): one
//     16-byte load (8 for 16-bit, widened to fp32) per row of either
//     operand feeds 4 TM TN FMAs; both operands stay row-major, the layout
//     cp.async fills, and smem_ld pads rows so that the 8 rows a load
//     instruction touches hit 8 bank groups;
//   - an output tile reads its scores back from a per-warp slice of shared
//     memory, the thread's TM rows adjacent, one vector per streamed row
//     beside DL 16-byte loads of the operand (acc_products).
// Tiles are copied by cp.async (copy_plan, copy_rows: 16 bytes where the
// rows and every streamed pointer allow, copy_size; 4 otherwise; element
// by element for 16-bit inputs at odd head dims), staggered against the
// products so that a copy lands while another operand is read. Columns D
// to D rounded up to 4 are zeros (zero_pad). DL = ceil(D / 32) rounded to a
// power of two picks the instantiation (RTT_GENERAL_DISPATCH).
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
constexpr int kMaxDL = 8;                     // head_dim <= 256
constexpr float kMasked = -1e30f;             // the reference's causal mask
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

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

// ``Bytes`` from global to shared memory without a register stage
// (cp.async; 16-byte copies bypass L1), or zeros where !valid. They land
// by cp_async_wait_all. Without the device compiler (a host build of
// these sources, as the CPU harness of the tests makes) the copy is done
// at once, a misaligned one as NaNs, and the wait is a no-op.
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
  // The card faults on a misaligned copy, or reads wrong bytes; here it
  // reads as NaNs.
  const bool aligned = (reinterpret_cast<size_t>(dst) |
                        reinterpret_cast<size_t>(src)) % Bytes == 0;
  if (valid && aligned)
    memcpy(dst, src, Bytes);
  else
    memset(dst, valid ? 0xff : 0, Bytes);
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

// A block's tiling. Lane l of warp w is in row group rg = l / 8 and
// column group cg = l % 8; its TM rows are w 4 TM + rg + 4 a (a < TM), its
// TN columns of a tile cg + 8 b (b < TN), and its rows sit side by side in
// a score slice from w 4 TM + rg TM. LDP is that slice's row stride.
template <int TM_, int TN_>
struct Tile {
  static constexpr int TM = TM_;       // owned rows a thread
  static constexpr int TN = TN_;       // streamed rows a thread, a tile
  static constexpr int BM = 16 * TM;   // 4 warps x 4 row groups
  static constexpr int BN = 8 * TN;    // 8 column groups
  static constexpr int LDP = BM + 4;   // floats
};

// K4's: query rows by keys, fewer of each where DL's columns of O take the
// registers. K6 takes its rows (flash_bwd_dq_general.cu).
template <int DL>
using FwdTile = Tile<DL == 8 ? 2 : 4, DL >= 4 ? 4 : 8>;

// The copy size (16 or 4 bytes) that every row (``row`` bytes) of the
// streamed tensors is made of and that all their addresses are aligned
// to; 0 for none (16-bit inputs at an odd head_dim, or misaligned views).
template <typename... P>
int copy_size(size_t row, const P*... ptrs) {
  const size_t addr = (row | ... | reinterpret_cast<size_t>(ptrs));
  return addr % 16 == 0 ? 16 : addr % 4 == 0 ? 4 : 0;
}

// Columns D up to D rounded to 4 of ``rows`` tile rows from ``tile``, ``ld``
// apart: zeros, read by the 4-column steps; no copy writes them.
template <typename T>
__device__ __forceinline__ void zero_pad(T* tile, int ld, int rows, int D) {
  const int pad = ((D + 3) & ~3) - D;
  if (pad == 0) return;
  for (int i = threadIdx.x; i < rows * pad; i += kThreads)
    tile[(i / pad) * ld + D + i % pad] = from_f<T>(0.f);
}

// s[a][b] = sum over d < D4 of A[4 a][d] B[8 b][d] (rows ``ld`` apart in
// shared memory): a thread's TM x TN scores, 4 head-dim columns a step.
template <int DL, int TM, int TN, typename T>
__device__ __forceinline__ void row_products(float (&s)[TM][TN], const T* A,
                                             const T* B, int ld, int D4) {
#pragma unroll
  for (int a = 0; a < TM; ++a)
#pragma unroll
    for (int b = 0; b < TN; ++b) s[a][b] = 0.f;
#pragma unroll
  for (int d = 0; d < 32 * DL; d += 4) {
    if (d >= D4) break;
    float af[TM][4], bf[TN][4];
#pragma unroll
    for (int a = 0; a < TM; ++a) load_vec<4>(af[a], A + 4 * a * ld + d);
#pragma unroll
    for (int b = 0; b < TN; ++b) load_vec<4>(bf[b], B + 8 * b * ld + d);
#pragma unroll
    for (int c = 0; c < 4; ++c)
#pragma unroll
      for (int a = 0; a < TM; ++a)
#pragma unroll
        for (int b = 0; b < TN; ++b)
          s[a][b] = fmaf(af[a][c], bf[b][c], s[a][b]);
  }
}

// acc[a][e][c] += sum over j < N of P[j][a] X[j][32 e + c]: P's rows ``ldp``
// floats apart (the thread's TM scores adjacent), X's ``ld`` elements apart
// and already offset to the thread's columns (4 cg), of which the first
// ``cols`` are read.
template <int N, int DL, int TM, typename T>
__device__ __forceinline__ void acc_products(float (&acc)[TM][DL][4],
                                             const float* P, int ldp,
                                             const T* X, int ld, int cols) {
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float pf[TM];
    load_vec<TM>(pf, P + j * ldp);
#pragma unroll
    for (int e = 0; e < DL; ++e) {
      if (32 * e < cols) {
        float xf[4];
        load_vec<4>(xf, X + j * ld + 32 * e);
#pragma unroll
        for (int a = 0; a < TM; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            acc[a][e][c] = fmaf(pf[a], xf[c], acc[a][e][c]);
      }
    }
  }
}

// A thread's TM x 4 DL output tile (its rows 4 apart) as T into a
// row-major [*, D] matrix: ``out`` points at its first row, column col0 (4
// cg); rows from ``rows`` on and columns from D on are left out.
template <int DL, int TM, typename T>
__device__ __forceinline__ void store_rows(T* out,
                                           const float (&acc)[TM][DL][4],
                                           int rows, int D, int col0) {
#pragma unroll
  for (int a = 0; a < TM; ++a) {
    if (4 * a >= rows) break;
#pragma unroll
    for (int e = 0; e < DL; ++e)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 32 * e + col0 + c;
        if (col < D) out[static_cast<size_t>(4 * a) * D + 32 * e + c] =
            from_f<T>(acc[a][e][c]);
      }
  }
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
