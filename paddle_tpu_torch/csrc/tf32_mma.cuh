// Device helpers shared by the flash-attention kernels (forward and
// backward): fp32-accurate tile products on Hopper's tensor cores in 3xTF32
// (mma.sync.m16n8k8), and the cp.async copies that stream 64-row tiles into
// shared memory. The design notes at the head of flash_attention_fwd.cu and
// flash_attention_bwd.cu say why each piece is there.
//
// Tiles are BLOCK = 64 rows of a [rows, D] fp32 matrix, stored at a pitch
// of DP + 4 floats (DP: D rounded up to 16, 32, 64 or 128); each kernel runs
// THREADS = 128 threads, 4 warps of 16 rows.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK = 64;      // query rows and keys per tile
constexpr int THREADS = 128;   // 4 warps, 16 rows each
constexpr float NEG_BIG = -1e9f;

// -- the tensor-core product -------------------------------------------------

// x = big + small: big is cvt.rna.tf32.f32(x) for a finite x, done in two
// integer operations (the bits hold sign and magnitude apart, so adding
// half the unit of the 13 dropped bits and clearing them rounds the
// magnitude to 10 explicit mantissa bits, ties away from zero; the PTX cvt
// also handles NaN and inf, which these kernels never split, and costs
// several instructions more). small = x - big is exact in fp32; it goes to
// the tensor core as it is, which reads the top 19 bits of a .tf32 operand
// and so rounds small toward zero.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An A fragment (16 x 8) split into its TF32 halves.
struct FragA {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, big[0], small[0]);
    split_tf32(a1, big[1], small[1]);
    split_tf32(a2, big[2], small[2]);
    split_tf32(a3, big[3], small[3]);
  }
};

// A B fragment (8 x 8) split into its TF32 halves.
struct FragB {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, big[0], small[0]);
    split_tf32(b1, big[1], small[1]);
  }
};

// c[n0 + i] += a . b[i] and d[n0 + i] += e . f[i] in 3xTF32, for N
// independent accumulators of each: every small.big term first, then every
// big.small, then every big.big, so that the mmas into one accumulator do
// not wait on each other back to back. (Measured a few percent faster in
// the dK/dV kernel than one 3-term product after another, which also
// spills registers there at D = 128.)
template <int N, int M>
__device__ __forceinline__ void mma3_span2(float (&c)[M][4], const FragA& a,
                                           const FragB (&b)[N],
                                           float (&d)[M][4], const FragA& e,
                                           const FragB (&f)[N], int n0) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(c[n0 + i], a.small, b[i].big);
    mma_tf32(d[n0 + i], e.small, f[i].big);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(c[n0 + i], a.big, b[i].small);
    mma_tf32(d[n0 + i], e.big, f[i].small);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    mma_tf32(c[n0 + i], a.big, b[i].big);
    mma_tf32(d[n0 + i], e.big, f[i].big);
  }
}

// c[n0 + i] += a . b[i] in 3xTF32, in the same order.
template <int N, int M>
__device__ __forceinline__ void mma3_span(float (&c)[M][4], const FragA& a,
                                          const FragB (&b)[N], int n0) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[n0 + i], a.small, b[i].big);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[n0 + i], a.big, b[i].small);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[n0 + i], a.big, b[i].big);
}

// The A fragment of rows [r, r+16) and columns [c, c+8) of a shared tile of
// pitch P: a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4).
template <int P>
__device__ __forceinline__ void load_a(FragA& a, const float* tile, int r,
                                       int c, int g, int t) {
  const float* p = tile + (r + g) * P + c + t;
  a.set(p[0], p[8 * P], p[4], p[8 * P + 4]);
}

// -- asynchronous tile loads -------------------------------------------------

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool live) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(live ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one committed group is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Starts the copy of rows [r0, r0 + 64) of a [rows, D] matrix into a shared
// tile of pitch DP+4; rows past `rows` are zero-filled, columns past D are
// left alone (zero_pad_columns clears them once). `vec`: D is a multiple of
// 4 and src 16-byte aligned, so rows go in 16-byte chunks.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int rows, int D, bool vec) {
  constexpr int P = DP + 4;
  if (vec) {
    constexpr int CPR = DP / 4;   // 16-byte chunks per padded row
#pragma unroll 4
    for (int e = threadIdx.x; e < BLOCK * CPR; e += THREADS) {
      const int r = e / CPR, c = (e % CPR) * 4;
      if (c < D) {
        const bool live = r0 + r < rows;
        cp_async16(dst + r * P + c,
                   live ? src + (size_t)(r0 + r) * D + c : src, live);
      }
    }
  } else {
    for (int e = threadIdx.x; e < BLOCK * DP; e += THREADS) {
      const int r = e / DP, c = e % DP;
      if (c < D) {
        const bool live = r0 + r < rows;
        cp_async4(dst + r * P + c,
                  live ? src + (size_t)(r0 + r) * D + c : src, live);
      }
    }
  }
}

// Starts the copy of entries [i0, i0 + 64) of a vector; entries past n are
// zero-filled.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int i0,
                                         int n) {
  const int i = threadIdx.x;
  if (i < BLOCK) {
    const bool live = i0 + i < n;
    cp_async4(dst + i, live ? src + i0 + i : src, live);
  }
}

// Zeroes columns [D, DP) of `count` consecutive shared tiles (the padding
// of the summation over d; the copies never write there).
template <int DP>
__device__ __forceinline__ void zero_pad_columns(float* tiles, int count,
                                                 int D) {
  constexpr int P = DP + 4;
  const int w = DP - D;
  for (int e = threadIdx.x; e < count * BLOCK * w; e += THREADS) {
    const int row = e / w;   // over all tiles' rows
    tiles[row * P + D + e % w] = 0.f;
  }
}

// The forward's score for (qpos, kpos) from the fp32 accumulator: scale,
// bias, causal positions set to NEG_BIG, keys past Tk at -inf.
__device__ __forceinline__ float masked_score(float acc, float scale, float b,
                                              int qpos, int kpos, int Tk,
                                              int causal) {
  float val = acc * scale + b;
  if (causal && qpos < kpos) val = NEG_BIG;
  if (kpos >= Tk) val = -INFINITY;
  return val;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace
