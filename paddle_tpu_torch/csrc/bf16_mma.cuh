// Device helpers of the bf16 flash-attention kernels (forward and backward):
// bf16 tile products on Hopper's tensor cores (mma.sync.m16n8k16 with fp32
// accumulation), the hi/lo split that carries an fp32 operand (P or dS)
// into them, and the copies that stream 64-row bf16 tiles into shared
// memory. The design notes at the bf16 kernels of flash_attention_fwd.cu
// and flash_attention_bwd.cu say why each piece is there.
//
// Tiles are BLOCK = 64 rows of a [rows, D] bf16 matrix, stored at a pitch of
// DP + 8 bf16 values (DP: D rounded up to 16, 32, 64 or 128): every row
// starts 16-byte aligned, and the fragment loads below hit distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// d += a . b on bf16 operands, fp32 accumulation. A is 16 x 16 (row), B is
// 16 x 8 (col). Fragments, with g = lane / 4 and t = lane % 4 (each 32-bit
// register holds two bf16 values, the lower index in the low half):
//   a[0] = A[g][2t..2t+1]    a[1] = A[g+8][2t..2t+1]
//   a[2] = A[g][2t+8..2t+9]  a[3] = A[g+8][2t+8..2t+9]
//   b[0] = B[2t..2t+1][g]    b[1] = B[2t+8..2t+9][g]
//   d[0..1] = D[g][2t..2t+1] d[2..3] = D[g+8][2t..2t+1]
// A product of two bf16 values is exact in fp32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16 (to nearest, ties to even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two bf16 values from anywhere (a transposed fragment), lo in the low half
__device__ __forceinline__ uint32_t pack_raw(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// An fp32 operand x as x = hi + lo + r: hi = bf16(x), lo = bf16(x - hi)
// (x - hi is exact in fp32). |lo| <= 2^-9 |x| and |r| <= 2^-9 |lo|, so the
// two terms carry x to about 2^-17 of its size: the dropped r is far below
// the bf16 rounding (2^-9) of the outputs these products feed.
__device__ __forceinline__ void split_pair(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - __low2float(h), x1 - __high2float(h));
}

// The A fragment (16 rows x 16 of the summation index) made from the two
// accumulator (C) fragments c0 (index 0..7) and c1 (index 8..15) of an
// m16n8 product, split into hi and lo: a C fragment holds D[g][2t..2t+1]
// and D[g+8][2t..2t+1], which is exactly where the A fragment wants them,
// so the scores become the next product's operand with no shuffle.
__device__ __forceinline__ void c_to_a_split(const float (&c0)[4],
                                             const float (&c1)[4],
                                             uint32_t (&hi)[4],
                                             uint32_t (&lo)[4]) {
  split_pair(c0[0], c0[1], hi[0], lo[0]);
  split_pair(c0[2], c0[3], hi[1], lo[1]);
  split_pair(c1[0], c1[1], hi[2], lo[2]);
  split_pair(c1[2], c1[3], hi[3], lo[3]);
}

// The A fragment of rows [r, r+16) and columns [c, c+16) of a shared tile
// of pitch P (bf16 values): four 32-bit loads.
template <int P>
__device__ __forceinline__ void load_a_bf16(uint32_t (&a)[4], const bf16* tile,
                                            int r, int c, int g, int t) {
  const bf16* p = tile + (r + g) * P + c + 2 * t;
  a[0] = *reinterpret_cast<const uint32_t*>(p);
  a[1] = *reinterpret_cast<const uint32_t*>(p + 8 * P);
  a[2] = *reinterpret_cast<const uint32_t*>(p + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(p + 8 * P + 8);
}

// The B fragment of B = X^T, X a shared tile of pitch P: B's columns
// [n, n+8) are X's rows, its summation index X's columns [c, c+16).
// (The scores Q.K^T, dO.V^T and their transposes read their right-hand
// side this way.) Two 32-bit loads.
template <int P>
__device__ __forceinline__ void load_b_rows(uint32_t (&b)[2], const bf16* tile,
                                            int n, int c, int g, int t) {
  const bf16* p = tile + (n + g) * P + c + 2 * t;
  b[0] = *reinterpret_cast<const uint32_t*>(p);
  b[1] = *reinterpret_cast<const uint32_t*>(p + 8);
}

// The B fragment of B = X, X a shared tile of pitch P: the summation index
// is X's rows [r, r+16), B's columns X's columns [n, n+8). (P.V, dS.K,
// P^T.dO and dS^T.Q read their right-hand side this way.) Four 16-bit
// loads: two rows a thread, one column; the 32 threads hit 16 distinct
// words in 16 distinct banks at every pitch used here.
template <int P>
__device__ __forceinline__ void load_b_cols(uint32_t (&b)[2], const bf16* tile,
                                            int r, int n, int g, int t) {
  const bf16* p = tile + (r + 2 * t) * P + n + g;
  b[0] = pack_raw(p[0], p[P]);
  b[1] = pack_raw(p[8 * P], p[9 * P]);
}

// -- tile copies -------------------------------------------------------------

// How a tile's rows can be copied: 16-byte cp.async chunks (D a multiple of
// 8, bases 16-byte aligned), 4-byte ones (D even, bases 4-byte aligned), or
// plain element copies.
enum CopyMode { COPY_ELEM = 0, COPY_4 = 1, COPY_16 = 2 };

__device__ __forceinline__ void cp_async16_raw(void* dst, const void* src,
                                               bool live) {
  cp_async16(static_cast<float*>(dst), static_cast<const float*>(src), live);
}

__device__ __forceinline__ void cp_async4_raw(void* dst, const void* src,
                                              bool live) {
  cp_async4(static_cast<float*>(dst), static_cast<const float*>(src), live);
}

// Starts the copy of rows [r0, r0 + 64) of a [rows, D] bf16 matrix into a
// shared tile of pitch DP+8; rows past `rows` are zero-filled, columns past
// D are left alone (zero_pad_bf16 clears them once). COPY_ELEM copies
// synchronously; the barrier before the tile's first use orders it as it
// orders the asynchronous copies.
template <int DP>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* src,
                                               int r0, int rows, int D,
                                               int mode) {
  constexpr int P = DP + 8;
  if (mode == COPY_16) {
    constexpr int CPR = DP / 8;   // 16-byte chunks per padded row
#pragma unroll 4
    for (int e = threadIdx.x; e < BLOCK * CPR; e += THREADS) {
      const int r = e / CPR, c = (e % CPR) * 8;
      if (c < D) {
        const bool live = r0 + r < rows;
        cp_async16_raw(dst + r * P + c,
                       live ? src + (size_t)(r0 + r) * D + c : src, live);
      }
    }
  } else if (mode == COPY_4) {
    constexpr int CPR = DP / 2;
    for (int e = threadIdx.x; e < BLOCK * CPR; e += THREADS) {
      const int r = e / CPR, c = (e % CPR) * 2;
      if (c < D) {
        const bool live = r0 + r < rows;
        cp_async4_raw(dst + r * P + c,
                      live ? src + (size_t)(r0 + r) * D + c : src, live);
      }
    }
  } else {
    for (int e = threadIdx.x; e < BLOCK * DP; e += THREADS) {
      const int r = e / DP, c = e % DP;
      if (c < D)
        dst[r * P + c] = r0 + r < rows ? src[(size_t)(r0 + r) * D + c]
                                       : __float2bfloat16(0.f);
    }
  }
}

// Zeroes columns [D, DP) of `count` consecutive shared bf16 tiles (the
// padding of the summation over d; the copies never write there).
template <int DP>
__device__ __forceinline__ void zero_pad_bf16(bf16* tiles, int count, int D) {
  constexpr int P = DP + 8;
  const int w = DP - D;
  for (int e = threadIdx.x; e < count * BLOCK * w; e += THREADS) {
    const int row = e / w;   // over all tiles' rows
    tiles[row * P + D + e % w] = __float2bfloat16(0.f);
  }
}

// The copy mode every [*, D] operand of a launch allows.
__host__ __forceinline__ int copy_mode(int D, const void* a, const void* b,
                                       const void* c, const void* d) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c) |
                        reinterpret_cast<uintptr_t>(d);
  if (D % 8 == 0 && (any & 15) == 0) return COPY_16;
  if (D % 2 == 0 && (any & 3) == 0) return COPY_4;
  return COPY_ELEM;
}

}  // namespace
