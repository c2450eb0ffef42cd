// Hopper building blocks of the bf16 flash-attention kernels, the forward
// (flash_attention_fwd.cu) and the backward pair (flash_attention_bwd.cu):
// warpgroup tile products (wgmma.mma_async, bf16 in, fp32 accumulate), the
// hi/lo split that carries an fp32 operand (P or dS) into them from the
// accumulator registers, tiles copied by the Tensor Memory Accelerator (TMA)
// into 128-byte-swizzled shared memory and completed on an mbarrier, the
// copies that write the same layout where the TMA cannot, and the host-side
// tensor maps that describe the operands to the TMA. The design notes at
// the bf16 kernels of both sources say why each piece is there.
//
// The tile layout. A tile is 64 rows of a [rows, D] bf16 matrix with D
// padded to DP = 64 or 128 columns, stored as DP / 64 column blocks of
// [64 rows][64 bf16] (8 KB each, 1024-byte aligned). Row r of a block is
// 128 bytes at r * 128, and its 16-byte chunk c sits at chunk c ^ (r % 8):
// the SWIZZLE_128B pattern the TMA writes and the wgmma descriptors below
// read. The copies that take over where the TMA cannot (load_tile_swz)
// write the same layout.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int CB_BYTES = 64 * 128;   // one [64][64] bf16 column block

template <int DP>
__host__ __device__ constexpr int tile_bytes() {
  return DP / 64 * CB_BYTES;
}

// byte offset of element (r, c) of a tile in the swizzled layout
__device__ __forceinline__ int swz_offset(int r, int c) {
  return (c >> 6) * CB_BYTES + r * 128 +
         ((((c >> 3) & 7) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (smem_u32(p) & 1023)) & 1023);
}

// -- mbarriers and the TMA ---------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

// makes the initialised barriers visible to the TMA unit
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also sets the bytes the barrier's phase waits for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// one arrival
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// one arrival once every cp.async this thread has started has landed (the
// barrier's count includes it)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// waits until the barrier's phase `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  } while (!done);
}

// the box at (c0, c1, c2) of a 3-D tensor map into shared memory; its bytes
// complete on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            int c0, int c1, int c2,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0),
         "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Starts the TMA copy of the 64-row tile at row r0 of (b, h) = bh: DP / 64
// boxes, one a column block.
template <int DP>
__device__ __forceinline__ void tma_tile(unsigned char* dst,
                                         const CUtensorMap* map, int r0,
                                         int bh, uint64_t* bar) {
#pragma unroll
  for (int cb = 0; cb < DP / 64; ++cb)
    tma_load_3d(dst + cb * CB_BYTES, map, 64 * cb, r0, bh, bar);
}

// orders this thread's generic-proxy writes to shared memory (stores,
// cp.async) before later async-proxy reads of it (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// -- wgmma -------------------------------------------------------------------

// A shared-memory matrix descriptor for the 128-byte-swizzled layout:
// start address, leading and stride byte offsets (16-byte units), layout
// type 1 (SWIZZLE_128B) in bits 62-63. K-major operands (the summation index
// along a 128-byte row) use lbo 16 (unused) and sbo 1024, the step between
// groups of 8 rows; a k-step of 16 inside a column block moves the start by
// 32 bytes, which the hardware swizzles as the TMA did. MN-major operands
// (the summation index down the rows) use sbo 1024, the step between groups
// of 8 summation rows, and lbo CB_BYTES, the step between column blocks.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return wgmma_desc(addr, 16, 1024);
}

__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return wgmma_desc(addr, CB_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Pins the compiler's view of accumulator registers: the products write
// them asynchronously, so no access may move across the wait (or the
// issue) that brackets them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e]) :: "memory");
}

// The products. Every thread of the warpgroup holds d in the m16n8 C
// layout of its warp's 16 rows (warp w: rows 16w + g and 16w + g + 8, with
// g = lane / 4, t = lane % 4): d[j][0..1] at columns 8j + 2t, 8j + 2t + 1
// of row 16w + g, d[j][2..3] at the same columns of row 16w + g + 8.

// d (+)= A.B^T, m64n64k16: A [64 x 16] and B [64 x 16], both K-major in
// shared memory (descriptors); accumulate 0 overwrites d.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A.B^T, m64n32k16: as the m64n64k16 wgmma_ss with B [32 x 16].
__device__ __forceinline__ void wgmma_ss(float (&d)[4][4], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A.B, m64n64k16: A [64 x 16] from registers (each warp's 16 rows as
// the A fragment of mma.m16n8k16, which c_to_a_split makes from two C
// fragments), B [16 x 64] MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// -- the hi/lo split ----------------------------------------------------------

// two floats rounded to bf16 (to nearest, ties to even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
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

// e^x as 2^(x log2 e) on MUFU.EX2, flushing denormal results to 0 (-inf
// gives 0). x is a difference taken first (s - lse, s - m, m_old - m_new):
// a row whose every key the bias masks has s, m and lse all near -1e9,
// where fp32 steps by 64, and only their difference is small; folding
// log2 e into each term first would overflow.
__device__ __forceinline__ float exp_of(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// Columns [col, col + 2) of an output row (O, dQ, dK or dV) to bf16: a
// pair of a C fragment; col is even.
__device__ __forceinline__ void store_pair(bf16* row, int col, int D,
                                           float x0, float x1) {
  if ((D & 1) == 0) {
    if (col < D)
      *reinterpret_cast<__nv_bfloat162*>(row + col) =
          __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < D) row[col] = __float2bfloat16(x0);
    if (col + 1 < D) row[col + 1] = __float2bfloat16(x1);
  }
}

// -- copies where the TMA cannot ----------------------------------------------

// How a launch's kernels fill their tiles: by the TMA (D a multiple of 8,
// every bf16 base 16-byte aligned: the Transformer's case), else the
// block's threads write the same swizzled layout with 4-byte cp.async
// copies (D even, bases 4-byte aligned) or element copies. The mode follows
// from shape and alignment alone.
enum CopyMode { COPY_ELEM = 0, COPY_4 = 1, MODE_TMA = 3 };

__host__ __forceinline__ int bf16_tile_mode(int D, const void* a,
                                            const void* b, const void* c,
                                            const void* d) {
  const uintptr_t any = reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b) |
                        reinterpret_cast<uintptr_t>(c) |
                        reinterpret_cast<uintptr_t>(d);
  if (D % 8 == 0 && (any & 15) == 0) return MODE_TMA;
  if (D % 2 == 0 && (any & 3) == 0) return COPY_4;
  return COPY_ELEM;
}

// Starts the copy of rows [r0, r0 + 64) of a [rows, D] bf16 matrix into a
// swizzled tile, by NTHREADS threads (tid of them: this one), COPY_4 or
// COPY_ELEM; rows past `rows` are zero-filled, columns past D keep the
// zeros zero_smem wrote. COPY_ELEM copies synchronously.
template <int DP, int NTHREADS>
__device__ __forceinline__ void load_tile_swz(unsigned char* dst,
                                              const bf16* src, int r0,
                                              int rows, int D, int mode,
                                              int tid) {
  if (mode == COPY_4) {
    constexpr int CPR = DP / 2;
    for (int e = tid; e < BLOCK * CPR; e += NTHREADS) {
      const int r = e / CPR, c = (e % CPR) * 2;
      if (c < D) {
        const bool live = r0 + r < rows;
        cp_async4(reinterpret_cast<float*>(dst + swz_offset(r, c)),
                  reinterpret_cast<const float*>(
                      live ? src + (size_t)(r0 + r) * D + c : src),
                  live);
      }
    }
  } else {
    for (int e = tid; e < BLOCK * DP; e += NTHREADS) {
      const int r = e / DP, c = e % DP;
      if (c < D)
        *reinterpret_cast<bf16*>(dst + swz_offset(r, c)) =
            r0 + r < rows ? src[(size_t)(r0 + r) * D + c]
                          : __float2bfloat16(0.f);
    }
  }
}

// zeroes `bytes` (a multiple of 16) of shared memory, by the block's
// NTHREADS threads
template <int NTHREADS>
__device__ __forceinline__ void zero_smem(unsigned char* p, int bytes) {
  for (int i = 16 * threadIdx.x; i < bytes; i += 16 * NTHREADS)
    *reinterpret_cast<uint4*>(p + i) = make_uint4(0, 0, 0, 0);
}

// -- tensor maps (host) ------------------------------------------------------

// cuTensorMapEncodeTiled, a driver function, taken from the driver through
// the runtime's entry-point query, so the library links against the runtime
// alone (no -lcuda).
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle,
                                  CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled_fn() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The tensor map of a contiguous [BH, T, D] bf16 tensor, D % 8 == 0 and
// the base 16-byte aligned, in boxes of [1, 64, 64] landing as one
// swizzled column block: rows past T and columns past D arrive as zeros.
// Returns a cudaError_t.
int make_tile_map(CUtensorMap* map, const void* base, int BH, int T, int D) {
  const EncodeTiledFn encode = encode_tiled_fn();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {64, 64, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
      dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

}  // namespace
