// Flash-attention forward for Hopper (sm_90a): fp32 in and out, tile
// products on the tensor cores in 3xTF32; and its bf16 variant (at the end
// of the file), bf16 in and out, bf16 tile products.
//
// Replaces the TPU kernel paddle_tpu/ops/flash_attention.py:_fwd_call
// (:311-358): both of its Pallas grids over the one body _fwd_body (:99-138)
// — the rectangular grid (_fwd_kernel :141, pallas_call :342) and the causal
// lower-triangle grid (_fwd_kernel_tri :150, pallas_call :328) — become this
// ONE kernel.
//
// What it computes, per (b, h) and query row:
//   s[k]  = (q * scale) . k[k] + bias[b, k]       (scale on q first, :109)
//   s[k]  = NEG_BIG (-1e9)  where causal and qpos < kpos   (set, not added)
//   s[k]  = -inf            where kpos >= Tk      (P = 0)
//   O     = softmax(s) . V,  lse = m + log(l)
// with the online softmax of FlashAttention-2: running max m (starts at
// -1e30), running sum l (clamped at 1e-30 in the epilogue) and accumulator.
// Inputs q [B, H, Tq, D], k, v [B, H, Tk, D], bias [B, Tk], all contiguous
// fp32; outputs O [B, H, Tq, D] and lse [B, H, Tq] fp32 (the backward and
// ring attention read the lse).
//
// What bounds it on the H100. The work is 4 * B * H * D * pairs FLOPs (two
// tile products of depth D per (query, key) pair, pairs counting those a
// causal mask leaves) against the bytes of q, k, v, bias, O and lse read or
// written once: at T = 256, D = 64 that is T / 4 = 64 FLOPs a byte, far above
// the card's ridge, so it is bound by arithmetic. fp32 FFMA on the CUDA cores
// peaks at 67 TFLOP/s; the tensor cores take TF32 at 495 TFLOP/s, and three
// TF32 products per fp32 product (3xTF32, below) give fp32-level accuracy at
// 495 / 3 = 165 TFLOP/s: that is the bound this kernel is held to. The data
// sheet's 495 is wgmma's; mma.sync's tf32 rate on this card measures about
// two thirds of it (tools/torch_mma_peak.py), and before that ceiling
// instruction issue binds, as in the backward (flash_attention_bwd.cu):
// every B fragment a warp reads is loaded from shared memory and split into
// its TF32 halves by that warp, about 4 instructions a value beside the 3
// mma instructions per fragment.
//
// What the design does about it:
//   * 3xTF32 on the tensor cores. Both tile products, s = (q*scale).K^T and
//     O += P.V, are mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 (inline PTX,
//     tf32_mma.cuh). Each fp32 operand x is split into big = x rounded to
//     TF32 (to nearest, ties away) and small = x - big, which the tensor
//     core reads rounded toward zero; a.b is summed in fp32 as
//     a_small.b_big + a_big.b_small + a_big.b_big, small terms first. The
//     dropped a_small.b_small is about 2^-22 of the product: fp32-level, as
//     CUTLASS's OpMultiplyAddFastF32. One TF32 product alone keeps 11
//     significant bits: on a score near 10 it would move the lse by about
//     5e-4 relative, and the backward recomputes P = exp(s - lse) from it.
//   * mma.sync and not wgmma. For .tf32, wgmma reads both operands K-major
//     from shared memory. s = Q.K^T has them so, but P.V sums over V's row
//     index: it would need a transposed copy of V, and P and the big/small
//     halves of every operand would have to be staged in shared memory.
//     mma.sync reads its fragments from registers, so each thread splits
//     what it loads, and P never leaves the registers (below).
//   * Each of the 4 warps owns one or two 16-row strips of query rows (a
//     block has 64 or 128 rows). The B fragments of K and V a warp loads and
//     splits serve every strip it owns, so two strips halve the split work
//     per product. Without causal masking every block does the same work,
//     and two strips a warp measure faster (PERF.md); under causal masking a
//     block's work grows with its query tile, and one strip a warp (64-row
//     blocks, twice as many, longest first) balances the grid better.
//   * Q is resident for the whole key loop. With one strip at D <= 64, each
//     warp splits its strip of q*scale into TF32 halves once, before the
//     loop (64 registers a thread at D = 64); with two strips, or at
//     D = 128, that would take 128 registers, so there the strips are split
//     again from shared memory at each use. The strips of s for the current
//     keys and the D-wide output accumulators stay in registers (keys 64 at
//     a time, 32 at D = 128).
//   * P never leaves the registers. s comes out of the first product as
//     accumulator (C) fragments: thread (g, t) holds rows g, g+8 at key
//     columns 2t, 2t+1 of each step of 8 keys. The online softmax works on
//     them in place: the row max and the row sum reduce over the 4 threads
//     of a quad (__shfl_xor_sync 1, 2; the sum only once, in the epilogue,
//     each thread carrying its own columns' share of l), P = __expf(s - m)
//     (ex2.approx, within a few ulp of expf), and the O accumulators are
//     rescaled by alpha = __expf(m_old - m_new). A C fragment is not an A
//     fragment (A rows g, g+8 at columns t, t+4), so the summation index of
//     P.V is permuted instead: A position t stands for key 2t and t+4 for
//     2t+1, and V's B fragment rows (b0 row t, b1 row t+4) are loaded from
//     those same keys. The C fragment (c0, c1, c2, c3) is then the A
//     fragment (c0, c2, c1, c3), with no shuffle and no shared-memory trip.
//   * Asynchronous, double-buffered tiles. Q loads once; K, V and the bias
//     stream through a 2-stage cp.async ring, so tile t+1 is in flight while
//     tile t is multiplied, with one barrier a tile (the copies of tile t+1
//     start after the barrier that ends every warp's use of tile t-1).
//     16-byte cp.async.cg chunks with the zero-fill size operand for rows
//     past Tk (or Tq); 4-byte cp.async.ca copies where D is not a multiple
//     of 4 or a base is not 16-byte aligned.
//     Shared rows are padded to DP+4 floats; the columns past D hold zeros
//     (zeroed once), which pads the summation over d. The pitch keeps every
//     row 16-byte aligned, and with the permuted rows above every fragment
//     load (8 rows x 4 columns, or 4 row pairs x 8 columns) hits 32 distinct
//     banks. 5 tiles (6 with two strips): 87.5 KB (104 KB) at D = 64, two
//     blocks an SM.
//   * Causal masking: the key loop stops at the tile holding the query
//     tile's last diagonal key; tiles above the diagonal are never loaded or
//     multiplied (the TPU needs its separate triangular grid for that). A
//     block's work then grows with its query tile: blockIdx.x runs over
//     (b, h) and blockIdx.y over the query tiles, last (longest) first, so
//     the tail of the grid is short.
//   * Ragged edges from Tq and Tk, with no padding copies: keys past Tk load
//     as zeros and score -inf (an exact zero weight; the TPU's padded keys
//     carry NEG_BIG, which differs only on rows whose every key is masked);
//     query rows past Tq load as zeros and are never stored.
//   * The epilogue: O = acc / l leaves from the C fragments as 2-float
//     stores (scalar ones where D is odd), and one thread of each quad
//     writes the lse. Every block owns its rows and sums in a fixed order,
//     so two launches on the same inputs give the same bits.
//
// A row whose every key is masked (the bias puts -1e9 on each) has scores
// near -1e9, so its m is near -1e9 and it averages V over the keys the loop
// visits, with weights that depend on the rounding of s near -1e9 (where
// the fp32 spacing is 64): under causal masking the loop stops at the
// diagonal tile, so such a row averages a different key set than one
// softmax over all keys. Such a row is ill-conditioned in every
// implementation (the JAX kernel and its oracle included), real pad masks
// never build one (a sequence's first key is live), and the tests leave it
// out.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_bf16.cuh"
#include "port_cuda.cuh"
#include "tf32_mma.cuh"

namespace {

constexpr float M_INIT = -1e30f;

template <int DP, int STRIPS>
constexpr int fwd_smem_floats() {
  // the resident Q tiles (STRIPS of them), K and V tiles x 2 stages, each
  // [64][DP+4]; the bias ring, 2 x 64
  return (STRIPS + 4) * BLOCK * (DP + 4) + 2 * BLOCK;
}

// over the 4 threads of a quad (lanes 4g .. 4g+3), which hold one row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// The A fragment of q * scale, rows [r, r+16) and columns [c, c+8) of the
// shared Q tile (pitch P), split into its TF32 halves.
template <int P>
__device__ __forceinline__ void load_q(FragA& a, const float* tile, int r,
                                       int c, int g, int t, float scale) {
  const float* p = tile + (r + g) * P + c + t;
  a.set(p[0] * scale, p[8 * P] * scale, p[4] * scale, p[8 * P + 4] * scale);
}

// DP: the head dim D rounded up to 16, 32, 64 or 128; STRIPS: 16-row
// strips a warp owns (the block has 64 * STRIPS query rows).
template <int DP, int STRIPS>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ bias,
           float* __restrict__ o, float* __restrict__ lse, int H, int Tq,
           int Tk, int D, float scale, int causal, int vec) {
  constexpr int P = DP + 4;
  constexpr int TILE = BLOCK * P;
  constexpr int ROWS = BLOCK * STRIPS;     // query rows of the block
  constexpr bool QREG = STRIPS == 1 && DP <= 64;  // Q's halves in registers
  constexpr int NC = DP >= 128 ? 32 : 64;  // keys in registers at a time
  constexpr int NT = NC / 8;               // key steps of 8 in a chunk
  constexpr int DT = DP / 8;               // d steps of 8
  constexpr int NG = DT >= 4 ? 4 : DT;     // B fragments per mma3_span
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                   // [STRIPS][TILE]
  float* Ks = Qs + STRIPS * TILE;     // [2][TILE]
  float* Vs = Ks + 2 * TILE;          // [2][TILE]
  float* Bs = Vs + 2 * TILE;          // [2][BLOCK]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * STRIPS * warp;      // the warp's first strip
  const size_t bh = blockIdx.x;
  const int b = (int)(bh / H);
  // the query tile: the last (longest under causal masking) first
  const int q0 = ((Tq + ROWS - 1) / ROWS - 1 - (int)blockIdx.y) * ROWS;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;
  const float* biasb = bias + (size_t)b * Tk;
  const bool vec16 = vec != 0;

  if (D < DP) zero_pad_columns<DP>(smem, STRIPS + 4, D);
#pragma unroll
  for (int i = 0; i < STRIPS; ++i)
    load_tile<DP>(Qs + i * TILE, q + bh * Tq * D, q0 + i * BLOCK, Tq, D,
                  vec16);

  int n_tiles = (Tk + BLOCK - 1) / BLOCK;
  if (causal) {
    // the last key any row of this tile may attend to is its last row's
    const int last_row = min(q0 + ROWS, Tq) - 1;
    n_tiles = min(n_tiles, last_row / BLOCK + 1);
  }
  load_tile<DP>(Ks, kb, 0, Tk, D, vec16);
  load_tile<DP>(Vs, vb, 0, Tk, D, vec16);
  load_vec(Bs, biasb, 0, Tk);
  cp_async_commit();

  FragA qf[QREG ? DT : 1];
  float acc[STRIPS][DT][4];
#pragma unroll
  for (int st = 0; st < STRIPS; ++st)
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[st][n][e] = 0.f;
  // rows g and g+8 of each strip: running max, and this thread's share of
  // the running sum (its own key columns)
  float m_r[STRIPS][2], l_r[STRIPS][2];
  int qpos[STRIPS][2];
#pragma unroll
  for (int st = 0; st < STRIPS; ++st)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_r[st][h] = M_INIT;
      l_r[st][h] = 0.f;
      qpos[st][h] = q0 + row0 + 16 * st + g + 8 * h;
    }

  for (int it = 0; it < n_tiles; ++it) {
    cp_async_wait_all();    // tile it (and Q) have landed for this thread
    // ... and for every thread; and every warp is done with tile it - 1,
    // whose stage the copies of tile it + 1 overwrite
    __syncthreads();
    const int k0 = it * BLOCK;
    if (it + 1 < n_tiles) {
      const int nxt = (it + 1) & 1, k1 = k0 + BLOCK;
      load_tile<DP>(Ks + nxt * TILE, kb, k1, Tk, D, vec16);
      load_tile<DP>(Vs + nxt * TILE, vb, k1, Tk, D, vec16);
      load_vec(Bs + nxt * BLOCK, biasb, k1, Tk);
      cp_async_commit();
    }
    if constexpr (QREG) {
      if (it == 0) {
#pragma unroll
        for (int ks = 0; ks < DT; ++ks)
          load_q<P>(qf[ks], Qs, row0, 8 * ks, g, t, scale);
      }
    }
    const float* Kt = Ks + (it & 1) * TILE;
    const float* Vt = Vs + (it & 1) * TILE;
    const float* Bt = Bs + (it & 1) * BLOCK;

#pragma unroll 1
    for (int c0 = 0; c0 < BLOCK; c0 += NC) {
      // s = (q*scale).K^T over this chunk's keys
      float s[STRIPS][NT][4];
#pragma unroll
      for (int st = 0; st < STRIPS; ++st)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[st][j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DT; ++ks) {
        FragA qa[STRIPS];
#pragma unroll
        for (int st = 0; st < STRIPS; ++st) {
          if constexpr (QREG)
            qa[st] = qf[ks];
          else
            load_q<P>(qa[st], Qs, row0 + 16 * st, 8 * ks, g, t, scale);
        }
#pragma unroll
        for (int j = 0; j < NT; j += 4) {
          FragB kf[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int at = (c0 + 8 * (j + i) + g) * P + 8 * ks + t;
            kf[i].set(Kt[at], Kt[at + 4]);
          }
          if constexpr (STRIPS == 2)
            mma3_span2(s[0], qa[0], kf, s[1], qa[1], kf, j);
          else
            mma3_span(s[0], qa[0], kf, j);
        }
      }
      // the online softmax, in place: C element e sits at row
      // g + 8 (e >> 1), key column 8j + 2t + (e & 1); s becomes P
#pragma unroll
      for (int st = 0; st < STRIPS; ++st) {
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 8 * j + 2 * t + (e & 1);
            const int h = e >> 1;
            // scale is already on q: masked_score's factor is 1
            s[st][j][e] = masked_score(s[st][j][e], 1.f, Bt[col],
                                       qpos[st][h], k0 + col, Tk, causal);
            mx[h] = fmaxf(mx[h], s[st][j][e]);
          }
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float m_new = fmaxf(m_r[st][h], quad_max(mx[h]));
          alpha[h] = __expf(m_r[st][h] - m_new);
          m_r[st][h] = m_new;
          l_r[st][h] *= alpha[h];
        }
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int h = e >> 1;
            s[st][j][e] = __expf(s[st][j][e] - m_r[st][h]);
            l_r[st][h] += s[st][j][e];
          }
#pragma unroll
        for (int n = 0; n < DT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[st][n][e] *= alpha[e >> 1];
      }
      // O += P.V: key step j's A fragment is (c0, c2, c1, c3) of s[j],
      // position t standing for key 2t and t+4 for key 2t+1
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        FragA pa[STRIPS];
#pragma unroll
        for (int st = 0; st < STRIPS; ++st)
          pa[st].set(s[st][j][0], s[st][j][2], s[st][j][1], s[st][j][3]);
        const float* v_even = Vt + (c0 + 8 * j + 2 * t) * P + g;
#pragma unroll
        for (int n = 0; n < DT; n += NG) {
          FragB vf[NG];
#pragma unroll
          for (int i = 0; i < NG; ++i)
            vf[i].set(v_even[8 * (n + i)], v_even[P + 8 * (n + i)]);
          if constexpr (STRIPS == 2)
            mma3_span2(acc[0], pa[0], vf, acc[1], pa[1], vf, n);
          else
            mma3_span(acc[0], pa[0], vf, n);
        }
      }
    }
  }

#pragma unroll
  for (int st = 0; st < STRIPS; ++st)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float l = fmaxf(quad_sum(l_r[st][h]), 1e-30f);
      if (qpos[st][h] >= Tq) continue;
      float* orow = o + (bh * Tq + qpos[st][h]) * D;
#pragma unroll
      for (int n = 0; n < DT; ++n) {
        const int col = 8 * n + 2 * t;
        const float o0 = acc[st][n][2 * h] / l;
        const float o1 = acc[st][n][2 * h + 1] / l;
        if (D % 2 == 0) {
          if (col < D)
            *reinterpret_cast<float2*>(orow + col) = make_float2(o0, o1);
        } else {
          if (col < D) orow[col] = o0;
          if (col + 1 < D) orow[col + 1] = o1;
        }
      }
      if (t == 0) lse[bh * Tq + qpos[st][h]] = m_r[st][h] + logf(l);
    }
}

// 16-byte copies need D a multiple of 4 and q, k, v 16-byte aligned (a
// contiguous view may start anywhere in its storage)
int vec_ok(const float* q, const float* k, const float* v, int D) {
  return D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
}

template <int DP, int STRIPS>
int launch(const float* q, const float* k, const float* v, const float* bias,
           float* o, float* lse, int B, int H, int Tq, int Tk, int D,
           float scale, int causal, cudaStream_t stream) {
  const int smem = fwd_smem_floats<DP, STRIPS>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<DP, STRIPS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + BLOCK * STRIPS - 1) / (BLOCK * STRIPS));
  fwd_kernel<DP, STRIPS><<<grid, THREADS, smem, stream>>>(
      q, k, v, bias, o, lse, H, Tq, Tk, D, scale, causal,
      vec_ok(q, k, v, D));
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes by paddle_tpu_torch/ops/flash_attention.py).
// Returns cudaGetLastError() after the launch; the caller checks shapes,
// dtypes, devices and contiguity before calling, and Tq > 0. o is a fresh
// torch allocation, so its 2-float stores are aligned.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* bias, void* o,
                                   void* lse, int B, int H, int Tq, int Tk,
                                   int D, float scale, int causal,
                                   void* stream) {
  if ((long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // two strips a warp where every block does the same work; under causal
  // masking one, so that the grid has more, shorter blocks to balance
#define PORT_FWD(DP, STRIPS)                                                \
  return launch<DP, STRIPS>(qf, kf, vf, bf, of, lf, B, H, Tq, Tk, D, scale, \
                            causal, st)
  if (D <= 16) { if (causal) PORT_FWD(16, 1); PORT_FWD(16, 2); }
  if (D <= 32) { if (causal) PORT_FWD(32, 1); PORT_FWD(32, 2); }
  if (D <= 64) { if (causal) PORT_FWD(64, 1); PORT_FWD(64, 2); }
  if (D <= 128) PORT_FWD(128, 1);
#undef PORT_FWD
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The bf16 variant: q, k, v [B, H, T, D] bf16 in, O bf16 out, lse fp32.
//
// What the TPU kernel does with bf16 tiles: it upcasts q, k and v to fp32
// (:109-111), takes both dots in fp32 and writes O in q's dtype (:136). This
// kernel computes the same function:
//   * s = q . K^T on the tensor cores, bf16 in, fp32 accumulate. A product
//     of two bf16 values is exact in fp32, so this is the upcast dot, summed
//     in another order. The scale multiplies the fp32 score after the
//     product; the TPU kernel scales q first. At D = 64 the scale is 1/8, a
//     power of two, and the two orders agree bit for bit, else they differ
//     by fp32 rounding only.
//   * O += P . V with P fp32 (the online softmax's weights): P is split into
//     two bf16 terms, hi = bf16(P) and lo = bf16(P - hi), and each is
//     multiplied with V's bf16 tile, accumulated in fp32. The split keeps
//     about 16 bits of P; its error (below 2^-16 relative) is far below the
//     bf16 rounding of O (2^-9) that the reference applies anyway.
//   * The masks are the fp32 kernel's: causal positions set to -1e9, keys
//     past Tk at -inf; m starts at -1e30 and l is clamped at 1e-30. m, l,
//     the accumulators and lse stay fp32.
//
// What bounds it on the H100. At the Transformer's T = 256, D = 64 (B = 16,
// H = 8) it reads q, k and v at 2 bytes and the bias once and writes O at 2
// bytes and lse at 4: 0.0051 ms at 3.35 TB/s. Its 2 products of depth D a
// (query, key) pair, 4 * B * H * D * pairs FLOPs, take 0.0022 ms at the
// dense bf16 rate (989 TFLOP/s); the hi/lo split makes them 3 products on
// the tensor cores, 0.0033 ms. Bytes bound it. A block walks only T / 64 = 4
// key tiles, so what decides the time is how fast a block gets through that
// short loop and how many blocks an SM holds.
//
// What the design does about what held the mma.sync design before it back
// (2.05x the time of SDPA's cuDNN kernel):
//   * Every product on wgmma.mma_async m64n64k16 (hopper_bf16.cuh): one
//     warpgroup (4 warps, 128 threads) owns the block's 64 query rows.
//     s = Q.K^T reads both tiles from shared memory through K-major
//     descriptors. O += P.V takes P from the score accumulator registers as
//     A fragments (c_to_a_split: two adjacent C fragments are the A fragment
//     of a 16-key step) and V through an MN-major descriptor, which reads V
//     down its rows. No thread loads a fragment of K or V, and none reads a
//     column (mma.sync took V's B fragments with 16-bit loads, 128 of them a
//     64-key chunk at D = 64, each twice).
//   * Tiles by TMA into 128-byte-swizzled shared memory, the layout the
//     descriptors read: [B*H, T, D] tensor maps in boxes of [1, 64, 64],
//     passed as __grid_constant__ parameters, which a CUDA graph captures
//     by value; rows past T and columns past D arrive as zeros. Q's tile
//     lands once and stays. K, V and 64 bias entries stream through a
//     2-stage ring: warp 0 refills one stage while the warpgroup multiplies
//     the other. A stage has a full mbarrier (the TMA's bytes, and the
//     4-byte cp.async copies of the bias, which arrive on it themselves)
//     and an empty one (one arrival a warp once its products have read the
//     stage). A launch the TMA cannot take (D % 8 != 0, or a base not
//     16-byte aligned) has warp 0 write the same layout with 4-byte cp.async
//     or element copies (load_tile_swz): the mode follows from shape and
//     alignment.
//   * The softmax on the accumulator registers: P = exp(s - m) is one
//     MUFU.EX2 of the difference (exp_of), the row max and sum reduce over
//     the quad, and the causal and ragged selects run only on a tile that
//     holds a masked position (the causal diagonal, keys past Tk).
//   * Registers decide the blocks an SM holds: at D = 64 the score set, the
//     64 x 64 accumulator and P's hi/lo fragments fit 128 registers a
//     thread, four blocks an SM (42 KB of shared memory each), so the
//     Transformer's grid at T = 256, 512 blocks, runs in one wave on 132
//     SMs. Measured slower on the H100 and not kept (PERF.md):
//     FlashAttention-3's intra-warpgroup pipelining (the next tile's scores
//     issued with this tile's P.V, its softmax under that product), which
//     holds a second score set and a third stage, about 160 registers and
//     three blocks an SM: 1.1-1.4x the time; and 128-row blocks (two
//     warpgroups sharing each streamed tile, a producer warp): equal within
//     1%, with more code.
//   * D up to 64 pads to one 64-column block and D 128 takes two, as the
//     backward does.
//   * Causal masking: the key loop stops at the tile holding the block's
//     last diagonal key (tiles above the diagonal are never loaded), and
//     the query tiles run last (longest) first.
//   * The epilogue: O = acc / l to bf16 pairs (store_pair), lse = m +
//     log(l) in fp32. Each block owns its rows and sums in a fixed order, so
//     two launches on the same inputs give the same bits.
namespace {

constexpr int FWD_STAGES = 2;

template <int DP>
constexpr int fwd_bf16_smem_bytes() {
  // 1024-byte alignment slack; the resident Q tile; FWD_STAGES stages of a
  // K tile, a V tile and 64 bias entries; a full and an empty mbarrier a
  // stage
  return 1024 + tile_bytes<DP>() +
         FWD_STAGES * (2 * tile_bytes<DP>() + BLOCK * 4) + 2 * FWD_STAGES * 8;
}

// s = Q.K^T for the warpgroup's 64 query rows against a key tile, over d:
// both swizzled tiles K-major. Issued and committed, not waited on.
template <int DP>
__device__ __forceinline__ void issue_scores(float (&s)[8][4], uint32_t qa,
                                             uint32_t ka) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint32_t off = (ks >> 2) * CB_BYTES + (ks & 3) * 32;
    wgmma_ss(s, desc_k_major(qa + off), desc_k_major(ka + off), ks);
  }
  wgmma_commit();
}

// O += P.V over a key tile, 16 keys a step, P as hi + lo (the small term
// first); B = the V tile read down its rows (MN-major). Issued and
// committed, not waited on.
template <int NCB>
__device__ __forceinline__ void issue_pv(float (&acc)[NCB][8][4],
                                         const uint32_t (&hi)[4][4],
                                         const uint32_t (&lo)[4][4],
                                         uint32_t va) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) {
      const uint64_t vd = desc_mn_major(va + cb * CB_BYTES + kk * 2048);
      wgmma_rs(acc[cb], lo[kk], vd);
      wgmma_rs(acc[cb], hi[kk], vd);
    }
  wgmma_commit();
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
fwd_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                const __grid_constant__ CUtensorMap map_k,
                const __grid_constant__ CUtensorMap map_v,
                const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, const float* __restrict__ bias,
                bf16* __restrict__ o, float* __restrict__ lse, int H, int Tq,
                int Tk, int D, float scale, int causal, int mode) {
  constexpr int TB = tile_bytes<DP>();
  constexpr int NCB = DP / 64;
  constexpr int NS = FWD_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);   // resident
  unsigned char* Ks = Qs + TB;               // [NS] stages
  unsigned char* Vs = Ks + NS * TB;          // [NS]
  float* Bs = reinterpret_cast<float*>(Vs + NS * TB);              // [NS][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + NS * BLOCK);   // [NS]
  uint64_t* empty = full + NS;                                     // [NS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.x;
  const int b = (int)(bh / H);
  // the block's rows: the last, longest under causal masking, first
  const int q0 = ((Tq + BLOCK - 1) / BLOCK - 1 - (int)blockIdx.y) * BLOCK;
  const bf16* kb = k + bh * Tk * D;
  const bf16* vb = v + bh * Tk * D;
  const float* biasb = bias + (size_t)b * Tk;
  const bool tma = mode == MODE_TMA;
  // the maps stay in parameter space, where the TMA reads them
  const CUtensorMap* mq = &map_q;
  const CUtensorMap* mk = &map_k;
  const CUtensorMap* mv = &map_v;

  // key tiles: all, or up to the one holding the last diagonal key
  int n_tiles = (Tk + BLOCK - 1) / BLOCK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BLOCK, Tq) - 1) / BLOCK + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < NS; ++s) {
      // full: warp 0's 32 copy arrivals and one more (with the TMA's
      // bytes); empty: one arrival a warp
      mbar_init(&full[s], 33);
      mbar_init(&empty[s], THREADS / 32);
    }
    mbar_fence_init();
  }
  if (!tma) {
    zero_smem<THREADS>(Qs, (1 + 2 * NS) * TB);
    fence_proxy_async();
  }
  __syncthreads();

  // Warp 0 fills stage i % NS with key tile i (K, V, the bias; at i = 0 the
  // Q tile too) once every warp has released the stage's last tile.
  auto produce = [&](int i) {
    const int s = i % NS, k1 = i * BLOCK;
    if (i >= NS) mbar_wait(&empty[s], (i / NS - 1) & 1);
    if (tma) {
      if (lane == 0) {
        mbar_expect_tx(&full[s], (i == 0 ? 3 : 2) * TB);
        if (i == 0) tma_tile<DP>(Qs, mq, q0, (int)bh, &full[s]);
        tma_tile<DP>(Ks + s * TB, mk, k1, (int)bh, &full[s]);
        tma_tile<DP>(Vs + s * TB, mv, k1, (int)bh, &full[s]);
      }
    } else {
      if (i == 0)
        load_tile_swz<DP, 32>(Qs, q + bh * Tq * D, q0, Tq, D, mode, lane);
      load_tile_swz<DP, 32>(Ks + s * TB, kb, k1, Tk, D, mode, lane);
      load_tile_swz<DP, 32>(Vs + s * TB, vb, k1, Tk, D, mode, lane);
    }
    for (int e = lane; e < BLOCK; e += 32) {
      const bool live = k1 + e < Tk;
      cp_async4(Bs + s * BLOCK + e, live ? biasb + k1 + e : biasb, live);
    }
    if (!tma) {
      // the tiles' generic-proxy writes, complete, before wgmma reads them
      cp_async_wait_all();
      fence_proxy_async();
      if (lane == 0) mbar_arrive(&full[s]);
    }
    cp_async_mbar_arrive(&full[s]);
  };
  if (warp == 0)
    for (int i = 0; i < min(NS - 1, n_tiles); ++i) produce(i);

  // each thread holds rows 16 warp + g and that + 8 in the C layout
  // (hopper_bf16.cuh)
  const int row = 16 * warp + g;
  const int qpos[2] = {q0 + row, q0 + row + 8};
  const uint32_t qa = smem_u32(Qs);
  float acc[NCB][8][4];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[cb][j][e] = 0.f;
  float m_r[2] = {M_INIT, M_INIT}, l_r[2] = {0.f, 0.f};

  for (int i = 0; i < n_tiles; ++i) {
    if (warp == 0 && i + NS - 1 < n_tiles) produce(i + NS - 1);
    const int stage = i % NS;
    mbar_wait(&full[stage], (i / NS) & 1);
    const float* Bt = Bs + stage * BLOCK;
    const int k0 = i * BLOCK;
    // masks only where the tile holds keys past Tk or above a row's
    // diagonal
    const bool edge = k0 + BLOCK > Tk || (causal && q0 < k0 + BLOCK - 1);

    float s[8][4];
    issue_scores<DP>(s, qa, smem_u32(Ks + stage * TB));
    wgmma_wait_all();
    fence_regs(s);
    // the online softmax, in place (s becomes P): C element e of fragment
    // j sits at row g + 8 (e >> 1), key column 8j + 2t + (e & 1)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * j + 2 * t + (e & 1);
        const int h = e >> 1;
        float val = s[j][e] * scale + Bt[col];
        if (edge) {
          if (causal && qpos[h] < k0 + col) val = NEG_BIG;
          if (k0 + col >= Tk) val = -INFINITY;
        }
        s[j][e] = val;
        mx[h] = fmaxf(mx[h], val);
      }
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_new = fmaxf(m_r[h], quad_max(mx[h]));
      alpha[h] = exp_of(m_r[h] - m_new);
      m_r[h] = m_new;
      l_r[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        s[j][e] = exp_of(s[j][e] - m_r[h]);
        l_r[h] += s[j][e];
      }
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[cb][j][e] *= alpha[e >> 1];
    // O += P.V, P from the score registers as hi + lo
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      c_to_a_split(s[2 * kk], s[2 * kk + 1], hi[kk], lo[kk]);
    issue_pv<NCB>(acc, hi, lo, smem_u32(Vs + stage * TB));
    wgmma_wait_all();
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);
    // the stage is read: warp 0 may refill it
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }

  // the epilogue: O = acc / l to bf16, lse = m + log(l)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l = fmaxf(quad_sum(l_r[h]), 1e-30f);
    if (qpos[h] >= Tq) continue;
    bf16* orow = o + (bh * Tq + qpos[h]) * D;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_pair(orow, 64 * cb + 8 * j + 2 * t, D, acc[cb][j][2 * h] / l,
                   acc[cb][j][2 * h + 1] / l);
    if (t == 0) lse[bh * Tq + qpos[h]] = m_r[h] + logf(l);
  }
}

template <int DP>
int launch_bf16(const bf16* q, const bf16* k, const bf16* v,
                const float* bias, bf16* o, float* lse, int B, int H, int Tq,
                int Tk, int D, float scale, int causal, cudaStream_t stream) {
  const int mode = bf16_tile_mode(D, q, k, v, q);
  CUtensorMap maps[3] = {};
  if (mode == MODE_TMA) {
    int err = make_tile_map(&maps[0], q, B * H, Tq, D);
    if (err == 0) err = make_tile_map(&maps[1], k, B * H, Tk, D);
    if (err == 0) err = make_tile_map(&maps[2], v, B * H, Tk, D);
    if (err != 0) return err;
  }
  const int smem = fwd_bf16_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      fwd_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + BLOCK - 1) / BLOCK);
  fwd_bf16_kernel<DP><<<grid, THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], q, k, v, bias, o, lse, H, Tq, Tk, D, scale,
      causal, mode);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point of the bf16 variant: q, k, v and o bf16, bias and lse fp32;
// otherwise as flash_attention_fwd. o is a fresh torch allocation, so its
// 2-value stores are aligned where D is even.
extern "C" int flash_attention_fwd_bf16(const void* q, const void* k,
                                        const void* v, const void* bias,
                                        void* o, void* lse, int B, int H,
                                        int Tq, int Tk, int D, float scale,
                                        int causal, void* stream) {
  if ((long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const float* bb = static_cast<const float*>(bias);
  bf16* ob = static_cast<bf16*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PORT_FWD_BF16(DP)                                                 \
  return launch_bf16<DP>(qb, kb, vb, bb, ob, lf, B, H, Tq, Tk, D, scale, \
                         causal, st)
  if (D <= 64) PORT_FWD_BF16(64);
  if (D <= 128) PORT_FWD_BF16(128);
#undef PORT_FWD_BF16
  return (int)cudaErrorInvalidValue;
}
