// Flash-attention backward for Hopper (sm_90a): fp32 in and out, tile
// products on the tensor cores in 3xTF32; and its bf16 variants (at the
// end of the file), bf16 in and out, bf16 tile products.
//
// Replaces the four Pallas grids of the TPU backward in
// paddle_tpu/ops/flash_attention.py:
//   * _bwd_call (:406-457): the rectangular dQ grid (_bwd_dq_kernel :200,
//     pallas_call :412) and the rectangular dK/dV grid (_bwd_dkv_kernel
//     :258, pallas_call :430);
//   * _bwd_call_tri (:361-403): the causal lower-triangle dQ grid
//     (_bwd_dq_kernel_tri :209, pallas_call :370) and the k-block-major
//     triangle dK/dV grid (_bwd_dkv_kernel_tri :269, pallas_call :384);
// with two kernels, each behind its own C entry point:
//   flash_attention_bwd_dq   one block per (b, h, 64-row query tile), a loop
//                            over key tiles                  -> dQ
//   flash_attention_bwd_dkv  one block per (b, h, 64-key tile), a loop over
//                            query tiles                     -> dK, dV
//
// What they compute, with s, P recomputed from the forward's saved lse:
//   s[q,k] = (q . k) * scale + bias[b, k]
//   s      = NEG_BIG (-1e9) where causal and qpos < kpos  (set, not added)
//   s      = -inf past Tk                                   (P = 0)
//   P      = exp(s - lse[q]);   dP = dO . V^T
//   dS'    = P * (dP - delta[q])       (delta = rowsum(dO * O) - dlse, made
//                                       by the wrapper in plain torch, as the
//                                       JAX package makes it outside Pallas)
//   dQ     = scale * sum_k dS' k;  dK = scale * sum_q dS' q;  dV = sum_q P dO
// Inputs q, dO [B, H, Tq, D], k, v [B, H, Tk, D], bias [B, Tk], lse and delta
// [B, H, Tq], all contiguous fp32; outputs dQ [B, H, Tq, D] and dK, dV
// [B, H, Tk, D]. The scale is applied to the fp32 accumulators, not to q
// before the product: the same function, rounded in another place.
//
// Why two passes and not FlashAttention-2's single pass. FA2 walks key tiles
// in the outer loop, accumulates dK/dV in registers and adds each query
// tile's dQ share into device memory with atomicAdd. That saves the second
// recompute of s and P, but the float sums then land in an order that
// changes from run to run, so the gradients are not reproducible, and the
// atomics contend on the same dQ rows from Tk/64 blocks. Here each block owns
// the rows it writes (dQ rows in the first kernel, dK/dV rows in the second):
// no atomics, no zero-fill, and the result is bitwise the same from launch
// to launch. It is also the TPU's own split into two passes. The price is
// that s and P are computed twice (once per kernel).
//
// What bounds it on the H100. Per (query, key) pair the two kernels do 7
// tile products of depth D (s and dP in both, dQ in the first, dV and dK in
// the second): 14 * B * H * D * keys FLOPs, keys counting the pairs a causal
// mask leaves. Against the bytes of q, k, v, dO, lse, delta, bias, dQ, dK and
// dV (each read or written once) that is far above the card's ridge at
// T = 256, so it is bound by arithmetic. fp32 FFMA on the CUDA cores peaks at
// 67 TFLOP/s; the tensor cores take TF32 at 495 TFLOP/s, and three TF32
// products per fp32 product (3xTF32, below) give fp32-level accuracy at
// 495 / 3 = 165 TFLOP/s: that is the bound these kernels are held to.
// In practice they are bound by instruction throughput, well before the
// tensor cores: every B fragment an mma.sync reads is loaded from shared memory
// and split by each warp that uses it, about 4 instructions a value beside
// the 3 mma instructions per fragment, and only 8 warps fit an SM (the
// shared memory of 2 blocks). Cheaper splits moved the time most
// (PERF.md).
//
// What the design does about it:
//   * 3xTF32 on the tensor cores. Every tile product is
//     mma.sync.m16n8k8.row.col.f32.tf32.tf32.f32 (inline PTX). Each fp32
//     operand x is split into big = x rounded to TF32 (to nearest, ties
//     away, as cvt.rna) and small = x - big, which the tensor core reads
//     rounded toward zero to TF32; a.b is accumulated in fp32 as
//     a_small.b_big + a_big.b_small + a_big.b_big, small terms first. The
//     operand then carries about 21 significant bits (|small| <= 2^-11 |x|,
//     cut to 11 bits), and the dropped a_small.b_small is about 2^-22 of
//     the product: fp32-level, as CUTLASS's OpMultiplyAddFastF32, which
//     SDPA's fp32 backward runs, also rounds one of the two halves toward
//     zero. Rounding small with a second cvt.rna would cost two more
//     instructions an operand for one more bit; the split is most of the
//     kernels' instructions (above). P is __expf's (ex2.approx), within a
//     few ulp of expf and free of its slow path. One TF32 product alone
//     keeps 11 significant bits: an error of 5e-4 relative in a score near
//     10 moves P = exp(s - lse) by more than the 3e-4 tolerance.
//   * mma.sync and not wgmma. For .tf32, wgmma needs its shared-memory
//     operands K-major. That holds for s = Q.K^T and dP = dO.V^T as the
//     tiles sit, but not for dQ = dS.K, dV = P^T.dO or dK = dS^T.Q, whose
//     summation index is the row index of the stored tile: they would need
//     transposed copies of K, Q and dO, and the big/small halves of every
//     operand would have to live in shared memory too. mma.sync reads its
//     fragments from registers, so each thread splits what it loads and
//     the stored tiles serve both products.
//   * Each of the 4 warps owns a 16-row strip of the block's 64 rows (query
//     rows in the dQ kernel, key rows in the dK/dV kernel) and keeps its
//     strip of s and dP, and its D-wide output accumulators, in registers.
//   * The accumulator (C) fragment of m16n8k8 is not an A fragment: thread
//     (g, t) holds C rows g, g+8 at columns 2t, 2t+1, but A rows g, g+8 at
//     columns t, t+4. The second product's summation index is permuted
//     instead of staging dS (or P) through shared memory: within each step
//     of 8, A position t stands for key (query) 2t and position t+4 for
//     2t+1, and the B fragment's rows (b0 row t, b1 row t+4) are loaded from
//     those same keys. The C fragment (c0, c1, c2, c3) is then the A
//     fragment (c0, c2, c1, c3), with no shuffle and no shared-memory trip.
//   * Asynchronous, double-buffered tiles. The resident tiles (Q and dO in
//     the dQ kernel, K and V in the dK/dV kernel) load once; the streamed
//     ones (K, V and the bias; Q, dO, lse and delta) go through a 2-stage
//     ring with cp.async, so tile t+1 is in flight while tile t is
//     multiplied. 16-byte cp.async.cg chunks, with the zero-fill size
//     operand for rows past Tk or Tq; where D is not a multiple of 4, or a
//     base is not 16-byte aligned, 4-byte cp.async.ca copies instead. Shared
//     rows are padded to D+4 floats (D rounded up to 16, 32, 64 or 128; the
//     columns past D hold zeros, which pads the summation over d): the pitch
//     keeps every row 16-byte aligned, and with the permuted rows above
//     every fragment load of 8 rows x 4 columns, or 4 row pairs x 8
//     columns, hits 32 distinct banks. 6 tiles: 104 KB at D = 64, two
//     blocks an SM.
//   * Causal masking: the dQ loop stops at the key tile holding the query
//     tile's last diagonal key, and the dK/dV loop starts at the query tile
//     holding the key tile's first diagonal row (the _tri_maps_kv order,
//     :81-92); tiles above the diagonal are never loaded. A block's work
//     then grows with its query tile (dQ) or shrinks with its key tile
//     (dK/dV): blockIdx.x runs over (b, h) and blockIdx.y over the tiles,
//     longest first, so the tail of the grid is short. (Skipping, inside the
//     diagonal tile, the steps of 8 keys that lie wholly above a warp's
//     rows was slower: the guards between the unrolled steps cost more
//     than the steps.)
//   * Ragged edges from Tq and Tk, with no padding copies: keys past Tk load
//     as zeros and get P = 0; query rows past Tq load as zeros (dO, lse and
//     delta too), get P = 0 and are never stored, so they add nothing.
//
// s is not the forward kernel's s bit for bit: the forward multiplies
// q * scale before its product (as the TPU kernel does), these kernels scale
// the accumulator after it, and the two sum their k-steps in other orders
// (the forward's shared helpers are tf32_mma.cuh's too). For a live row
// that is noise far below the tolerance. A row whose every key
// is masked (the bias puts -1e9 on each) scores near -1e9, where the fp32
// spacing is 64; -1e9 is itself a multiple of 64, so s rounds to exactly
// -1e9 unless |q.k * scale| reaches 32. The two designs could round to
// different multiples only if their products fell on opposite sides of
// +-32, and real scores stay far below that (if it happened P would jump by
// e^64). chip_smoke.py's card-vs-CPU gradient check of the training step
// holds the whole step to that. Such a row's P on the causally masked keys
// is not 0 either (exp(-1e9 - lse) with lse near -1e9), so skipping the
// tiles above the diagonal changes its gradient, as it does in the forward
// kernel: such a row is ill-conditioned in every implementation, and the
// tests leave it out.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_bf16.cuh"
#include "port_cuda.cuh"
#include "tf32_mma.cuh"

namespace {

template <int DP>
constexpr int smem_floats() {
  // 2 resident tiles, 2 streamed tiles x 2 stages, each [64][DP+4]; four
  // 64-entry vectors (dQ: the bias ring, lse, delta; dK/dV: the bias, and
  // the lse and delta rings take 2 x 2 x 64)
  return 6 * BLOCK * (DP + 4) + 5 * BLOCK;
}

// -- dQ ----------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq, int H,
              int Tq, int Tk, int D, float scale, int causal, int vec) {
  constexpr int P = DP + 4;
  constexpr int TILE = BLOCK * P;
  // keys of the streamed tile held in registers at a time: all 64, or
  // fewer at D = 128, where the dQ accumulators take more registers
  constexpr int NC = DP >= 128 ? 32 : 64;
  constexpr int NT = NC / 8;    // key steps of 8 in a chunk
  constexpr int DT = DP / 8;    // d steps of 8
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + TILE;
  float* Ks = dOs + TILE;        // [2][TILE]
  float* Vs = Ks + 2 * TILE;     // [2][TILE]
  float* Bs = Vs + 2 * TILE;     // [2][BLOCK]
  float* Ls = Bs + 2 * BLOCK;
  float* Ds = Ls + BLOCK;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * warp;               // the warp's strip
  const size_t bh = blockIdx.x;
  const int b = (int)(bh / H);
  // the query tile: the last (longest under causal masking) first
  const int q0 = ((Tq + BLOCK - 1) / BLOCK - 1 - (int)blockIdx.y) * BLOCK;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;
  const float* biasb = bias + (size_t)b * Tk;
  const bool vec16 = vec != 0;

  if (D < DP) zero_pad_columns<DP>(smem, 6, D);
  load_tile<DP>(Qs, q + bh * Tq * D, q0, Tq, D, vec16);
  load_tile<DP>(dOs, dout + bh * Tq * D, q0, Tq, D, vec16);
  load_vec(Ls, lse + bh * Tq, q0, Tq);
  load_vec(Ds, delta + bh * Tq, q0, Tq);

  int n_tiles = (Tk + BLOCK - 1) / BLOCK;
  if (causal) {
    const int last_row = min(q0 + BLOCK, Tq) - 1;
    n_tiles = min(n_tiles, last_row / BLOCK + 1);
  }
  load_tile<DP>(Ks, kb, 0, Tk, D, vec16);
  load_tile<DP>(Vs, vb, 0, Tk, D, vec16);
  load_vec(Bs, biasb, 0, Tk);
  cp_async_commit();

  float acc[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float lse_r[2], del_r[2];
  const int qpos[2] = {q0 + row0 + g, q0 + row0 + g + 8};

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      const int nxt = (it + 1) & 1, k1 = (it + 1) * BLOCK;
      load_tile<DP>(Ks + nxt * TILE, kb, k1, Tk, D, vec16);
      load_tile<DP>(Vs + nxt * TILE, vb, k1, Tk, D, vec16);
      load_vec(Bs + nxt * BLOCK, biasb, k1, Tk);
    }
    cp_async_commit();
    cp_async_wait_one();    // tile it (and the resident tiles) have landed
    __syncthreads();
    if (it == 0) {
      lse_r[0] = Ls[row0 + g];
      lse_r[1] = Ls[row0 + g + 8];
      del_r[0] = Ds[row0 + g];
      del_r[1] = Ds[row0 + g + 8];
    }
    const float* Kt = Ks + (it & 1) * TILE;
    const float* Vt = Vs + (it & 1) * TILE;
    const float* Bt = Bs + (it & 1) * BLOCK;
    const int k0 = it * BLOCK;

#pragma unroll 1
    for (int c0 = 0; c0 < BLOCK; c0 += NC) {
      // s = Q.K^T and dP = dO.V^T over this chunk's keys
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DT; ++ks) {
        FragA qa, oa;
        load_a<P>(qa, Qs, row0, 8 * ks, g, t);
        load_a<P>(oa, dOs, row0, 8 * ks, g, t);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          FragB kf[2], vf[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int at = (c0 + 8 * (j + i) + g) * P + 8 * ks + t;
            kf[i].set(Kt[at], Kt[at + 4]);
            vf[i].set(Vt[at], Vt[at + 4]);
          }
          mma3_span2(s, qa, kf, dp, oa, vf, j);
        }
      }
      // dS' in place of s: C element e sits at row g + 8 (e >> 1), key
      // column 8j + 2t + (e & 1)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          const int h = e >> 1;
          const float val = masked_score(s[j][e], scale, Bt[col], qpos[h],
                                         k0 + col, Tk, causal);
          const float p = __expf(val - lse_r[h]);
          s[j][e] = p * (dp[j][e] - del_r[h]);
        }
      // dQ += dS'.K: key step j's A fragment is (c0, c2, c1, c3) of s[j],
      // position t standing for key 2t and t+4 for key 2t+1
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        FragA da;
        da.set(s[j][0], s[j][2], s[j][1], s[j][3]);
        const float* k_even = Kt + (c0 + 8 * j + 2 * t) * P + g;
        constexpr int NG = DT >= 4 ? 4 : DT;
#pragma unroll
        for (int n = 0; n < DT; n += NG) {
          FragB kf[NG];
#pragma unroll
          for (int i = 0; i < NG; ++i)
            kf[i].set(k_even[8 * (n + i)], k_even[P + 8 * (n + i)]);
          mma3_span(acc, da, kf, n);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before refill
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qpos[h] >= Tq) continue;
    float* drow = dq + (bh * Tq + qpos[h]) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < D) drow[col] = acc[n][2 * h + e] * scale;
      }
  }
}

// -- dK, dV ------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int H, int Tq, int Tk, int D,
               float scale, int causal, int vec) {
  constexpr int P = DP + 4;
  constexpr int TILE = BLOCK * P;
  // queries held in registers at a time (the dK and dV accumulators
  // take 128 registers a thread at D = 128)
  constexpr int NC = DP >= 128 ? 16 : 64;
  constexpr int NT = NC / 8;    // query steps of 8 in a chunk
  constexpr int DT = DP / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + TILE;
  float* Qs = Vs + TILE;         // [2][TILE]
  float* dOs = Qs + 2 * TILE;    // [2][TILE]
  float* Bs = dOs + 2 * TILE;    // [BLOCK]
  float* Ls = Bs + BLOCK;        // [2][BLOCK]
  float* Ds = Ls + 2 * BLOCK;    // [2][BLOCK]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = 16 * warp;               // the warp's strip of keys
  const size_t bh = blockIdx.x;
  const int b = (int)(bh / H);
  // the key tile: the first (longest under causal masking) first
  const int k0 = blockIdx.y * BLOCK;
  const float* qb = q + bh * Tq * D;
  const float* dob = dout + bh * Tq * D;
  const float* lseb = lse + bh * Tq;
  const float* deltab = delta + bh * Tq;
  const bool vec16 = vec != 0;

  if (D < DP) zero_pad_columns<DP>(smem, 6, D);
  load_tile<DP>(Ks, k + bh * Tk * D, k0, Tk, D, vec16);
  load_tile<DP>(Vs, v + bh * Tk * D, k0, Tk, D, vec16);
  load_vec(Bs, bias + (size_t)b * Tk, k0, Tk);

  const int n_tiles = (Tq + BLOCK - 1) / BLOCK;
  // under causal masking, query rows before k0 see none of these keys
  const int first = causal ? k0 / BLOCK : 0;
  if (first < n_tiles) {
    load_tile<DP>(Qs, qb, first * BLOCK, Tq, D, vec16);
    load_tile<DP>(dOs, dob, first * BLOCK, Tq, D, vec16);
    load_vec(Ls, lseb, first * BLOCK, Tq);
    load_vec(Ds, deltab, first * BLOCK, Tq);
  }
  cp_async_commit();

  float acc_k[DT][4], acc_v[DT][4];
#pragma unroll
  for (int n = 0; n < DT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  float bias_r[2];
  const int kpos[2] = {k0 + row0 + g, k0 + row0 + g + 8};

  for (int it = first; it < n_tiles; ++it) {
    const int stage = (it - first) & 1;
    if (it + 1 < n_tiles) {
      const int nxt = stage ^ 1, q1 = (it + 1) * BLOCK;
      load_tile<DP>(Qs + nxt * TILE, qb, q1, Tq, D, vec16);
      load_tile<DP>(dOs + nxt * TILE, dob, q1, Tq, D, vec16);
      load_vec(Ls + nxt * BLOCK, lseb, q1, Tq);
      load_vec(Ds + nxt * BLOCK, deltab, q1, Tq);
    }
    cp_async_commit();
    cp_async_wait_one();    // tile it (and the resident tiles) have landed
    __syncthreads();
    if (it == first) {
      bias_r[0] = Bs[row0 + g];
      bias_r[1] = Bs[row0 + g + 8];
    }
    const float* Qt = Qs + stage * TILE;
    const float* dOt = dOs + stage * TILE;
    const float* Lt = Ls + stage * BLOCK;
    const float* Dt = Ds + stage * BLOCK;
    const int q0 = it * BLOCK;

#pragma unroll 1
    for (int c0 = 0; c0 < BLOCK; c0 += NC) {
      // s^T = K.Q^T and dP^T = V.dO^T over this chunk's queries
      float st[NT][4], dpt[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < DT; ++ks) {
        FragA ka, va;
        load_a<P>(ka, Ks, row0, 8 * ks, g, t);
        load_a<P>(va, Vs, row0, 8 * ks, g, t);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          FragB qf[2], of[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int at = (c0 + 8 * (j + i) + g) * P + 8 * ks + t;
            qf[i].set(Qt[at], Qt[at + 4]);
            of[i].set(dOt[at], dOt[at + 4]);
          }
          mma3_span2(st, ka, qf, dpt, va, of, j);
        }
      }
      // P in place of s^T, dS' in place of dP^T: C element e sits at key
      // row g + 8 (e >> 1), query column 8j + 2t + (e & 1); rows past Tq
      // have no dO and must add nothing, whatever the bias
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          const int qp = q0 + col;
          const int h = e >> 1;
          const float val = masked_score(st[j][e], scale, bias_r[h], qp,
                                         kpos[h], Tk, causal);
          const float p = qp < Tq ? __expf(val - Lt[col]) : 0.f;
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - Dt[col]);
        }
      // dV += P^T.dO and dK += dS'^T.Q: query step j's A fragments are
      // (c0, c2, c1, c3), position t standing for query 2t and t+4 for 2t+1
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        FragA pa, da;
        pa.set(st[j][0], st[j][2], st[j][1], st[j][3]);
        da.set(dpt[j][0], dpt[j][2], dpt[j][1], dpt[j][3]);
        const int r = (c0 + 8 * j + 2 * t) * P + g;
#pragma unroll
        for (int n = 0; n < DT; n += 2) {
          FragB of[2], qf[2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            of[i].set(dOt[r + 8 * (n + i)], dOt[r + P + 8 * (n + i)]);
            qf[i].set(Qt[r + 8 * (n + i)], Qt[r + P + 8 * (n + i)]);
          }
          mma3_span2(acc_v, pa, of, acc_k, da, qf, n);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage before refill
  }
  cp_async_wait_all();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kpos[h] >= Tk) continue;
    float* dkrow = dk + (bh * Tk + kpos[h]) * D;
    float* dvrow = dv + (bh * Tk + kpos[h]) * D;
#pragma unroll
    for (int n = 0; n < DT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * n + 2 * t + e;
        if (col < D) {
          dkrow[col] = acc_k[n][2 * h + e] * scale;
          dvrow[col] = acc_v[n][2 * h + e];
        }
      }
  }
}

// -- launches ----------------------------------------------------------------

// 16-byte copies need D a multiple of 4 and every [*, D] operand 16-byte
// aligned (a contiguous view may start anywhere in its storage)
int vec_ok(const float* q, const float* k, const float* v, const float* dout,
           int D) {
  return D % 4 == 0 && aligned16(q) && aligned16(k) && aligned16(v) &&
         aligned16(dout);
}

template <int DP>
int launch_dq(const float* q, const float* k, const float* v, const float* b,
              const float* dout, const float* lse, const float* delta,
              float* dq, int B, int H, int Tq, int Tk, int D, float scale,
              int causal, cudaStream_t stream) {
  const int smem = smem_floats<DP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + BLOCK - 1) / BLOCK);
  bwd_dq_kernel<DP><<<grid, THREADS, smem, stream>>>(
      q, k, v, b, dout, lse, delta, dq, H, Tq, Tk, D, scale, causal,
      vec_ok(q, k, v, dout, D));
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv(const float* q, const float* k, const float* v, const float* b,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, int B, int H, int Tq, int Tk, int D,
               float scale, int causal, cudaStream_t stream) {
  const int smem = smem_floats<DP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tk + BLOCK - 1) / BLOCK);
  bwd_dkv_kernel<DP><<<grid, THREADS, smem, stream>>>(
      q, k, v, b, dout, lse, delta, dk, dv, H, Tq, Tk, D, scale, causal,
      vec_ok(q, k, v, dout, D));
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes by paddle_tpu_torch/ops/flash_attention.py).
// Each returns cudaGetLastError() after its launch; the caller checks shapes,
// dtypes, devices and contiguity before calling, and Tq > 0.
#define PORT_F(x) static_cast<const float*>(x)

extern "C" int flash_attention_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      const void* dout, const void* lse,
                                      const void* delta, void* dq, int B,
                                      int H, int Tq, int Tk, int D,
                                      float scale, int causal, void* stream) {
  if ((long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  float* out = static_cast<float*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PORT_DQ(DP)                                                         \
  return launch_dq<DP>(PORT_F(q), PORT_F(k), PORT_F(v), PORT_F(bias),       \
                       PORT_F(dout), PORT_F(lse), PORT_F(delta), out, B, H, \
                       Tq, Tk, D, scale, causal, st)
  if (D <= 16) PORT_DQ(16);
  if (D <= 32) PORT_DQ(32);
  if (D <= 64) PORT_DQ(64);
  if (D <= 128) PORT_DQ(128);
#undef PORT_DQ
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* bias,
                                       const void* dout, const void* lse,
                                       const void* delta, void* dk, void* dv,
                                       int B, int H, int Tq, int Tk, int D,
                                       float scale, int causal, void* stream) {
  if ((long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  float* dko = static_cast<float*>(dk);
  float* dvo = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PORT_DKV(DP)                                                         \
  return launch_dkv<DP>(PORT_F(q), PORT_F(k), PORT_F(v), PORT_F(bias),       \
                        PORT_F(dout), PORT_F(lse), PORT_F(delta), dko, dvo,  \
                        B, H, Tq, Tk, D, scale, causal, st)
  if (D <= 16) PORT_DKV(16);
  if (D <= 32) PORT_DKV(32);
  if (D <= 64) PORT_DKV(64);
  if (D <= 128) PORT_DKV(128);
#undef PORT_DKV
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// The bf16 variants: q, k, v, dO [B, H, T, D] bf16 in, dQ, dK, dV bf16 out;
// bias, lse and delta fp32, as are P, dS and every accumulator.
//
// They replace the same four TPU grids as the fp32 kernels above (_bwd_call's
// dQ and dK/dV pallas_calls at :412 and :430, _bwd_call_tri's at :370 and
// :384) where AMP feeds them bf16 tiles. The TPU kernels upcast q, k, v and
// dO to fp32 (:173-176, :228-231), take every dot in fp32 and write dQ, dK
// and dV in their operands' dtypes (:197, :254-255). These kernels compute
// the same function with the fp32 kernels' structure: two passes, each
// block owning the rows it writes (no atomics, bitwise reproducible), the
// same masks (masked_score), causal loop bounds and longest-first dQ grid.
//
// What bounds them on the H100. At the Transformer's T = 256, D = 64
// (B = 16, H = 8) a pair reads q, k, v and dO at 2 bytes and the fp32
// vectors once and writes dQ, dK and dV once: 0.0088 ms at 3.35 TB/s. Its
// 7 products of depth D a (query, key) pair, 14 * B * H * D * pairs FLOPs,
// take 0.0076 ms at the dense bf16 rate (989 TFLOP/s); the hi/lo split
// below makes them 10 products on the tensor cores, 0.011 ms. Each block
// walks only T / 64 = 4 streamed tiles, so what decides the time is how
// many blocks an SM holds and how well their products, their elementwise
// work (P, dS and the split: most of a thread's instructions) and their
// copies overlap one another.
//
// What the design does about it:
//   * Products on wgmma.mma_async m64nNk16, bf16 in, fp32 accumulate
//     (hopper_bf16.cuh). One warpgroup (4 warps, 128 threads) owns 64 rows:
//     queries in the dQ kernel, keys in the dK/dV kernel. The first products
//     read both operands from shared memory through descriptors, K-major:
//     s = Q.K^T and dP = dO.V^T (dQ); s^T = K.Q^T and dP^T = V.dO^T (dK/dV).
//     The scale multiplies the fp32 score after the product.
//   * P and dS are fp32; each goes into the second products as two bf16
//     terms, hi = bf16(x) and lo = bf16(x - hi), which keeps about 16 bits
//     (its error, below 2^-16 relative, is far below the bf16 rounding of
//     dQ, dK and dV that the reference applies anyway). The accumulator of
//     an m64 product gives each warp its 16 rows in the m16n8 C layout, and
//     two adjacent C fragments are the A fragment of a 16-step
//     (c_to_a_split), so P and dS stay in registers.
//   * The second products take A from those registers and B from the
//     stored tile through an MN-major (transposed) descriptor: dQ += dS.K,
//     dV += P^T.dO, dK += dS^T.Q sum over the tile's rows, which bf16 wgmma
//     reads down the rows itself. No thread loads a tile's columns; no
//     thread loads a tile at all.
//   * Tiles by TMA into 128-byte-swizzled shared memory, the layout the
//     descriptors read. The host builds one 3-D tensor map per operand
//     ([B*H, T, D], boxes of [1, 64, 64]; D = 128 takes two boxes) and
//     passes it as a __grid_constant__ parameter, which a CUDA graph
//     captures by value. Rows past T and columns past D arrive as zeros.
//     The resident tiles (Q and dO in the dQ kernel, K and V in the dK/dV
//     kernel) and each streamed tile land on an mbarrier; one thread keeps
//     the next streamed tile in flight while the warpgroup multiplies the
//     current one (2 stages). bias, lse and delta are 64-entry fp32 rings
//     filled with 4-byte cp.async beside them.
//   * A launch takes the TMA when D % 8 == 0 and every bf16 base is 16-byte
//     aligned (the Transformer's case). Otherwise the block's threads write
//     the same swizzled layout with 4-byte cp.async copies (D even, bases
//     4-byte aligned) or element copies, the padding zeroed first, and the
//     same products run: the mode follows from shape and alignment.
//   * Few instructions an element: P = exp(s * scale + bias - lse) is one
//     MUFU.EX2 (exp_of), and masked_score's causal and ragged selects run
//     only on the tiles that hold a masked position (the same function:
//     masked scores are still set to NEG_BIG, keys past Tk to -inf).
//   * Registers decide the blocks an SM holds (48 KB of shared memory a
//     block at D = 64, D padded to 64 or 128): the dQ kernel takes its key
//     tile whole (at most 128 registers a thread at D = 64, four blocks an
//     SM), the dK/dV kernel its query tile 32 queries at a time, so that
//     one chunk's scores sit beside the two 64 x D accumulators (three
//     blocks an SM at D = 64). Blocks of 128 rows, two warpgroups sharing
//     each streamed tile, hold the same registers a thread in twice the
//     threads and were measured slower (PERF.md); a block is one
//     warpgroup.
namespace {

// one warpgroup a block, for its 64 rows
constexpr int BWD_THREADS = 128;

template <int DP>
constexpr int bwd_bf16_smem_bytes() {
  // 1024-byte alignment slack; 2 resident tiles and 2 streamed tiles x 2
  // stages; four 64-entry fp32 vectors; 3 mbarriers
  return 1024 + 6 * tile_bytes<DP>() + 4 * BLOCK * 4 + 3 * 8;
}

// The first products of this warpgroup's 64 rows against N rows of the
// streamed tile, over d: x = A.B^T and y = C.D^T, all four swizzled tiles
// K-major (A and C the resident tiles, B and D the streamed ones from the
// chunk's first row). Returns when they, and every product issued before
// them, have landed.
template <int DP, int N>
__device__ __forceinline__ void strip_scores(float (&x)[N][4],
                                             float (&y)[N][4], uint32_t a,
                                             uint32_t b, uint32_t c,
                                             uint32_t d) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint32_t off = (ks >> 2) * CB_BYTES + (ks & 3) * 32;
    wgmma_ss(x, desc_k_major(a + off), desc_k_major(b + off), ks);
  }
#pragma unroll
  for (int ks = 0; ks < DP / 16; ++ks) {
    const uint32_t off = (ks >> 2) * CB_BYTES + (ks & 3) * 32;
    wgmma_ss(y, desc_k_major(c + off), desc_k_major(d + off), ks);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(x);
  fence_regs(y);
}

// at D = 64 at most 128 registers a thread, so that four blocks fit an SM
template <int DP>
__global__ void __launch_bounds__(BWD_THREADS, DP == 64 ? 4 : 1)
bwd_dq_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                   const __grid_constant__ CUtensorMap map_k,
                   const __grid_constant__ CUtensorMap map_v,
                   const __grid_constant__ CUtensorMap map_do,
                   const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const float* __restrict__ bias,
                   const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int H, int Tq, int Tk, int D, float scale, int causal,
                   int mode) {
  constexpr int TB = tile_bytes<DP>();
  constexpr int NCB = DP / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Qs = align1024(smem_raw);   // resident
  unsigned char* dOs = Qs + TB;              // resident
  unsigned char* Ks = dOs + TB;              // [2] stages
  unsigned char* Vs = Ks + 2 * TB;           // [2]
  float* Bs = reinterpret_cast<float*>(Vs + 2 * TB);          // [2][BLOCK]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Bs + 4 * BLOCK);
  // bars[0]: the resident tiles; bars[1 + s]: stage s

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

  // key tiles: all, or up to the one holding the last diagonal key
  int n_tiles = (Tk + BLOCK - 1) / BLOCK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BLOCK, Tq) - 1) / BLOCK + 1);

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  if (!tma) zero_smem<BWD_THREADS>(Qs, 6 * TB);
  __syncthreads();
  if (tma) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bars[0], 2 * TB);
      tma_tile<DP>(Qs, &map_q, q0, (int)bh, &bars[0]);
      tma_tile<DP>(dOs, &map_do, q0, (int)bh, &bars[0]);
      mbar_expect_tx(&bars[1], 2 * TB);
      tma_tile<DP>(Ks, &map_k, 0, (int)bh, &bars[1]);
      tma_tile<DP>(Vs, &map_v, 0, (int)bh, &bars[1]);
    }
  } else {
    load_tile_swz<DP, BWD_THREADS>(Qs, q + bh * Tq * D, q0, Tq, D,
                                   mode, threadIdx.x);
    load_tile_swz<DP, BWD_THREADS>(dOs, dout + bh * Tq * D, q0, Tq, D,
                                   mode, threadIdx.x);
    load_tile_swz<DP, BWD_THREADS>(Ks, kb, 0, Tk, D, mode, threadIdx.x);
    load_tile_swz<DP, BWD_THREADS>(Vs, vb, 0, Tk, D, mode, threadIdx.x);
  }
  load_vec(Bs, biasb, 0, Tk);
  cp_async_commit();

  const int row = 16 * warp + g;
  const int qpos[2] = {q0 + row, q0 + row + 8};
  float lse_r[2], del_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = qpos[h] < Tq;
    lse_r[h] = live ? lse[bh * Tq + qpos[h]] : 0.f;
    del_r[h] = live ? delta[bh * Tq + qpos[h]] : 0.f;
  }
  float acc[NCB][8][4];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[cb][j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    // tile it's vectors (and copies) have landed, and every warp is done
    // with the other stage, which now takes tile it + 1
    cp_async_wait_all();
    if (!tma) fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_tiles) {
      const int nxt = stage ^ 1, k1 = (it + 1) * BLOCK;
      if (tma) {
        if (threadIdx.x == 0) {
          mbar_expect_tx(&bars[1 + nxt], 2 * TB);
          tma_tile<DP>(Ks + nxt * TB, &map_k, k1, (int)bh, &bars[1 + nxt]);
          tma_tile<DP>(Vs + nxt * TB, &map_v, k1, (int)bh, &bars[1 + nxt]);
        }
      } else {
        load_tile_swz<DP, BWD_THREADS>(Ks + nxt * TB, kb, k1, Tk, D,
                                       mode, threadIdx.x);
        load_tile_swz<DP, BWD_THREADS>(Vs + nxt * TB, vb, k1, Tk, D,
                                       mode, threadIdx.x);
      }
      load_vec(Bs + nxt * BLOCK, biasb, k1, Tk);
    }
    cp_async_commit();
    if (tma) {
      mbar_wait(&bars[0], 0);
      mbar_wait(&bars[1 + stage], (it >> 1) & 1);
    }
    const uint32_t qa = smem_u32(Qs);
    const uint32_t oa = smem_u32(dOs);
    const uint32_t ka = smem_u32(Ks + stage * TB);
    const uint32_t va = smem_u32(Vs + stage * TB);
    const float* Bt = Bs + stage * BLOCK;
    const int k0 = it * BLOCK;
    // masks only where the tile holds keys past Tk or above a row's
    // diagonal
    const bool edge = k0 + BLOCK > Tk || (causal && q0 < k0 + BLOCK - 1);

    // s = Q.K^T and dP = dO.V^T, the block's 64 rows x 64 keys
    float s[8][4], dp[8][4];
    strip_scores<DP>(s, dp, qa, ka, oa, va);
    // dS' = P (dP - delta), in place of s: C element e of fragment j sits
    // at row g + 8 (e >> 1), key column 8j + 2t + (e & 1)
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
        s[j][e] = exp_of(val - lse_r[h]) * (dp[j][e] - del_r[h]);
      }
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      c_to_a_split(s[2 * kk], s[2 * kk + 1], hi[kk], lo[kk]);
    // dQ += dS'.K, 16 keys a step, dS' as hi + lo; B = the K tile read down
    // its rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int cb = 0; cb < NCB; ++cb) {
        const uint64_t kd = desc_mn_major(ka + cb * CB_BYTES + kk * 2048);
        wgmma_rs(acc[cb], lo[kk], kd);
        wgmma_rs(acc[cb], hi[kk], kd);
      }
    wgmma_commit();
    wgmma_wait_all();   // the stage is refilled after the next barrier
  }
  cp_async_wait_all();
  if (tma) mbar_wait(&bars[0], 0);   // no copy outlives the block
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) fence_regs(acc[cb]);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qpos[h] >= Tq) continue;
    bf16* drow = dq + (bh * Tq + qpos[h]) * D;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        store_pair(drow, 64 * cb + 8 * j + 2 * t, D,
                   acc[cb][j][2 * h] * scale, acc[cb][j][2 * h + 1] * scale);
  }
}

template <int DP>
__global__ void __launch_bounds__(BWD_THREADS)
bwd_dkv_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                    const __grid_constant__ CUtensorMap map_k,
                    const __grid_constant__ CUtensorMap map_v,
                    const __grid_constant__ CUtensorMap map_do,
                    const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v,
                    const float* __restrict__ bias,
                    const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int H, int Tq, int Tk, int D,
                    float scale, int causal, int mode) {
  constexpr int TB = tile_bytes<DP>();
  constexpr int NCB = DP / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* Ks = align1024(smem_raw);   // resident
  unsigned char* Vs = Ks + TB;               // resident
  unsigned char* Qs = Vs + TB;               // [2] stages
  unsigned char* dOs = Qs + 2 * TB;          // [2]
  float* Ls = reinterpret_cast<float*>(dOs + 2 * TB);   // [2][BLOCK]
  float* Ds = Ls + 2 * BLOCK;                           // [2][BLOCK]
  uint64_t* bars = reinterpret_cast<uint64_t*>(Ds + 2 * BLOCK);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const size_t bh = blockIdx.x;
  const int b = (int)(bh / H);
  const int k0 = blockIdx.y * BLOCK;        // the block's first key
  const bf16* qb = q + bh * Tq * D;
  const bf16* dob = dout + bh * Tq * D;
  const float* lseb = lse + bh * Tq;
  const float* deltab = delta + bh * Tq;
  const bool tma = mode == MODE_TMA;

  // query tiles: all, or from the one holding the first diagonal row
  const int n_tiles = (Tq + BLOCK - 1) / BLOCK;
  const int first = causal ? k0 / BLOCK : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
  }
  if (!tma) zero_smem<BWD_THREADS>(Ks, 6 * TB);
  __syncthreads();
  if (tma) {
    if (threadIdx.x == 0) {
      mbar_expect_tx(&bars[0], 2 * TB);
      tma_tile<DP>(Ks, &map_k, k0, (int)bh, &bars[0]);
      tma_tile<DP>(Vs, &map_v, k0, (int)bh, &bars[0]);
      if (first < n_tiles) {
        mbar_expect_tx(&bars[1], 2 * TB);
        tma_tile<DP>(Qs, &map_q, first * BLOCK, (int)bh, &bars[1]);
        tma_tile<DP>(dOs, &map_do, first * BLOCK, (int)bh, &bars[1]);
      }
    }
  } else {
    load_tile_swz<DP, BWD_THREADS>(Ks, k + bh * Tk * D, k0, Tk, D,
                                   mode, threadIdx.x);
    load_tile_swz<DP, BWD_THREADS>(Vs, v + bh * Tk * D, k0, Tk, D,
                                   mode, threadIdx.x);
    if (first < n_tiles) {
      load_tile_swz<DP, BWD_THREADS>(Qs, qb, first * BLOCK, Tq, D,
                                     mode, threadIdx.x);
      load_tile_swz<DP, BWD_THREADS>(dOs, dob, first * BLOCK, Tq, D,
                                     mode, threadIdx.x);
    }
  }
  if (first < n_tiles) {
    load_vec(Ls, lseb, first * BLOCK, Tq);
    load_vec(Ds, deltab, first * BLOCK, Tq);
  }
  cp_async_commit();

  const int row = 16 * warp + g;
  const int kpos[2] = {k0 + row, k0 + row + 8};
  float bias_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    bias_r[h] = kpos[h] < Tk ? bias[(size_t)b * Tk + kpos[h]] : 0.f;
  float acc_k[NCB][8][4], acc_v[NCB][8][4];
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_k[cb][j][e] = acc_v[cb][j][e] = 0.f;
  const uint32_t ka = smem_u32(Ks), va = smem_u32(Vs);

  for (int it = first; it < n_tiles; ++it) {
    const int i = it - first, stage = i & 1;
    cp_async_wait_all();
    if (!tma) fence_proxy_async();
    __syncthreads();
    if (it + 1 < n_tiles) {
      const int nxt = stage ^ 1, q1 = (it + 1) * BLOCK;
      if (tma) {
        if (threadIdx.x == 0) {
          mbar_expect_tx(&bars[1 + nxt], 2 * TB);
          tma_tile<DP>(Qs + nxt * TB, &map_q, q1, (int)bh, &bars[1 + nxt]);
          tma_tile<DP>(dOs + nxt * TB, &map_do, q1, (int)bh,
                       &bars[1 + nxt]);
        }
      } else {
        load_tile_swz<DP, BWD_THREADS>(Qs + nxt * TB, qb, q1, Tq, D,
                                       mode, threadIdx.x);
        load_tile_swz<DP, BWD_THREADS>(dOs + nxt * TB, dob, q1, Tq, D,
                                       mode, threadIdx.x);
      }
      load_vec(Ls + nxt * BLOCK, lseb, q1, Tq);
      load_vec(Ds + nxt * BLOCK, deltab, q1, Tq);
    }
    cp_async_commit();
    if (tma) {
      mbar_wait(&bars[0], 0);
      mbar_wait(&bars[1 + stage], (i >> 1) & 1);
    }
    const uint32_t qa = smem_u32(Qs + stage * TB);
    const uint32_t oa = smem_u32(dOs + stage * TB);
    const float* Lt = Ls + stage * BLOCK;
    const float* Dt = Ds + stage * BLOCK;
    const int q0 = it * BLOCK;

    // masks only where the tile holds queries past Tq, keys past Tk or
    // queries above a key's diagonal
    const bool edge = q0 + BLOCK > Tq || k0 + BLOCK > Tk ||
                      (causal && q0 < k0 + BLOCK - 1);

    // the query tile in two chunks of 32: one chunk's scores in registers
    // beside the dK and dV accumulators
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      // s^T = K.Q^T and dP^T = V.dO^T over the chunk's queries
      float st[4][4], dpt[4][4];
      strip_scores<DP>(st, dpt, ka, qa + c * 32 * 128, va, oa + c * 32 * 128);
      // P in place of s^T, dS' in place of dP^T: C element e sits at key
      // row g + 8 (e >> 1), query column 32c + 8j + 2t + (e & 1); rows past
      // Tq have no dO and must add nothing, whatever the bias
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 32 * c + 8 * j + 2 * t + (e & 1);
          const int qp = q0 + col;
          const int h = e >> 1;
          float val = st[j][e] * scale + bias_r[h];
          if (edge) {
            val = masked_score(st[j][e], scale, bias_r[h], qp, kpos[h], Tk,
                               causal);
            if (qp >= Tq) val = -INFINITY;
          }
          const float p = exp_of(val - Lt[col]);
          st[j][e] = p;
          dpt[j][e] = p * (dpt[j][e] - Dt[col]);
        }
      uint32_t phi[2][4], plo[2][4], dhi[2][4], dlo[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        c_to_a_split(st[2 * kk], st[2 * kk + 1], phi[kk], plo[kk]);
        c_to_a_split(dpt[2 * kk], dpt[2 * kk + 1], dhi[kk], dlo[kk]);
      }
      // dV += P^T.dO and dK += dS'^T.Q, 16 queries a step, P and dS' as
      // hi + lo; B = the dO and Q tiles read down their rows
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int cb = 0; cb < NCB; ++cb) {
          const uint32_t off = cb * CB_BYTES + (32 * c + 16 * kk) * 128;
          const uint64_t od = desc_mn_major(oa + off);
          const uint64_t qd = desc_mn_major(qa + off);
          wgmma_rs(acc_v[cb], plo[kk], od);
          wgmma_rs(acc_k[cb], dlo[kk], qd);
          wgmma_rs(acc_v[cb], phi[kk], od);
          wgmma_rs(acc_k[cb], dhi[kk], qd);
        }
      wgmma_commit();
    }
    wgmma_wait_all();   // the stage is refilled after the next barrier
  }
  cp_async_wait_all();
  if (tma) mbar_wait(&bars[0], 0);   // no copy outlives the block
#pragma unroll
  for (int cb = 0; cb < NCB; ++cb) {
    fence_regs(acc_k[cb]);
    fence_regs(acc_v[cb]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kpos[h] >= Tk) continue;
    bf16* dkrow = dk + (bh * Tk + kpos[h]) * D;
    bf16* dvrow = dv + (bh * Tk + kpos[h]) * D;
#pragma unroll
    for (int cb = 0; cb < NCB; ++cb)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = 64 * cb + 8 * j + 2 * t;
        store_pair(dkrow, col, D, acc_k[cb][j][2 * h] * scale,
                   acc_k[cb][j][2 * h + 1] * scale);
        store_pair(dvrow, col, D, acc_v[cb][j][2 * h],
                   acc_v[cb][j][2 * h + 1]);
      }
  }
}

// The four operands' tensor maps, for a launch that takes the TMA.
int bwd_tile_maps(CUtensorMap (&maps)[4], const bf16* q, const bf16* k,
                  const bf16* v, const bf16* dout, int BH, int Tq, int Tk,
                  int D) {
  int err = make_tile_map(&maps[0], q, BH, Tq, D);
  if (err == 0) err = make_tile_map(&maps[1], k, BH, Tk, D);
  if (err == 0) err = make_tile_map(&maps[2], v, BH, Tk, D);
  if (err == 0) err = make_tile_map(&maps[3], dout, BH, Tq, D);
  return err;
}

template <int DP>
int launch_dq_bf16(const bf16* q, const bf16* k, const bf16* v,
                   const float* b, const bf16* dout, const float* lse,
                   const float* delta, bf16* dq, int B, int H, int Tq, int Tk,
                   int D, float scale, int causal, cudaStream_t stream) {
  const int mode = bf16_tile_mode(D, q, k, v, dout);
  CUtensorMap maps[4] = {};
  if (mode == MODE_TMA) {
    const int err = bwd_tile_maps(maps, q, k, v, dout, B * H, Tq, Tk, D);
    if (err != 0) return err;
  }
  const int smem = bwd_bf16_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + BLOCK - 1) / BLOCK);
  bwd_dq_bf16_kernel<DP><<<grid, BWD_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], q, k, v, b, dout, lse, delta, dq,
      H, Tq, Tk, D, scale, causal, mode);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv_bf16(const bf16* q, const bf16* k, const bf16* v,
                    const float* b, const bf16* dout, const float* lse,
                    const float* delta, bf16* dk, bf16* dv, int B, int H,
                    int Tq, int Tk, int D, float scale, int causal,
                    cudaStream_t stream) {
  const int mode = bf16_tile_mode(D, q, k, v, dout);
  CUtensorMap maps[4] = {};
  if (mode == MODE_TMA) {
    const int err = bwd_tile_maps(maps, q, k, v, dout, B * H, Tq, Tk, D);
    if (err != 0) return err;
  }
  const int smem = bwd_bf16_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tk + BLOCK - 1) / BLOCK);
  bwd_dkv_bf16_kernel<DP><<<grid, BWD_THREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], q, k, v, b, dout, lse, delta, dk,
      dv, H, Tq, Tk, D, scale, causal, mode);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points of the bf16 variants: q, k, v, dO and the gradients bf16,
// bias, lse and delta fp32; otherwise as the fp32 entry points.
#define PORT_B(x) static_cast<const bf16*>(x)

extern "C" int flash_attention_bwd_dq_bf16(const void* q, const void* k,
                                           const void* v, const void* bias,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dq, int B,
                                           int H, int Tq, int Tk, int D,
                                           float scale, int causal,
                                           void* stream) {
  if ((long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bf16* out = static_cast<bf16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PORT_DQ_BF16(DP)                                                   \
  return launch_dq_bf16<DP>(PORT_B(q), PORT_B(k), PORT_B(v), PORT_F(bias), \
                            PORT_B(dout), PORT_F(lse), PORT_F(delta), out, \
                            B, H, Tq, Tk, D, scale, causal, st)
  if (D <= 64) PORT_DQ_BF16(64);
  if (D <= 128) PORT_DQ_BF16(128);
#undef PORT_DQ_BF16
  return (int)cudaErrorInvalidValue;
}

extern "C" int flash_attention_bwd_dkv_bf16(const void* q, const void* k,
                                            const void* v, const void* bias,
                                            const void* dout, const void* lse,
                                            const void* delta, void* dk,
                                            void* dv, int B, int H, int Tq,
                                            int Tk, int D, float scale,
                                            int causal, void* stream) {
  if ((long long)B * H > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  bf16* dko = static_cast<bf16*>(dk);
  bf16* dvo = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PORT_DKV_BF16(DP)                                                   \
  return launch_dkv_bf16<DP>(PORT_B(q), PORT_B(k), PORT_B(v), PORT_F(bias), \
                             PORT_B(dout), PORT_F(lse), PORT_F(delta), dko, \
                             dvo, B, H, Tq, Tk, D, scale, causal, st)
  if (D <= 64) PORT_DKV_BF16(64);
  if (D <= 128) PORT_DKV_BF16(128);
#undef PORT_DKV_BF16
  return (int)cudaErrorInvalidValue;
}

// How the bf16 kernels, the forward (flash_attention_fwd.cu, which takes
// q in dout's place) and the backward pair, fill their tiles for these
// operands: 3 by the TMA, 1 with 4-byte copies, 0 with element copies
// (CopyMode, hopper_bf16.cuh).
extern "C" int flash_attention_bf16_copy_mode(int D, const void* q,
                                              const void* k, const void* v,
                                              const void* dout) {
  return bf16_tile_mode(D, q, k, v, dout);
}
