// Flash-attention backward for Hopper (sm_90a), fp32.
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
//   s[q,k] = (q * scale) . k + bias[b, k]   (scale on q first, as the forward
//            kernel csrc/flash_attention_fwd.cu does; the same d-order fmaf
//            sum, so s is the forward's s)
//   s      = NEG_BIG (-1e9) where causal and qpos < kpos  (set, not added)
//   s      = -inf past Tk                                   (P = 0)
//   P      = exp(s - lse[q]);   dP = dO . V^T
//   dS'    = P * (dP - delta[q])       (delta = rowsum(dO * O) - dlse, made
//                                       by the wrapper in plain torch, as the
//                                       JAX package makes it outside Pallas)
//   dQ     = scale * sum_k dS' k;  dK = sum_q dS' (q * scale);  dV = sum_q P dO
// Inputs q, dO [B, H, Tq, D], k, v [B, H, Tk, D], bias [B, Tk], lse and delta
// [B, H, Tq], all contiguous fp32; outputs dQ [B, H, Tq, D] and dK, dV
// [B, H, Tk, D].
//
// Why two passes and not FlashAttention-2's single pass. FA2 walks key tiles
// in the outer loop, accumulates dK/dV in registers and adds each query
// tile's dQ share into device memory with atomicAdd. That saves the second
// recompute of s and P, but the float sums then land in an order that
// changes from run to run, so the gradients are not reproducible, and the
// atomics contend on the same dQ rows from Tk/64 blocks. Here each block owns
// the rows it writes (dQ rows in the first kernel, dK/dV rows in the second):
// no atomics, no zero-fill, and the result is deterministic. It is also the
// TPU's own split into two passes. The price is that s and P are computed
// twice (once per kernel).
//
// What bounds it on the H100: per (query, key) pair the two kernels do 7
// tile products of depth D (s and dP in both, dQ in the first, dV and dK in
// the second): 14 * B * H * D * keys FLOPs, keys counting the pairs a causal
// mask leaves. Against the bytes of q, k, v, dO, lse, delta, bias, dQ, dK
// and dV (each read or written once) that is far above the card's fp32 ridge
// (67 TFLOP/s over 3.35 TB/s = 20 FLOP/byte) at T = 256, so it is bound by
// arithmetic: fp32 FFMA on the CUDA cores (TF32 is off on the port's path),
// fed from shared memory.
//
// What the design does about it (the forward kernel's scheme):
//   * 64 x 64 tiles staged in shared memory, so each element of a streamed
//     tile feeds 64 rows of the resident one; the [Tq, Tk] P and dS never
//     leave the chip;
//   * 256 threads as a 16 x 16 grid, each holding a 4 x 4 register tile of
//     s and dP (rows ty + 16i, columns tx + 16j) and 4 x D/16 accumulators
//     per output, so every shared-memory load feeds several FMAs; tiles read
//     along D are padded to D+1 columns and P/dS tiles to 65, which keeps the
//     reads free of bank conflicts;
//   * under causal masking the dQ loop stops at the tile holding the query
//     tile's last diagonal key, and the dK/dV loop starts at the query tile
//     holding the key tile's first diagonal row (the _tri_maps_kv order,
//     :81-92): tiles above the diagonal are never loaded;
//   * ragged edges from Tq and Tk, with no padding copies: keys past Tk load
//     as zeros and get P = 0; query rows past Tq load as zeros (dO, lse and
//     delta too), get P = 0 and are never stored, so they add nothing.
// TF32/bf16 tensor cores (wgmma), TMA and warp specialisation are for later
// versions, as for the forward kernel.
#include <cuda_runtime.h>
#include <math.h>

#include "port_cuda.cuh"

namespace {

constexpr int BLOCK_M = 64;    // query rows per tile
constexpr int BLOCK_N = 64;    // keys per tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int PS = BLOCK_N + 1;
constexpr float NEG_BIG = -1e9f;

// Loads rows [r0, r0 + 64) of a [rows, D] matrix into a [64][DP+1] shared
// tile, times `mul`; rows past `rows` and columns past D are zero.
template <int DP>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int r0, int rows, int D, float mul) {
  constexpr int QS = DP + 1;
  for (int e = (int)threadIdx.x; e < 64 * DP; e += THREADS) {
    const int r = e / DP, d = e % DP;
    float val = 0.f;
    if (r0 + r < rows && d < D) val = src[(size_t)(r0 + r) * D + d] * mul;
    dst[r * QS + d] = val;
  }
}

// Loads 64 entries [i0, i0 + 64) of a vector; entries past n are zero.
__device__ __forceinline__ void load_vec(float* dst, const float* src, int i0,
                                         int n) {
  const int i = threadIdx.x;
  if (i < 64) dst[i] = (i0 + i < n) ? src[i0 + i] : 0.f;
}

// The forward's score for (qpos, kpos): bias added, causal positions set to
// NEG_BIG, keys past Tk at -inf.
__device__ __forceinline__ float masked_score(float s, float b, int qpos,
                                              int kpos, int Tk, int causal) {
  float val = s + b;
  if (causal && qpos < kpos) val = NEG_BIG;
  if (kpos >= Tk) val = -INFINITY;
  return val;
}

template <int DP>
constexpr int dq_smem_floats() {
  // Qs, dOs [BLOCK_M][DP+1]; Ks, Vs [BLOCK_N][DP+1]; dSs [BLOCK_M][PS];
  // Bs [BLOCK_N]; Ls, Ds [BLOCK_M]
  return 2 * BLOCK_M * (DP + 1) + 2 * BLOCK_N * (DP + 1) + BLOCK_M * PS +
         BLOCK_N + 2 * BLOCK_M;
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ bias,
              const float* __restrict__ dout, const float* __restrict__ lse,
              const float* __restrict__ delta, float* __restrict__ dq,
              int H, int Tq, int Tk, int D, float scale, int causal) {
  constexpr int QS = DP + 1;
  constexpr int CPT = DP / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + BLOCK_M * QS;
  float* Ks = dOs + BLOCK_M * QS;
  float* Vs = Ks + BLOCK_N * QS;
  float* dSs = Vs + BLOCK_N * QS;
  float* Bs = dSs + BLOCK_M * PS;
  float* Ls = Bs + BLOCK_N;
  float* Ds = Ls + BLOCK_M;

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BLOCK_M;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;
  const float* biasb = bias + (size_t)blockIdx.z * Tk;

  load_tile<DP>(Qs, q + bh * Tq * D, q0, Tq, D, scale);
  load_tile<DP>(dOs, dout + bh * Tq * D, q0, Tq, D, 1.f);
  load_vec(Ls, lse + bh * Tq, q0, Tq);
  load_vec(Ds, delta + bh * Tq, q0, Tq);

  int n_tiles = (Tk + BLOCK_N - 1) / BLOCK_N;
  if (causal) {
    const int last_row = min(q0 + BLOCK_M, Tq) - 1;
    n_tiles = min(n_tiles, last_row / BLOCK_N + 1);
  }

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK_N;
    __syncthreads();   // the previous tile's Ks/Vs/dSs reads are done
    load_tile<DP>(Ks, kb, k0, Tk, D, 1.f);
    load_tile<DP>(Vs, vb, k0, Tk, D, 1.f);
    load_vec(Bs, biasb, k0, Tk);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float a[4], o[4], bk[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * QS + d];
        o[i] = dOs[(ty + 16 * i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bk[j] = Ks[(tx + 16 * j) * QS + d];
        bv[j] = Vs[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i], bk[j], s[i][j]);
          dp[i][j] = fmaf(o[i], bv[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const float val = masked_score(s[i][j], Bs[c], qpos, k0 + c, Tk,
                                       causal);
        const float p = expf(val - Ls[r]);
        dSs[r * PS + c] = p * (dp[i][j] - Ds[r]);
      }
    }
    __syncthreads();   // dSs complete

#pragma unroll 4
    for (int kk = 0; kk < BLOCK_N; ++kk) {
      float ds[4], kv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = dSs[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) kv[c] = Ks[kk * QS + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(ds[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    float* drow = dq + (bh * Tq + row) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < D) drow[col] = acc[i][c] * scale;
    }
  }
}

template <int DP>
constexpr int dkv_smem_floats() {
  // Ks, Vs [BLOCK_N][DP+1]; Qs, dOs [BLOCK_M][DP+1]; Pt, dSt [BLOCK_N][PS];
  // Bs [BLOCK_N]; Ls, Ds [BLOCK_M]
  return 2 * BLOCK_N * (DP + 1) + 2 * BLOCK_M * (DP + 1) + 2 * BLOCK_N * PS +
         BLOCK_N + 2 * BLOCK_M;
}

template <int DP>
__global__ void __launch_bounds__(THREADS)
bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ bias,
               const float* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, float* __restrict__ dk,
               float* __restrict__ dv, int H, int Tq, int Tk, int D,
               float scale, int causal) {
  constexpr int QS = DP + 1;
  constexpr int CPT = DP / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + BLOCK_N * QS;
  float* Qs = Vs + BLOCK_N * QS;
  float* dOs = Qs + BLOCK_M * QS;
  float* Pt = dOs + BLOCK_M * QS;    // P transposed: [key][query]
  float* dSt = Pt + BLOCK_N * PS;    // dS' transposed
  float* Bs = dSt + BLOCK_N * PS;
  float* Ls = Bs + BLOCK_N;
  float* Ds = Ls + BLOCK_M;

  const int tx = threadIdx.x & 15;   // query column of the s^T tile
  const int ty = threadIdx.x >> 4;   // key row
  const int k0 = blockIdx.x * BLOCK_N;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* qb = q + bh * Tq * D;
  const float* dob = dout + bh * Tq * D;
  const float* lseb = lse + bh * Tq;
  const float* deltab = delta + bh * Tq;

  load_tile<DP>(Ks, k + bh * Tk * D, k0, Tk, D, 1.f);
  load_tile<DP>(Vs, v + bh * Tk * D, k0, Tk, D, 1.f);
  load_vec(Bs, bias + (size_t)blockIdx.z * Tk, k0, Tk);

  const int n_tiles = (Tq + BLOCK_M - 1) / BLOCK_M;
  // under causal masking, query rows before k0 see none of these keys
  const int first = causal ? k0 / BLOCK_M : 0;

  float acc_k[4][CPT], acc_v[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  for (int t = first; t < n_tiles; ++t) {
    const int q0 = t * BLOCK_M;
    __syncthreads();   // the previous tile's Qs/dOs/Pt/dSt reads are done
    load_tile<DP>(Qs, qb, q0, Tq, D, scale);
    load_tile<DP>(dOs, dob, q0, Tq, D, 1.f);
    load_vec(Ls, lseb, q0, Tq);
    load_vec(Ds, deltab, q0, Tq);
    __syncthreads();

    // s^T and dP^T: rows are keys ty + 16i, columns queries tx + 16j; the
    // sum over d runs in the forward's order, so s is the forward's s
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = dpt[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float kk[4], vv[4], a[4], o[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kk[i] = Ks[(ty + 16 * i) * QS + d];
        vv[i] = Vs[(ty + 16 * i) * QS + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        a[j] = Qs[(tx + 16 * j) * QS + d];
        o[j] = dOs[(tx + 16 * j) * QS + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          st[i][j] = fmaf(a[j], kk[i], st[i][j]);
          dpt[i][j] = fmaf(o[j], vv[i], dpt[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int kpos = k0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int qpos = q0 + c;
        const float val = masked_score(st[i][j], Bs[r], qpos, kpos, Tk,
                                       causal);
        // rows past Tq have no dO: they must add nothing, whatever the bias
        const float p = qpos < Tq ? expf(val - Ls[c]) : 0.f;
        Pt[r * PS + c] = p;
        dSt[r * PS + c] = p * (dpt[i][j] - Ds[c]);
      }
    }
    __syncthreads();   // Pt, dSt complete

#pragma unroll 4
    for (int qq = 0; qq < BLOCK_M; ++qq) {
      float p[4], ds[4], o[CPT], a[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = Pt[(ty + 16 * i) * PS + qq];
        ds[i] = dSt[(ty + 16 * i) * PS + qq];
      }
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        o[c] = dOs[qq * QS + tx + 16 * c];
        a[c] = Qs[qq * QS + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          acc_v[i][c] = fmaf(p[i], o[c], acc_v[i][c]);
          acc_k[i][c] = fmaf(ds[i], a[c], acc_k[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Tk) continue;
    float* dkrow = dk + (bh * Tk + row) * D;
    float* dvrow = dv + (bh * Tk + row) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < D) {
        dkrow[col] = acc_k[i][c];
        dvrow[col] = acc_v[i][c];
      }
    }
  }
}

template <int DP>
int launch_dq(const float* q, const float* k, const float* v, const float* b,
              const float* dout, const float* lse, const float* delta,
              float* dq, int B, int H, int Tq, int Tk, int D, float scale,
              int causal, cudaStream_t stream) {
  const int smem = dq_smem_floats<DP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dq_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BLOCK_M - 1) / BLOCK_M, H, B);
  bwd_dq_kernel<DP><<<grid, THREADS, smem, stream>>>(
      q, k, v, b, dout, lse, delta, dq, H, Tq, Tk, D, scale, causal);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_dkv(const float* q, const float* k, const float* v, const float* b,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, int B, int H, int Tq, int Tk, int D,
               float scale, int causal, cudaStream_t stream) {
  const int smem = dkv_smem_floats<DP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bwd_dkv_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tk + BLOCK_N - 1) / BLOCK_N, H, B);
  bwd_dkv_kernel<DP><<<grid, THREADS, smem, stream>>>(
      q, k, v, b, dout, lse, delta, dk, dv, H, Tq, Tk, D, scale, causal);
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
