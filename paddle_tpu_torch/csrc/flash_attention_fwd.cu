// Flash-attention forward for Hopper (sm_90a), fp32.
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
//   O     = softmax(s) . V,  lse = m + log(l)
// with the online softmax of FlashAttention-2: running max m (starts at
// -1e30), running sum l (clamped at 1e-30 in the epilogue) and accumulator.
// Inputs q, k, v [B, H, T, D] contiguous fp32, bias [B, Tk] fp32; outputs
// O [B, H, Tq, D] and lse [B, H, Tq] fp32 (the backward and ring attention
// read the lse).
//
// What bounds it on the H100: the work is 4*B*H*Tq*Tk*D FLOPs (half under
// causal masking) against the bytes of q, k, v and O read or written once.
// At the serving shape (T = 256, D = 64) that is T/4 = 64 FLOPs per byte,
// above the fp32 ridge of the card (67 TFLOP/s over 3.35 TB/s = 20), so the
// kernel is bound by arithmetic; in fp32 without TF32 the only units are the
// CUDA cores' FFMA, and shared-memory bandwidth feeding them is the next
// limit.
//
// What the design does about it:
//   * one thread block per (b, h, 64-row query tile); the TPU's sequential
//     k-grid becomes a loop over 64-key tiles staged in shared memory, so
//     each k/v element is read from device memory once per query tile and
//     reused 64 times, and the [Tq, Tk] score matrix never leaves the chip;
//   * 256 threads as a 16 x 16 grid; each thread keeps a 4 x 4 register
//     tile of scores (rows ty + 16i, keys tx + 16j) and 4 x D/16 output
//     accumulators, so every shared-memory load feeds several FMAs; rows
//     and keys are strided by 16 and the q/k tiles padded by one column,
//     which keeps the shared-memory reads free of bank conflicts;
//   * the row max and row sum are reduced across the 16 threads of a row
//     with warp shuffles (a row's 16 threads are one half-warp);
//   * under causal masking the loop stops at the tile holding the diagonal
//     of the query tile's last row: the tiles above the diagonal are never
//     loaded or computed (the TPU needs a separate triangular grid for it);
//   * ragged edges are masked here from Tq and Tk, with no padding copies:
//     keys past Tk score -inf (an exact zero weight; the TPU's padded keys
//     carry NEG_BIG, which differs only on rows whose every key is masked),
//     and rows past Tq are never stored.
// TF32/bf16 tensor cores (wgmma), TMA and warp specialisation are for later
// versions of this kernel.
#include <cuda_runtime.h>
#include <math.h>

#include "port_cuda.cuh"

namespace {

constexpr int BLOCK_M = 64;    // query rows per block
constexpr int BLOCK_N = 64;    // keys per shared-memory tile
constexpr int THREADS = 256;   // 16 x 16
constexpr int PS = BLOCK_N + 1;
constexpr float NEG_BIG = -1e9f;
constexpr float M_INIT = -1e30f;

template <int DP>
constexpr int smem_floats() {
  // Qs [BLOCK_M][DP+1], Ks [BLOCK_N][DP+1], Vs [BLOCK_N][DP],
  // Ps [BLOCK_M][BLOCK_N+1], Bs [BLOCK_N]
  return BLOCK_M * (DP + 1) + BLOCK_N * (DP + 1) + BLOCK_N * DP +
         BLOCK_M * PS + BLOCK_N;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// DP: the head dim D rounded up to a multiple of 16 (16, 32, 64 or 128);
// columns D..DP-1 are zero in shared memory and never stored.
template <int DP>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ bias,
           float* __restrict__ o, float* __restrict__ lse,
           int H, int Tq, int Tk, int D, float scale, int causal) {
  constexpr int QS = DP + 1;
  constexpr int CPT = DP / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BLOCK_M * QS;
  float* Vs = Ks + BLOCK_N * QS;
  float* Ps = Vs + BLOCK_N * DP;
  float* Bs = Ps + BLOCK_M * PS;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * BLOCK_M;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  const float* qb = q + bh * Tq * D;
  const float* kb = k + bh * Tk * D;
  const float* vb = v + bh * Tk * D;
  const float* biasb = bias + (size_t)blockIdx.z * Tk;

  for (int e = tid; e < BLOCK_M * DP; e += THREADS) {
    const int r = e / DP, d = e % DP;
    float val = 0.f;
    if (q0 + r < Tq && d < D) val = qb[(size_t)(q0 + r) * D + d] * scale;
    Qs[r * QS + d] = val;
  }

  int n_tiles = (Tk + BLOCK_N - 1) / BLOCK_N;
  if (causal) {
    // last key any row of this tile may attend to is its last row's index
    const int last_row = min(q0 + BLOCK_M, Tq) - 1;
    n_tiles = min(n_tiles, last_row / BLOCK_N + 1);
  }

  float m_i[4], l_i[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = M_INIT;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK_N;
    __syncthreads();   // the previous tile's Ks/Vs/Ps reads are done
    for (int e = tid; e < BLOCK_N * DP; e += THREADS) {
      const int r = e / DP, d = e % DP;
      const bool ok = (k0 + r < Tk) && d < D;
      const size_t off = (size_t)(k0 + r) * D + d;
      Ks[r * QS + d] = ok ? kb[off] : 0.f;
      Vs[r * DP + d] = ok ? vb[off] : 0.f;
    }
    if (tid < BLOCK_N) Bs[tid] = (k0 + tid < Tk) ? biasb[k0 + tid] : 0.f;
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float val = s[i][j] + Bs[tx + 16 * j];
        if (causal && qpos < kpos) val = NEG_BIG;
        if (kpos >= Tk) val = -INFINITY;
        s[i][j] = val;
        mx = fmaxf(mx, val);
      }
      const float m_new = fmaxf(m_i[i], half_warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * PS + tx + 16 * j] = p;
        psum += p;
      }
      const float alpha = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * alpha + half_warp_sum(psum);
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();   // Ps complete

#pragma unroll 4
    for (int kk = 0; kk < BLOCK_N; ++kk) {
      float p[4], vv[CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PS + kk];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = Vs[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float l = fmaxf(l_i[i], 1e-30f);
    float* orow = o + (bh * Tq + row) * D;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = tx + 16 * c;
      if (col < D) orow[col] = acc[i][c] / l;
    }
    if (tx == 0) lse[bh * Tq + row] = m_i[i] + logf(l);
  }
}

template <int DP>
int launch(const float* q, const float* k, const float* v, const float* bias,
           float* o, float* lse, int B, int H, int Tq, int Tk, int D,
           float scale, int causal, cudaStream_t stream) {
  const int smem = smem_floats<DP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BLOCK_M - 1) / BLOCK_M, H, B);
  fwd_kernel<DP><<<grid, THREADS, smem, stream>>>(q, k, v, bias, o, lse, H,
                                                  Tq, Tk, D, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes by paddle_tpu_torch/ops/flash_attention.py).
// Returns cudaGetLastError() after the launch; the caller checks shapes,
// dtypes, devices and contiguity before calling.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, const void* bias, void* o,
                                   void* lse, int B, int H, int Tq, int Tk,
                                   int D, float scale, int causal,
                                   void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* bf = static_cast<const float*>(bias);
  float* of = static_cast<float*>(o);
  float* lf = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16)
    return launch<16>(qf, kf, vf, bf, of, lf, B, H, Tq, Tk, D, scale, causal, st);
  if (D <= 32)
    return launch<32>(qf, kf, vf, bf, of, lf, B, H, Tq, Tk, D, scale, causal, st);
  if (D <= 64)
    return launch<64>(qf, kf, vf, bf, of, lf, B, H, Tq, Tk, D, scale, causal, st);
  if (D <= 128)
    return launch<128>(qf, kf, vf, bf, of, lf, B, H, Tq, Tk, D, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
