// Paged decode attention for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernel of paddle_tpu/ops/kernels/paged_attention.py:
//   paged_attention <- paged_attention (pallas_call :127, body _kernel :72)
//
// What it computes. The decode step's query rows q [C*beam, D] (the beam
// rows of slot c are rows c*beam .. c*beam+beam-1) attend over their slot's
// encoder rows, which live in fixed-size pages of a shared pool:
// enc_pages [Pe, ps, D], mask_pages [Pe, ps], and the slot's page table
// pt_enc [C, NPE]. Position j*ps + k of slot c is row k of page
// pt_enc[c, j]. Each position below src_cap scores
//   s = q . k          where mask > 0,
//   s = -FLT_MAX       where mask <= 0 (the oracle's finfo(f32).min),
// positions at or past src_cap are sliced off (the TPU kernel scores them
// -inf, which adds exp(-inf) = 0), and the output is the softmax-weighted
// sum of the rows, acc / max(l, 1e-30). A fully masked slot (an inactive
// slot, whose table points only at the reserved zero page 0) scores
// -FLT_MAX everywhere and gets the uniform average, as the oracle does:
// position 0 is always below src_cap, so the running max is finite from
// the first page on.
//
// What bounds it on the H100: bytes. Per query row it does 4*D FLOPs per
// position against the D*4 bytes of the position's row, which every beam
// row of the slot shares. The main decode path (C = 16 slots, beam 3,
// ps 16, NPE 2, D 1024) moves about 2.2 MB (q and out, the distinct pages
// touched, the tables), 0.00065 ms at 3.35 TB/s, far below one launch: the
// kernel is launch-bound at that size.
//
// What the design does about it: one block per query row (C*beam blocks of
// 256 threads), so nothing crosses blocks and nothing is written twice.
// With so few blocks (48 on the decode path, on 132 SMs) the kernel is
// bound by load latency, not by bandwidth, so the design keeps many loads
// in flight per thread. The block stages its q row in shared memory, then
// walks its slot's pages through the table, reading each page once from
// device memory (the other beam rows of the slot find it in L2). For each
// page, each warp takes page rows in turn and reduces q . k over D with its
// lanes on neighbouring 16-byte vectors (coalesced, unrolled 8 deep) and a
// shuffle tree; the page's scores go to shared memory. Then every thread
// updates the online max and sum (the same values in every thread) and
// its own D / 256 accumulators, which live in registers, with exp(s - m)
// times the page rows it owns, 4 rows of loads in flight. Pages shared by
// slots (prefix-cache hits, the zero page) are only read. Later work: one
// block per slot sharing each page tile across the beam rows, TMA page
// loads, bf16.
#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "port_cuda.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

template <int VPT, bool VEC4>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ enc_pages,
                       const float* __restrict__ mask_pages,
                       const int32_t* __restrict__ pt_enc,
                       float* __restrict__ out, int beam, int npe, int ps,
                       int d, int src_cap) {
  extern __shared__ float smem[];
  float* q_s = smem;          // [d]: this block's query row
  float* s_s = smem + d;      // [ps]: the current page's scores
  const int row = blockIdx.x;
  const int c = row / beam;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* qrow = q + static_cast<long long>(row) * d;
  for (int i = tid; i < d; i += THREADS) q_s[i] = qrow[i];

  float acc[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) acc[v] = 0.f;
  float m = -INFINITY;
  float l = 0.f;
  __syncthreads();

  for (int j = 0; j < npe; ++j) {
    const int nk = min(ps, src_cap - j * ps);   // rows below src_cap
    if (nk <= 0) break;
    const long long page = pt_enc[static_cast<long long>(c) * npe + j];
    const float* kp = enc_pages + page * ps * d;
    const float* mp = mask_pages + page * ps;
    for (int k = warp; k < nk; k += WARPS) {
      const float* krow = kp + static_cast<long long>(k) * d;
      float part = 0.f;
      if (VEC4) {   // the launcher checked: every row is 16-byte aligned
        const float4* k4 = reinterpret_cast<const float4*>(krow);
        const float4* q4 = reinterpret_cast<const float4*>(q_s);
#pragma unroll 8
        for (int i = lane; i < d / 4; i += 32) {
          const float4 kv = k4[i];
          const float4 qv = q4[i];
          part = fmaf(qv.x, kv.x, part);
          part = fmaf(qv.y, kv.y, part);
          part = fmaf(qv.z, kv.z, part);
          part = fmaf(qv.w, kv.w, part);
        }
      } else {
#pragma unroll 8
        for (int i = lane; i < d; i += 32) part = fmaf(q_s[i], krow[i], part);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) s_s[k] = mp[k] > 0.f ? part : -FLT_MAX;
    }
    __syncthreads();

    float page_max = s_s[0];
    for (int k = 1; k < nk; ++k) page_max = fmaxf(page_max, s_s[k]);
    const float m_new = fmaxf(m, page_max);
    const float alpha = expf(m - m_new);          // 0 on the first page
#pragma unroll
    for (int v = 0; v < VPT; ++v) acc[v] *= alpha;
    float page_sum = 0.f;
#pragma unroll 4
    for (int k = 0; k < nk; ++k) {
      const float p = expf(s_s[k] - m_new);
      page_sum += p;
      const float* krow = kp + static_cast<long long>(k) * d;
#pragma unroll
      for (int v = 0; v < VPT; ++v) {
        const int dd = tid + v * THREADS;
        if (dd < d) acc[v] = fmaf(p, krow[dd], acc[v]);
      }
    }
    l = l * alpha + page_sum;
    m = m_new;
    __syncthreads();                              // s_s is rewritten next
  }

  const float denom = fmaxf(l, 1e-30f);
  float* orow = out + static_cast<long long>(row) * d;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int dd = tid + v * THREADS;
    if (dd < d) orow[dd] = acc[v] / denom;
  }
}

template <int VPT>
int launch(const float* q, const float* enc_pages, const float* mask_pages,
           const int32_t* pt_enc, float* out, int rows, int beam, int npe,
           int ps, int d, int src_cap, cudaStream_t st) {
  const size_t smem = static_cast<size_t>(d + ps) * sizeof(float);
  // float4 row loads need every row of the pool on a 16-byte boundary: d a
  // multiple of 4 and the pool's base aligned (a view into a larger tensor
  // may start anywhere). q_s, in shared memory, is always aligned.
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(enc_pages) % 16 == 0)
    paged_attention_kernel<VPT, true><<<rows, THREADS, smem, st>>>(
        q, enc_pages, mask_pages, pt_enc, out, beam, npe, ps, d, src_cap);
  else
    paged_attention_kernel<VPT, false><<<rows, THREADS, smem, st>>>(
        q, enc_pages, mask_pages, pt_enc, out, beam, npe, ps, d, src_cap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: fp32 [rows, d] with rows = C * beam; enc_pages: fp32 [Pe, ps, d];
// mask_pages: fp32 [Pe, ps]; pt_enc: int32 [C, npe], each entry in
// [0, Pe); out: fp32 [rows, d]; all contiguous on the stream's card;
// 1 <= src_cap <= npe * ps; d <= 8 * 256. Returns cudaGetLastError() after
// the launch.
extern "C" int paged_attention(const void* q, const void* enc_pages,
                               const void* mask_pages, const void* pt_enc,
                               void* out, int rows, int beam, int npe, int ps,
                               int d, int src_cap, void* stream) {
  if (rows <= 0 || beam <= 0 || rows % beam || npe <= 0 || ps <= 0 ||
      d <= 0 || src_cap <= 0 || src_cap > npe * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* ef = static_cast<const float*>(enc_pages);
  const float* mf = static_cast<const float*>(mask_pages);
  const int32_t* pf = static_cast<const int32_t*>(pt_enc);
  float* of = static_cast<float*>(out);
  const int vpt = (d + THREADS - 1) / THREADS;
  if (vpt <= 1)
    return launch<1>(qf, ef, mf, pf, of, rows, beam, npe, ps, d, src_cap, st);
  if (vpt <= 2)
    return launch<2>(qf, ef, mf, pf, of, rows, beam, npe, ps, d, src_cap, st);
  if (vpt <= 4)
    return launch<4>(qf, ef, mf, pf, of, rows, beam, npe, ps, d, src_cap, st);
  if (vpt <= 8)
    return launch<8>(qf, ef, mf, pf, of, rows, beam, npe, ps, d, src_cap, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
