// Fused sparse Adagrad and Adam updates for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels of paddle_tpu/ops/kernels/sparse_optim.py:
//   sparse_adagrad  <- fused_sparse_adagrad (pallas_call :109, body
//                      _adagrad_kernel :57)
//   sparse_adam     <- fused_sparse_adam (pallas_call :149, body
//                      _adam_kernel :72)
//
// What they compute. The optimizer's merge (_merge_sparse, ops_impl/
// optim_ops.py) has turned an is_sparse table's gradient into N slots:
// uids [N] (each valid uid once; invalid slots clamped to row 0), the
// summed gradient rows gm [N, D] and a valid mask [N]. For each valid slot
// s, element c, with row u = uids[s] and g = gm[s, c]:
//   adagrad: m' = m + g*g;  p += -lr * g / (sqrt(m') + eps)
//   adam:    m1' = b1*m1 + (1-b1)*g;  m2' = b2*m2 + ((1-b2)*g)*g
//            p += -lr * m1' / (sqrt(m2') + eps)
// on the table rows p[u], m[u] (m1[u], m2[u]) IN PLACE, as the TPU kernel
// aliases them (input_output_aliases): only the touched rows move, and no
// [N, D] gathered copy or full-table copy exists. lr is a device scalar
// (Adam's bias-corrected rate, computed on the card), read here so the
// host never waits for it. Moments are written as m + (m' - m), the
// delta form of the plain version, and every operation is an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, ...), which nvcc
// never contracts into an FMA: the kernel evaluates the plain torch
// version's expression in its order and rounding, element for element.
//
// The GPU hazard. The TPU kernel is right only because its grid runs the
// slots in order, reversed, so the no-op writes of the invalid slots that
// are clamped to row 0 land before the one valid visit of row 0
// (sparse_optim.py:18-29). GPU blocks run concurrently and in no order,
// so here an invalid slot stores NOTHING. Valid uids are unique, so no two
// threads ever write the same element: no atomics, and the result does
// not depend on the schedule. An all-invalid merge leaves the tables
// bitwise unchanged.
//
// What bounds it on the H100: bytes. Per element it does about ten fp32
// operations against 16 bytes moved for Adagrad and 28 for Adam (gm read,
// each table element read and written once). On DeepFM's step
// (N = 256 x 26 = 6,656 slots, D = 10) Adam moves about 1.9 MB, 0.57 us
// at 3.35 TB/s, well under the time of one launch: the kernel is
// launch-bound at that size.
//
// What the design does about it: one flat grid over the N x D elements,
// 256 threads a block, thread t on slot t / D, column t % D. Neighbouring
// threads read neighbouring gm elements (coalesced), and a table row of
// 4-40 bytes is one 32-byte sector, so each touched row costs one sector
// per table per direction. Nothing is staged in shared memory: no element
// is read twice.
#include <cuda_runtime.h>
#include <stdint.h>

#include "port_cuda.cuh"

namespace {

constexpr int THREADS = 256;

// the slot's table row, or -1 when the slot is invalid
__device__ __forceinline__ long long slot_row(const int64_t* uids,
                                              const uint8_t* valid,
                                              long long s) {
  return valid[s] ? uids[s] : -1;
}

__global__ void __launch_bounds__(THREADS)
sparse_adagrad_kernel(float* __restrict__ p, float* __restrict__ m,
                      const int64_t* __restrict__ uids,
                      const float* __restrict__ gm,
                      const uint8_t* __restrict__ valid,
                      const float* __restrict__ lr, long long total, int d,
                      float eps) {
  const long long t = blockIdx.x * static_cast<long long>(THREADS)
                      + threadIdx.x;
  if (t >= total) return;
  const long long s = t / d;
  const long long u = slot_row(uids, valid, s);
  if (u < 0) return;                       // no store for an invalid slot
  const long long i = u * d + (t - s * d);
  const float g = gm[t];
  const float pv = p[i];
  const float mv = m[i];
  const float m_new = __fadd_rn(mv, __fmul_rn(g, g));
  const float delta = __fdiv_rn(__fmul_rn(-lr[0], g),
                                __fadd_rn(__fsqrt_rn(m_new), eps));
  p[i] = __fadd_rn(pv, delta);
  m[i] = __fadd_rn(mv, __fsub_rn(m_new, mv));
}

__global__ void __launch_bounds__(THREADS)
sparse_adam_kernel(float* __restrict__ p, float* __restrict__ m1,
                   float* __restrict__ m2, const int64_t* __restrict__ uids,
                   const float* __restrict__ gm,
                   const uint8_t* __restrict__ valid,
                   const float* __restrict__ lr, long long total, int d,
                   float b1, float omb1, float b2, float omb2, float eps) {
  const long long t = blockIdx.x * static_cast<long long>(THREADS)
                      + threadIdx.x;
  if (t >= total) return;
  const long long s = t / d;
  const long long u = slot_row(uids, valid, s);
  if (u < 0) return;                       // no store for an invalid slot
  const long long i = u * d + (t - s * d);
  const float g = gm[t];
  const float pv = p[i];
  const float a = m1[i];
  const float b = m2[i];
  const float a_new = __fadd_rn(__fmul_rn(b1, a), __fmul_rn(omb1, g));
  const float b_new = __fadd_rn(__fmul_rn(b2, b),
                                __fmul_rn(__fmul_rn(omb2, g), g));
  const float delta = __fdiv_rn(__fmul_rn(-lr[0], a_new),
                                __fadd_rn(__fsqrt_rn(b_new), eps));
  p[i] = __fadd_rn(pv, delta);
  m1[i] = __fadd_rn(a, __fsub_rn(a_new, a));
  m2[i] = __fadd_rn(b, __fsub_rn(b_new, b));
}

inline unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + THREADS - 1) / THREADS);
}

}  // namespace

// p, m: fp32 [vocab, d]; uids: int64 [n], each valid one in [0, vocab);
// gm: fp32 [n, d]; valid: bool [n]; lr: fp32 [1]; all contiguous on the
// stream's card. Returns cudaGetLastError() after the launch.
extern "C" int sparse_adagrad(void* p, void* m, const void* uids,
                              const void* gm, const void* valid,
                              const void* lr, int n, int d, float eps,
                              void* stream) {
  const long long total = static_cast<long long>(n) * d;
  if (total <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  float* mf = static_cast<float*>(m);
  const float* gf = static_cast<const float*>(gm);
  const uint8_t* vf = static_cast<const uint8_t*>(valid);
  const float* lf = static_cast<const float*>(lr);
  sparse_adagrad_kernel<<<blocks_for(total), THREADS, 0, st>>>(
      pf, mf, static_cast<const int64_t*>(uids), gf, vf, lf, total, d, eps);
  return (int)cudaGetLastError();
}

// p, m1, m2: fp32 [vocab, d]; the rest as sparse_adagrad. omb1 and omb2
// are (1 - b1) and (1 - b2), rounded to fp32 by the caller as the plain
// version rounds them.
extern "C" int sparse_adam(void* p, void* m1, void* m2, const void* uids,
                           const void* gm, const void* valid, const void* lr,
                           int n, int d, float b1, float omb1, float b2,
                           float omb2, float eps, void* stream) {
  const long long total = static_cast<long long>(n) * d;
  if (total <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* pf = static_cast<float*>(p);
  float* af = static_cast<float*>(m1);
  float* bf = static_cast<float*>(m2);
  const float* gf = static_cast<const float*>(gm);
  const uint8_t* vf = static_cast<const uint8_t*>(valid);
  const float* lf = static_cast<const float*>(lr);
  sparse_adam_kernel<<<blocks_for(total), THREADS, 0, st>>>(
      pf, af, bf, static_cast<const int64_t*>(uids), gf, vf, lf, total, d, b1,
      omb1, b2, omb2, eps);
  return (int)cudaGetLastError();
}
