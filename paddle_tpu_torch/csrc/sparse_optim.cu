// Fused sparse Adagrad and Adam updates for Hopper (sm_90a), fp32.
//
// Replaces the TPU kernels of paddle_tpu/ops/kernels/sparse_optim.py:
//   sparse_adagrad  <- fused_sparse_adagrad (pallas_call :109, body
//                      _adagrad_kernel :57)
//   sparse_adam     <- fused_sparse_adam (pallas_call :149, body
//                      _adam_kernel :72)
//
// What they compute. An is_sparse table's gradient comes as C occurrences:
// ids [C] (repeats included) and rows [C, D]. A nonlinear update must see
// each touched table row once, with the sum of its id's rows g. For each
// touched row u, element c:
//   adagrad: m' = m + g*g;  p += -lr * g / (sqrt(m') + eps)
//   adam:    m1' = b1*m1 + (1-b1)*g;  m2' = b2*m2 + ((1-b2)*g)*g
//            p += -lr * m1' / (sqrt(m2') + eps)
// on the table rows p[u], m[u] (m1[u], m2[u]) IN PLACE, as the TPU kernel
// aliases them (input_output_aliases): only the touched rows move, and no
// [C, D] gathered copy or full-table copy exists. lr is a device scalar
// (Adam's bias-corrected rate, computed on the card), read here so the
// host never waits for it. Moments are written as m + (m' - m), the
// delta form of the plain version, and every operation is an explicit
// round-to-nearest intrinsic (__fmul_rn, __fadd_rn, ...), which nvcc
// never contracts into an FMA: the kernel evaluates the plain torch
// version's expression in its order and rounding, element for element.
//
// Two ways in, one kernel body:
// * rows form (the main path): the ids sorted (stable, by the caller, a
//   torch sort as the JAX package leaves its sort to XLA) with `order`,
//   sorted position -> occurrence, and the per-occurrence rows. The merge
//   (sum each id's rows) happens here: position i heads a segment when
//   i == 0 or its id differs from position i-1's; the head's threads (or,
//   for a segment longer than the window, its block) sum rows[order[j]]
//   for j = i, i+1, ... while the id holds, in ascending j from 0.0f,
//   which is the order in which the plain merge's index_add_ adds them on
//   the CPU: bitwise its result.
// * merged form (the TPU kernel's own contract, _merge_sparse's output):
//   uids [N] int64, merged rows gm [N, D] and a valid mask; invalid slots
//   carry id 0 and are neither a head nor part of any segment: they store
//   nothing. Valid uids are unique, so each valid slot is a segment of
//   one, with order the identity.
//
// The GPU hazard. The TPU kernel is right only because its grid runs the
// slots in order, reversed, so the no-op writes of the invalid slots that
// are clamped to row 0 land before the one valid visit of row 0
// (sparse_optim.py:18-29). GPU blocks run concurrently and in no order,
// so here a thread writes only the row of the segment it heads. Each id
// heads exactly one segment, so no two threads ever write the same
// element: no atomics, and the result does not depend on the schedule
// (two launches are bitwise equal; the merge it replaces summed repeated
// ids with index_add_'s atomics on the card, in run-to-run order).
//
// What bounds it on the H100: bytes, and below them latency. Per touched
// element it does about ten fp32 operations against 16 bytes moved for
// Adagrad and 28 for Adam (each table element read and written once), plus
// the rows, ids and order read once. On DeepFM's step (C = 256 x 26 =
// 6,656 occurrences, 6,424 distinct, D = 10) Adam moves about
// 1.9 MB, 0.57 us at 3.35 TB/s, under the time of one launch: the kernel
// is a chain of dependent loads (the sorted id, then the order entry and
// the table rows, then the gradient row) after a launch.
//
// What the design does about it: one flat grid over the C x D elements,
// 256 threads a block, thread t on sorted position t / D, column t % D,
// so neighbouring threads read neighbouring elements of one row. Each
// thread loads its id, its predecessor's and the next WINDOW - 1 ids and
// order entries (its window) in one trip, before it knows whether it
// heads a segment. A head whose segment ends inside the window (the main
// path: DeepFM's ids repeat a few times at most) loads its table values
// with the segment's rows and adds the rows in order. A longer segment
// (a duplicate-heavy or skewed batch: a field with one value in every
// example) would be a chain of dependent loads for one thread, hundreds
// of microseconds for thousands of repeats; the head's block sums it
// instead: every thread stages a chunk of the segment's rows in shared
// memory (8 KB), and one thread a column adds them in ascending position,
// so the order, and the sum, stay the head's own. A table row of 4-40
// bytes is one 32-byte sector, read once and written once.
#include <cuda_runtime.h>
#include <stdint.h>

#include "port_cuda.cuh"

namespace {

constexpr int THREADS = 256;
// the window of sorted positions a thread loads: a segment that ends in
// it is summed by its head thread, a longer one by the head's block
constexpr int WINDOW = 8;
// floats of a block's staging buffer for a long segment's rows (8 KB)
constexpr int STAGE = 2048;

struct Adagrad {
  float* __restrict__ p;
  float* __restrict__ m;
  float eps;
  float pv, mv;

  __device__ __forceinline__ void load(long long e) {
    pv = p[e];
    mv = m[e];
  }
  __device__ __forceinline__ void update(long long e, float g, float lr) {
    const float m_new = __fadd_rn(mv, __fmul_rn(g, g));
    const float delta = __fdiv_rn(__fmul_rn(-lr, g),
                                  __fadd_rn(__fsqrt_rn(m_new), eps));
    p[e] = __fadd_rn(pv, delta);
    m[e] = __fadd_rn(mv, __fsub_rn(m_new, mv));
  }
};

// omb1 and omb2 are (1 - b1) and (1 - b2), rounded to fp32 by the caller
// as the plain version rounds them
struct Adam {
  float* __restrict__ p;
  float* __restrict__ m1;
  float* __restrict__ m2;
  float b1, omb1, b2, omb2, eps;
  float pv, a, b;

  __device__ __forceinline__ void load(long long e) {
    pv = p[e];
    a = m1[e];
    b = m2[e];
  }
  __device__ __forceinline__ void update(long long e, float g, float lr) {
    const float a_new = __fadd_rn(__fmul_rn(b1, a), __fmul_rn(omb1, g));
    const float b_new = __fadd_rn(__fmul_rn(b2, b),
                                  __fmul_rn(__fmul_rn(omb2, g), g));
    const float delta = __fdiv_rn(__fmul_rn(-lr, a_new),
                                  __fadd_rn(__fsqrt_rn(b_new), eps));
    p[e] = __fadd_rn(pv, delta);
    m1[e] = __fadd_rn(a, __fsub_rn(a_new, a));
    m2[e] = __fadd_rn(b, __fsub_rn(b_new, b));
  }
};

// positions j .. j + WINDOW - 1 of the sorted ids and the order, loaded
// unconditionally (clamped to the last position, so the loads issue
// together); -1 (no id: ids are table rows, >= 0) past the end
template <typename Id>
__device__ __forceinline__ void load_window(
    const Id* __restrict__ ids, const int64_t* __restrict__ order, int n,
    int j, Id (&nid)[WINDOW], long long (&o)[WINDOW]) {
#pragma unroll
  for (int k = 0; k < WINDOW; ++k) {
    const int jj = min(j + k, n - 1);
    const Id v = ids[jj];
    o[k] = order[jj];
    nid[k] = j + k < n ? v : Id(-1);
  }
}

// A segment longer than the window, summed by the whole block (every
// thread calls this, with the same start). For each run of up to THREADS
// columns, chunks of up to THREADS positions of the segment's rows are
// staged in shared memory, all threads loading at once, the block counting
// the chunk's positions that are still the segment's (a prefix: the ids
// are sorted); one thread a column then adds them in ascending position,
// eight a step from 16-byte loads, while every thread loads the next
// chunk's ids and order entries: the head thread's order, so the sum is
// the same bit for bit.
template <class Rule, typename Id>
__device__ __forceinline__ void long_segment(
    Rule& rule, const Id* __restrict__ ids,
    const int64_t* __restrict__ order, const float* __restrict__ g,
    float lr, int n, int d, int start, float (&buf)[STAGE]) {
  constexpr int SLOTS = STAGE / THREADS;
  const Id id = ids[start];
  const int tid = threadIdx.x;
  for (int c0 = 0; c0 < d; c0 += THREADS) {
    const int w = min(d - c0, THREADS);
    // positions a chunk, a multiple of 4 (16-byte rows of buf)
    const int ch = min(STAGE / w, THREADS) & ~3;
    // slot tid + r * THREADS of a chunk: position p[r], column
    // tid + r * THREADS - p[r] * w (slots past ch * w are not staged), kept
    // at buf[column * ch + position]: a column's positions are contiguous
    int p[SLOTS];
#pragma unroll
    for (int r = 0; r < SLOTS; ++r) p[r] = (tid + r * THREADS) / w;
    const long long e = static_cast<long long>(id) * d + c0 + tid;
    if (tid < w) rule.load(e);
    float sum = 0.0f;
    // this thread's ids and order entries of a chunk, and whether its own
    // position of the chunk is the segment's (the count's vote)
    Id sid[SLOTS];
    long long oj[SLOTS];
    bool mine;
    auto load_ids = [&](int j0) {
#pragma unroll
      for (int r = 0; r < SLOTS; ++r) {
        const int j = min(j0 + p[r], n - 1);
        sid[r] = ids[j];
        oj[r] = order[j];
      }
      mine = tid < ch && j0 + tid < n && ids[min(j0 + tid, n - 1)] == id;
    };
    load_ids(start);
    for (int j0 = start;; j0 += ch) {
      // the chunk's rows, all of this thread's loads at once, then stored
      float v[SLOTS];
#pragma unroll
      for (int r = 0; r < SLOTS; ++r) {
        const int col = tid + r * THREADS - p[r] * w;
        v[r] = j0 + p[r] < n && sid[r] == id ? g[oj[r] * d + c0 + col]
                                             : 0.0f;
      }
#pragma unroll
      for (int r = 0; r < SLOTS; ++r)
        if (tid + r * THREADS < ch * w)
          buf[(tid + r * THREADS - p[r] * w) * ch + p[r]] = v[r];
      // the chunk's positions that are the segment's: one a thread
      const int count = __syncthreads_count(mine);
      // the same in every thread: whether the segment goes on past this
      // chunk; if so, the next chunk's ids and order are loaded while
      // this one is added
      const bool more = count == ch && j0 + ch < n && ids[j0 + ch] == id;
      if (more) load_ids(j0 + ch);
      if (tid < w) {
        // eight positions a step (two 16-byte loads), two steps unrolled
        // so that the next step's loads issue before this step's adds
        const float* col = buf + tid * ch;
        const float4* col4 = reinterpret_cast<const float4*>(col);
        int q = 0;
#pragma unroll 2
        for (; q + 8 <= count; q += 8) {
          const float4 a = col4[q / 4];
          const float4 b = col4[q / 4 + 1];
          sum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(sum, a.x), a.y),
                                    a.z), a.w);
          sum = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(sum, b.x), b.y),
                                    b.z), b.w);
        }
        for (; q < count; ++q) sum = __fadd_rn(sum, col[q]);
      }
      __syncthreads();                         // read before the refill
      if (!more) break;
    }
    if (tid < w) rule.update(e, sum, lr);
  }
}

// ROWS: ids sorted with their order, g the per-occurrence rows [n, d].
// Otherwise ids are the merged uids, g the merged rows, valid the mask.
// At most 128 registers a thread, so that two blocks fit an SM: DeepFM's
// 260 blocks then run in one wave on the 132 SMs.
template <class Rule, typename Id, bool ROWS>
__global__ void __launch_bounds__(THREADS, 2)
sparse_update_kernel(Rule rule, const Id* __restrict__ ids,
                     const int64_t* __restrict__ order,
                     const float* __restrict__ g,
                     const uint8_t* __restrict__ valid,
                     const float* __restrict__ lr, int n, int d) {
  const long long t = blockIdx.x * static_cast<long long>(THREADS)
                      + threadIdx.x;
  const bool live = t < static_cast<long long>(n) * d;
  const int i = static_cast<int>(t / d);
  const int c = static_cast<int>(t - static_cast<long long>(i) * d);
  if constexpr (!ROWS) {
    if (!live || !valid[i]) return;        // no store for an invalid slot
    const long long e = static_cast<long long>(ids[i]) * d + c;
    rule.load(e);
    rule.update(e, g[t], lr[0]);
  } else {
    // the block's heads of segments longer than the window, by position
    __shared__ int longs[THREADS];
    __shared__ int n_longs;
    __shared__ __align__(16) float buf[STAGE];
    if (threadIdx.x == 0) n_longs = 0;
    __syncthreads();
    if (live) {
      Id nid[WINDOW];
      long long o[WINDOW];
      load_window(ids, order, n, i, nid, o);
      const Id id = nid[0];
      if (i == 0 || ids[i - 1] != id) {      // heads a segment
        if (nid[WINDOW - 1] != id) {
          // the segment ends inside the window: this thread sums it, in
          // ascending position from 0.0 (a position past it adds -0.0,
          // which leaves any sum bit for bit as it was)
          const long long e = static_cast<long long>(id) * d + c;
          rule.load(e);
          float v[WINDOW];
#pragma unroll
          for (int k = 0; k < WINDOW; ++k)
            v[k] = nid[k] == id ? g[o[k] * d + c] : -0.0f;
          float sum = 0.0f;
#pragma unroll
          for (int k = 0; k < WINDOW; ++k) sum = __fadd_rn(sum, v[k]);
          rule.update(e, sum, lr[0]);
        } else if (c == 0) {
          longs[atomicAdd(&n_longs, 1)] = i;
        }
      }
    }
    __syncthreads();
    // the list's order varies from launch to launch; each segment's sum
    // does not depend on it
    for (int h = 0; h < n_longs; ++h)
      long_segment(rule, ids, order, g, lr[0], n, d, longs[h], buf);
  }
}

inline unsigned int blocks_for(long long total) {
  return static_cast<unsigned int>((total + THREADS - 1) / THREADS);
}

// The launch of either form: order == nullptr takes the merged form (int64
// uids, valid required), else the rows form (sorted ids of id_bytes 4 or
// 8, no valid mask).
template <class Rule>
int launch(const Rule& rule, const void* ids, int id_bytes,
           const void* order, const void* g, const void* valid,
           const void* lr, int n, int d, void* stream) {
  const long long total = static_cast<long long>(n) * d;
  if (total <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t* of = static_cast<const int64_t*>(order);
  const float* gf = static_cast<const float*>(g);
  const uint8_t* vf = static_cast<const uint8_t*>(valid);
  const float* lf = static_cast<const float*>(lr);
  const unsigned int blocks = blocks_for(total);
  if (order == nullptr) {
    if (valid == nullptr || id_bytes != 8) return (int)cudaErrorInvalidValue;
    sparse_update_kernel<Rule, int64_t, false><<<blocks, THREADS, 0, st>>>(
        rule, static_cast<const int64_t*>(ids), of, gf, vf, lf, n, d);
  } else if (valid != nullptr) {
    return (int)cudaErrorInvalidValue;
  } else if (id_bytes == 4) {
    sparse_update_kernel<Rule, int32_t, true><<<blocks, THREADS, 0, st>>>(
        rule, static_cast<const int32_t*>(ids), of, gf, vf, lf, n, d);
  } else if (id_bytes == 8) {
    sparse_update_kernel<Rule, int64_t, true><<<blocks, THREADS, 0, st>>>(
        rule, static_cast<const int64_t*>(ids), of, gf, vf, lf, n, d);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// p, m: fp32 [vocab, d]. Merged form (order NULL): ids int64 uids [n], each
// valid one a row of the tables and unique, g fp32 [n, d] merged rows,
// valid bool [n]. Rows form: ids [n] sorted (int32 or int64: id_bytes),
// order int64 [n] (sorted position -> occurrence), g fp32 [n, d] the
// occurrences' rows, valid NULL. lr: fp32 [1]. All contiguous on the
// stream's card. Returns cudaGetLastError() after the launch.
extern "C" int sparse_adagrad(void* p, void* m, const void* ids,
                              int id_bytes, const void* order,
                              const void* g, const void* valid,
                              const void* lr, int n, int d, float eps,
                              void* stream) {
  Adagrad rule{static_cast<float*>(p), static_cast<float*>(m), eps, 0.f,
               0.f};
  return launch(rule, ids, id_bytes, order, g, valid, lr, n, d, stream);
}

// p, m1, m2: fp32 [vocab, d]; the rest as sparse_adagrad.
extern "C" int sparse_adam(void* p, void* m1, void* m2, const void* ids,
                           int id_bytes, const void* order, const void* g,
                           const void* valid, const void* lr, int n, int d,
                           float b1, float omb1, float b2, float omb2,
                           float eps, void* stream) {
  Adam rule{static_cast<float*>(p), static_cast<float*>(m1),
            static_cast<float*>(m2), b1, omb1, b2, omb2, eps, 0.f, 0.f, 0.f};
  return launch(rule, ids, id_bytes, order, g, valid, lr, n, d, stream);
}
