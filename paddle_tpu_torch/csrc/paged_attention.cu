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
// positions at or past src_cap are cut (the TPU kernel scores them -inf,
// which adds exp(-inf) = 0), and the output is the softmax-weighted sum of
// the rows, acc / max(l, 1e-30) (here acc times the reciprocal). A fully
// masked slot (an inactive slot, whose table points only at the reserved
// zero page 0) scores -FLT_MAX everywhere and gets the uniform average, as
// the oracle does: position 0 is always below src_cap, so the running max
// is finite from the first chunk on.
//
// What bounds it on the H100. Its bytes take less than a launch: the main
// decode path (C = 16 slots, beam 3, ps 16, NPE 2, src_cap 32, D 1024)
// moves about 2.2 MB (q and out, the distinct pages touched, the tables),
// 0.00065 ms at 3.35 TB/s. What its time is made of is the chain that one
// block walks from launch to last store: the table read, the copies of the
// page rows, the barriers, and the instructions of each step, which a
// block of 8 warps issues at a few cycles each. The design shortens that
// chain and spreads the bytes over many SMs.
//
// What the design does.
//  * One thread-block cluster per slot (and per group of at most 16 beam
//    rows; every beam the engine configures is one group). The cluster's n
//    blocks each own a slice of D/n columns (a multiple of 4) for all the
//    group's beam rows; the wrapper's launch_plan takes slices of 256 to
//    511 columns (n 4 at D 1024: 64 blocks on the decode path), fewer
//    blocks where the clusters would outnumber the SMs, and n 1 for small
//    D. (Clusters of 8 at D 1024 measured slower: not all of them start
//    together.)
//  * Each page row is read from device memory once. A thread a position
//    reads the table and keeps its pool row; a warp a row then copies the
//    [chunk, slice] part of the slot's rows below src_cap into shared
//    memory with cp.async (16-byte copies when D % 4 == 0 and the pool is
//    16-byte aligned, 4-byte copies otherwise), and both products read
//    that one copy; no other block reads those columns. Positions go in
//    chunks of at most 64 rows, double-buffered: the next chunk's copies
//    are in flight while this one is computed. At the decode shape the
//    whole source (32 rows) is one chunk. (A slot with more than 16 beam
//    rows is cut into groups, one cluster each; each group reads the pages
//    again.)
//  * Scores are summed across the cluster through distributed shared
//    memory, with no second pass. A lane a position and a warp a run of
//    the slice's columns score four beam rows per 16-byte piece read; the
//    runs are summed in order and each block writes its partial scores
//    into its own place in every peer's shared memory; one cluster barrier
//    (release, acquire) later every block sums the n partials in rank
//    order 0..n-1 from its own shared memory. Every block so holds bitwise
//    the same scores, maxima and sums, and the kernel is deterministic.
//    The mask and the src_cap cut apply to the sums; a warp keeps the
//    online max (one redux.sync) and sum of four rows at once; each block
//    then computes P.V for its own columns from the shared copy (a warp a
//    beam row and 128 columns, four interleaved partial sums) and writes
//    its slice of the output. Nothing is combined across blocks after
//    that, and the peers only ever write into a block before that barrier,
//    so no closing barrier is needed.
//  * The products stay fp32 FFMA: they are [rows, D].[D, chunk] with 1-3
//    rows on the decode path, which leaves nothing for the tensor cores to
//    do that the FMA units do not do as fast.
#include <cfloat>
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "port_cuda.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// what the launcher accepts (the wrapper's launch_plan stays inside it)
constexpr int MAX_GROUP = 16;      // beam rows a cluster holds
constexpr int MAX_CHUNK = 64;      // positions a chunk holds
constexpr size_t MAX_SMEM = 232448;

__host__ __device__ inline int round4(int x) { return (x + 3) & ~3; }

__host__ __device__ inline int pow2_floor(int x) {
  int p = 1;
  while (2 * p <= x) p *= 2;
  return p;
}

// The score pass's column runs: each warp takes a (32 positions, four
// beam rows, run of the slice's columns); this many runs (1..8) give every
// warp one. The wrapper's col_parts mirrors it.
__host__ __device__ inline int col_parts(int group, int chunk) {
  const int items = ((chunk + 31) / 32) * ((group + 3) / 4);
  return min(8, pow2_floor(max(1, WARPS / items)));
}

// The row pitch of the shared copies, in floats: the width rounded up to
// 8, plus 4, so that a warp reading one 16-byte piece from each of 32 rows
// touches every bank once per quarter-warp.
__host__ __device__ inline int row_pitch(int width) {
  return ((width + 7) & ~7) + 4;
}

// The dynamic shared memory of one block, in floats; the wrapper's
// smem_bytes mirrors it. Every region is a multiple of 4 floats, so the
// float4 and int64 views stay aligned.
__host__ __device__ inline int smem_floats(int n, int width, int chunk,
                                           int group, int chunks) {
  const int kp = row_pitch(width), gp = round4(group);
  const int stages = chunks > 1 ? 2 : 1;
  return stages * chunk * kp                            // k_s: page rows
         + gp * kp                                      // q_s: q slice
         + (chunks > 1 ? gp * kp : 0)                   // acc_s
         + stages * n * chunk * gp                      // xch_s
         + col_parts(group, chunk) * chunk * gp         // cpart_s
         + chunk * gp                                   // p_s
         + round4(stages * chunk)                       // mask_s
         + 3 * gp                                       // m, l, alpha
         + round4(2 * stages * chunk);                  // rowoff_s
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The cluster barrier: arrive with release (this block's writes into the
// peers' shared memory are visible to them), wait with acquire.
__device__ __forceinline__ void cluster_barrier() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::
          : "memory");
}

// Starts the copies of one chunk into a stage: the slice [c0, c0 + w) of
// its page rows (16-byte copies when VEC, else 4-byte) and its mask
// entries, a warp a row; rowoff holds each position's row of the pool
// (page * ps + row in page).
template <bool VEC>
__device__ __forceinline__ void issue_chunk(
    float* dst, float* mask_dst, const long long* rowoff,
    const float* enc_pages, const float* mask_pages, int valid, int kp,
    int d, int c0, int w) {
  const int lane = threadIdx.x & 31;
#pragma unroll 1
  for (int k = threadIdx.x >> 5; k < valid; k += WARPS) {
    const long long row = rowoff[k];
    const float* src = enc_pages + row * d + c0;
    if (VEC) {
#pragma unroll 1
      for (int i = 4 * lane; i < w; i += 128)
        cp_async16(dst + k * kp + i, src + i);
    } else {
#pragma unroll 1
      for (int i = lane; i < w; i += 32) cp_async4(dst + k * kp + i, src + i);
    }
    if (lane == 0) cp_async4(mask_dst + k, mask_pages + row);
  }
}

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float s) {
  s = fmaf(a.x, b.x, s);
  s = fmaf(a.y, b.y, s);
  s = fmaf(a.z, b.z, s);
  return fmaf(a.w, b.w, s);
}

// The maximum over the warp of a float that is not NaN: the float's bits
// mapped to an int of the same order, one redux.sync, mapped back.
__device__ __forceinline__ float warp_max(float x) {
  const int i = __float_as_int(x);
  const int key = __reduce_max_sync(0xffffffffu, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(key >= 0 ? key : key ^ 0x7fffffff);
}

__device__ __forceinline__ void fma4(float4& a, float p, const float4& v) {
  a.x = fmaf(p, v.x, a.x);
  a.y = fmaf(p, v.y, a.y);
  a.z = fmaf(p, v.z, a.z);
  a.w = fmaf(p, v.w, a.w);
}

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// floor(pos / ps), from inv_ps = 1.0f / ps: a float estimate, corrected
// (the estimate is exact or one off below 2^22 positions).
__device__ __forceinline__ int page_of(int pos, int ps, float inv_ps) {
  int j = __float2int_rz((static_cast<float>(pos) + 0.5f) * inv_ps);
  while (j * ps > pos) --j;
  while ((j + 1) * ps <= pos) ++j;
  return j;
}

template <bool VEC>
__global__ void __launch_bounds__(THREADS)
paged_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ enc_pages,
                       const float* __restrict__ mask_pages,
                       const int32_t* __restrict__ pt_enc,
                       float* __restrict__ out, int beam, int npe, int ps,
                       int d, int src_cap, int width, int chunk, int group,
                       int chunks, int cp_n, float inv_ps) {
  cg::cluster_group cluster = cg::this_cluster();
  const int n = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  unsigned slot;                                 // the cluster's index
  asm("mov.u32 %0, %%clusterid.x;" : "=r"(slot));
  const int b_first = blockIdx.y * group;        // the group's first row
  const int rows = min(group, beam - b_first);   // beam rows of the group
  const int quads = (rows + 3) >> 2;
  const int c0 = rank * width;                   // this block's columns
  const int w = min(width, d - c0);              // > 0 (launcher checks)
  const int w4 = (w + 3) >> 2;
  const int kp = row_pitch(width), kp4 = kp >> 2;
  const int gp = round4(group), gp4 = gp >> 2;
  const int cp_lg = __ffs(cp_n) - 1;
  const int stages = chunks > 1 ? 2 : 1;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* q_s = k_s + stages * chunk * kp;
  float4* acc4 = reinterpret_cast<float4*>(q_s + gp * kp);
  float4* xch4 = acc4 + (chunks > 1 ? gp4 * kp : 0);
  float4* cpart4 = xch4 + stages * n * chunk * gp4;
  float* p_s = reinterpret_cast<float*>(cpart4 + cp_n * chunk * gp4);
  float* mask_s = p_s + chunk * gp;
  float* m_s = mask_s + round4(stages * chunk);
  float* l_s = m_s + gp;
  float* alpha_s = l_s + gp;
  long long* rowoff_s = reinterpret_cast<long long*>(alpha_s + gp);

  const int32_t* pt_row = pt_enc + static_cast<long long>(slot) * npe;
  const long long q_row0 = static_cast<long long>(slot) * beam + b_first;

  // Prologue: a thread a position of the first two chunks reads its table
  // entry (first, so that the q copies overlap the read) and keeps its
  // pool row; the q slice's copies; zeros in the columns [w, 4*w4) that
  // the float4 loops read past a slice whose width is not a multiple of 4;
  // the softmax state.
  const bool first_pos = tid < stages * chunk && tid < src_cap;
  const int first_j = first_pos ? page_of(tid, ps, inv_ps) : 0;
  const int first_page = first_pos ? pt_row[first_j] : 0;
  const bool q_vec = VEC && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
#pragma unroll 1
  for (int b = warp; b < rows; b += WARPS) {
    const float* src = q + (q_row0 + b) * d + c0;
    if (q_vec) {
#pragma unroll 1
      for (int col = 4 * lane; col < w; col += 128)
        cp_async16(q_s + b * kp + col, src + col);
    } else {
#pragma unroll 1
      for (int col = lane; col < w; col += 32)
        cp_async4(q_s + b * kp + col, src + col);
    }
  }
  if (first_pos)
    rowoff_s[tid] =
        static_cast<long long>(first_page) * ps + tid - first_j * ps;
  if (w & 3) {
#pragma unroll 1
    for (int r = warp; r < stages * chunk + gp; r += WARPS)  // k_s, q_s rows
      if (lane < 4 * w4 - w) k_s[r * kp + w + lane] = 0.f;
  }
  if (tid < gp) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  __syncthreads();                               // rowoff_s
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    issue_chunk<VEC>(k_s + s * chunk * kp, mask_s + s * chunk,
                     rowoff_s + s * chunk, enc_pages, mask_pages,
                     min(chunk, src_cap - s * chunk), kp, d, c0, w);
    cp_async_commit();                           // q goes with chunk 0
  }

#pragma unroll 1
  for (int ch = 0; ch < chunks; ++ch) {
    const int st = ch & 1;
    const int valid = min(chunk, src_cap - ch * chunk);
    const bool last = ch + 1 == chunks;
    const float4* k4 = reinterpret_cast<const float4*>(k_s + st * chunk * kp);
    // the table entries of chunk ch + 2, read now, used after this chunk
    const bool refill = ch + 2 < chunks;
    const int next_pos = (ch + 2) * chunk + tid;
    int next_j = 0, next_page = 0;
    if (refill && tid < chunk && next_pos < src_cap) {
      next_j = page_of(next_pos, ps, inv_ps);
      next_page = pt_row[next_j];
    }
    if (ch + 1 < chunks)
      cp_async_wait_one();
    else
      cp_async_wait_all();
    __syncthreads();

    // A: partial scores over this block's columns: a warp a (32 positions,
    // four beam rows, run of columns), a lane a position; each 16-byte
    // piece of a page row read once for the four rows.
    {
      const float4* q4 = reinterpret_cast<const float4*>(q_s);
      const int per = (w4 + cp_n - 1) >> cp_lg;
      const int items = (((valid + 31) >> 5) * quads) << cp_lg;
#pragma unroll 1
      for (int it = warp; it < items; it += WARPS) {
        const int run = it & (cp_n - 1);
        int qd = it >> cp_lg, k = lane;          // it >> cp_lg: 32s * quads
        if (qd >= quads) {
          qd -= quads;
          k += 32;
        }
        if (k >= valid) continue;
        const int i1 = min(w4, (run + 1) * per);
        float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
        for (int i = run * per; i < i1; ++i) {
          const float4 kv = k4[k * kp4 + i];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            s[j] = dot4(q4[(4 * qd + j) * kp4 + i], kv, s[j]);
        }
        cpart4[(run * chunk + k) * gp4 + qd] =
            make_float4(s[0], s[1], s[2], s[3]);
      }
    }
    __syncthreads();
    // With peers, the runs summed in order, then written into this
    // block's place in every peer's exchange buffer (and its own): a
    // thread a (position, four beam rows).
    if (n > 1) {
      const int k = tid & 63, qd = tid >> 6;     // chunk <= 64, quads <= 4
      if (k < valid && qd < quads) {
        float4 v[8];                             // the loads in flight
#pragma unroll
        for (int run = 0; run < 8; ++run)
          v[run] = run < cp_n ? cpart4[(run * chunk + k) * gp4 + qd]
                              : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int run = 1; run < 8; ++run)
          if (run < cp_n) add4(v[0], v[run]);
        const int at = ((st * n + rank) * chunk + k) * gp4 + qd;
#pragma unroll 1
        for (int r = 0; r < n; ++r)
          cluster.map_shared_rank(xch4, r)[at] = v[0];
      }
      cluster_barrier();                         // every block's partials
    }

    // B: a warp a quad of beam rows, a lane a position: the full scores,
    // the n blocks' partials summed in rank order (the same order, so
    // bitwise the same scores, in every block; alone, its column runs in
    // order); the mask; the online max and sum of each row. The masked
    // scores wait in p_s between the two passes.
    const int terms = n > 1 ? n : cp_n;
    float4* p4w = reinterpret_cast<float4*>(p_s);
#pragma unroll 1
    for (int qd = warp; qd < quads; qd += WARPS) {
      float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll 1
      for (int k = lane; k < valid; k += 32) {
        const float4* x = (n > 1 ? xch4 + st * n * chunk * gp4 : cpart4) +
                          k * gp4 + qd;
        float4 v[8];                             // the loads in flight
#pragma unroll
        for (int r = 0; r < 8; ++r)
          v[r] = r < terms ? x[r * chunk * gp4] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int r = 1; r < 8; ++r)
          if (r < terms) add4(v[0], v[r]);
        if (!(mask_s[st * chunk + k] > 0.f))
          v[0] = make_float4(-FLT_MAX, -FLT_MAX, -FLT_MAX, -FLT_MAX);
        p4w[k * gp4 + qd] = v[0];
        mx[0] = fmaxf(mx[0], v[0].x);
        mx[1] = fmaxf(mx[1], v[0].y);
        mx[2] = fmaxf(mx[2], v[0].z);
        mx[3] = fmaxf(mx[3], v[0].w);
      }
      float m_old[4], m_new[4], sum[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        m_old[e] = m_s[4 * qd + e];
        m_new[e] = fmaxf(m_old[e], warp_max(mx[e]));
        sum[e] = 0.f;
      }
#pragma unroll 1
      for (int k = lane; k < valid; k += 32) {
        const float4 sc = p4w[k * gp4 + qd];
        const float4 p = make_float4(
            expf(sc.x - m_new[0]), expf(sc.y - m_new[1]),
            expf(sc.z - m_new[2]), expf(sc.w - m_new[3]));
        sum[0] += p.x;
        sum[1] += p.y;
        sum[2] += p.z;
        sum[3] += p.w;
        p4w[k * gp4 + qd] = p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], off);
      }
      if (lane < 4 && 4 * qd + lane < rows) {    // lane e keeps row 4*qd+e
        float mo = m_old[0], mn = m_new[0], sm = sum[0];
#pragma unroll
        for (int e = 1; e < 4; ++e)
          if (lane == e) {
            mo = m_old[e];
            mn = m_new[e];
            sm = sum[e];
          }
        const int b = 4 * qd + lane;
        const float alpha = expf(mo - mn);         // 0 on the first chunk
        alpha_s[b] = alpha;
        l_s[b] = l_s[b] * alpha + sm;
        m_s[b] = mn;
      }
    }
    __syncthreads();

    // D: P.V over this block's columns: a warp a (beam row, 32-column4
    // run), a lane four columns; the sum over the positions in four
    // interleaved partial sums, added in order at the end.
    {
      int cc_lg = 0;                             // 32 << cc_lg >= w4
      while ((32 << cc_lg) < w4) ++cc_lg;
#pragma unroll 1
      for (int it = warp; it < rows << cc_lg; it += WARPS) {
        const int b = it >> cc_lg;
        const int col4 = ((it & ((1 << cc_lg) - 1)) << 5) + lane;
        if (col4 >= w4) continue;
        float4 a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        int k = 0;
#pragma unroll 1
        for (; k + 3 < valid; k += 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            fma4(a[j], p_s[(k + j) * gp + b], k4[(k + j) * kp4 + col4]);
        }
#pragma unroll 1
        for (; k < valid; ++k) fma4(a[0], p_s[k * gp + b], k4[k * kp4 + col4]);
        add4(a[0], a[1]);
        add4(a[2], a[3]);
        add4(a[0], a[2]);
        if (ch > 0) fma4(a[0], alpha_s[b], acc4[b * kp4 + col4]);
        if (!last) {
          acc4[b * kp4 + col4] = a[0];
        } else {
          const float inv = __frcp_rn(fmaxf(l_s[b], 1e-30f));
          float* o = out + (q_row0 + b) * d + c0 + 4 * col4;
          const float v[4] = {a[0].x, a[0].y, a[0].z, a[0].w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (4 * col4 + e < w) o[e] = v[e] * inv;
        }
      }
    }

    if (refill) {                                // chunk ch + 2 into stage st
      __syncthreads();                           // stage st, rowoff_s read
      if (tid < chunk && next_pos < src_cap)
        rowoff_s[st * chunk + tid] =
            static_cast<long long>(next_page) * ps + next_pos - next_j * ps;
      __syncthreads();
      issue_chunk<VEC>(k_s + st * chunk * kp, mask_s + st * chunk,
                       rowoff_s + st * chunk, enc_pages, mask_pages,
                       min(chunk, src_cap - (ch + 2) * chunk), kp, d, c0, w);
      cp_async_commit();
    }
  }
  // No closing cluster barrier: the peers only write into this block's
  // shared memory, and the last of those writes came before the last
  // cluster barrier.
}

template <bool VEC>
int launch(const float* q, const float* enc_pages, const float* mask_pages,
           const int32_t* pt_enc, float* out, int slots, int beam, int npe,
           int ps, int d, int src_cap, int n, int width, int chunk,
           int group, int chunks, size_t smem, cudaStream_t st) {
  static bool smem_set = false;   // once per instantiation
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_attention_kernel<VEC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(MAX_SMEM));
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(slots * n, (beam + group - 1) / group, 1);
  cfg.blockDim = dim3(THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, paged_attention_kernel<VEC>, q, enc_pages, mask_pages, pt_enc,
      out, beam, npe, ps, d, src_cap, width, chunk, group, chunks,
      col_parts(group, chunk), 1.f / ps);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q: fp32 [rows, d] with rows = C * beam; enc_pages: fp32 [Pe, ps, d];
// mask_pages: fp32 [Pe, ps]; pt_enc: int32 [C, npe], each entry in
// [0, Pe); out: fp32 [rows, d]; all contiguous on the stream's card;
// 1 <= src_cap <= npe * ps. The launch plan (the wrapper's launch_plan):
// a cluster of n in {1, 2, 4, 8} blocks a slot, each holding `width`
// columns (the last one d - (n-1)*width of them, at least 1; width a
// multiple of 4), `chunk` positions at a time (1..64), `group` beam rows a
// cluster (1..16). Returns the launch's cudaError_t, or
// cudaErrorInvalidValue for arguments outside that.
extern "C" int paged_attention(const void* q, const void* enc_pages,
                               const void* mask_pages, const void* pt_enc,
                               void* out, int rows, int beam, int npe, int ps,
                               int d, int src_cap, int n, int width,
                               int chunk, int group, void* stream) {
  if (rows <= 0 || beam <= 0 || rows % beam || npe <= 0 || ps <= 0 ||
      d <= 0 || src_cap <= 0 || src_cap > npe * ps)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((n != 1 && n != 2 && n != 4 && n != 8) || width <= 0 || width % 4 ||
      static_cast<long long>(n - 1) * width >= d ||
      static_cast<long long>(n) * width < d || chunk < 1 ||
      chunk > MAX_CHUNK || group < 1 || group > MAX_GROUP || group > beam)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = (src_cap + chunk - 1) / chunk;
  const size_t smem =
      static_cast<size_t>(smem_floats(n, width, chunk, group, chunks)) *
      sizeof(float);
  if (smem > MAX_SMEM) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* ef = static_cast<const float*>(enc_pages);
  const float* mf = static_cast<const float*>(mask_pages);
  const int32_t* pf = static_cast<const int32_t*>(pt_enc);
  float* of = static_cast<float*>(out);
  const int slots = rows / beam;
  // 16-byte copies need every copied row slice on a 16-byte boundary: d a
  // multiple of 4 (width is) and the pool's base aligned (a view into a
  // larger tensor may start anywhere).
  if (d % 4 == 0 && reinterpret_cast<uintptr_t>(enc_pages) % 16 == 0)
    return launch<true>(qf, ef, mf, pf, of, slots, beam, npe, ps, d, src_cap,
                        n, width, chunk, group, chunks, smem, st);
  return launch<false>(qf, ef, mf, pf, of, slots, beam, npe, ps, d, src_cap,
                       n, width, chunk, group, chunks, smem, st);
}
