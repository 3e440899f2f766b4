// Sorted systematic-resampling ancestors, for NVIDIA Hopper (sm_90a).
//
// Replaces bipk_tpu/ops/pallas_kernels.py systematic_ancestors_blocks
// (:2761) -> _systematic_cdf_kernel (:2614) + _systematic_merge_kernel
// (:2650). Same closed-form-offspring semantics as the plain version
// (bipk_tpu_torch/ops/resampling.py systematic): clip the weights at 0,
// keeping NaN as torch.clamp and jnp.maximum do, normalize (uniform when
// the mass is not positive, a NaN mass included), cdf, cumulative counts
// cc_i = clip(ceil(n cdf_i - u), 0, n), and sorted ancestors
// anc[k] = #{i < n-1 : cc_i <= k}.
//
// The cdf's floating-point operations are fixed for every n: segments of
// per = ceil(n/1024) weights, each summed serially in index order from
// 0; the offsets off[s+1] = fl(off[s] + sum[s]) in segment order;
// cdf_i = (off[s] + local_i) / total with IEEE division; and
// n * cdf - u as one fused multiply-add, as nvcc contracts it. Every
// kernel here computes exactly these, so their ancestors agree bit for
// bit. The cdf differs from the plain torch.cumsum only in summation
// order, so the ancestors agree with the plain version except where a
// grid point and a cdf value tie to within rounding (one output slot
// shifts).
//
// systematic_scan_kernel, the one the wrapper launches: ONE block of 1024
// threads for any n, one launch, thread t owning segment t.
//   1. each warp copies its 32 segments into shared memory as 32 rows of
//      an odd stride (cp.async, consecutive lanes on consecutive weights;
//      a column read by 32 lanes then hits 32 banks), and each lane sums
//      its row in order;
//   2. thread 0 runs the offset chain over the non-empty segments only
//      (x + 0 = x exactly, so empty ones change nothing), its loads a
//      batch ahead of its adds, while the other threads zero the rank
//      array A;
//   3. each lane walks its row again for cc_i. The cdf of the element
//      before segment t is off[t] / total (off[t] is the sum the previous
//      segment's last element adds), so every lane knows cc_{i-1} without
//      a neighbour. Where a run of equal counts ends (cc_{i-1} != cc_i, or
//      i = n-1), A[cc_{i-1}] = i, for cc_{i-1} < n: each slot is written
//      at most once, even when one particle owns every slot;
//   4. anc is the inclusive max-scan of A (identity 0): each thread scans
//      its own 1024th of the slots, the threads' aggregates are scanned
//      with warp shuffles, and the result is stored coalesced.
// Two layouts. Resident (up to n = ~36,000, where it fits): the rows stay
// in shared memory from phase 1 to phase 3 and A lives beside them in
// 16-bit slots (every slot value is below n <= 65536), a word of padding
// after every 32 slots against bank conflicts. Streamed (any n): both
// phases copy 21 columns at a time and A is anc itself, zeroed in the
// kernel. The entry picks the resident one wherever it fits, or the one
// its caller names (chip_smoke.py times the two against each other).
//
// systematic_kernel_per_thread, the comparator the port launched before
// (kept for chip_smoke.py's bitwise gate and timing, reached by no
// wrapper): the same cdf per thread on contiguous segments, thread 0
// scanning all 1024 segment sums, cc through global memory, and a binary
// search of cc per output slot.
//
// What bounds it on the H100: it moves 8n bytes (~0.26 MB at n = 32768,
// ~0.08 us at 3.35 TB/s), so one block's serial parts bound it, not bytes:
// the launch of a 1024-thread block, the ~1024 dependent adds of the
// offset chain, one SM's rate of copies in and stores out, and its
// instruction rate over the ~25 instructions per element of phase 3 (an
// IEEE division among them).

#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// max(w, 0) that keeps NaN (fmaxf would return 0 for it): one NaN weight
// makes the total NaN, and the `total > 0` test below then gives the
// uniform fallback, as in the plain version.
__device__ __forceinline__ float clip0(float w) { return w < 0.f ? 0.f : w; }

// clip(ceil(n cdf - u), 0, n): nvcc fuses n * cdf - u into one FFMA in
// the comparator (read off its SASS), written out here. The comparator's
// (int)fminf(fmaxf(ceilf(x), 0), nf) in one conversion and integer
// clamps: the same integer for every x (ceil is exact; a NaN, which
// fmaxf maps to 0, converts to 0; +-inf and values past the int range
// clamp to the same ends), with the top end (int)nf, as the comparator's.
__device__ __forceinline__ int grid_count(float cdf, float nf, float u, int n_top) {
  return min(max(__float2int_ru(__fmaf_rn(nf, cdf, -u)), 0), n_top);
}

// ---------------------------------------------------------------------------
// The scan kernel's plan. Its shared memory, in 4-byte words: the segment
// sums (then offsets), the warps' scan aggregates and the total, then the
// staged weights and, in the resident layout, the rank array A.
// ---------------------------------------------------------------------------

constexpr int kMaxSmemWords = 232448 / 4;  // an sm_90 block's opt-in maximum
constexpr int kFixedWords = (kThreads + kWarps + 1 + 3) & ~3;
// the columns staged at once in the streamed layout: 90 KB of shared
// memory, and the rest of the SM's 256 KB is L1 cache, which keeps the
// lines of anc that phase 4's threads walk
constexpr int kStreamedColumns = 21;

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// A's 16-bit slots in shared memory, with a word of padding after every
// 32 slots, so that a thread's run of slots starts in another bank than
// its neighbour's
__host__ __device__ __forceinline__ int padded(int v) { return v + (v >> 5) * 2; }

// A's words in shared memory: slots 0 .. n-1 padded, rounded up to int4s
__host__ __device__ __forceinline__ int rank_words(int n) {
  return ((padded(n - 1) + 1) / 2 + 4) & ~3;
}

// Where the weights are staged. Each warp stages its 32 segments as 32
// rows of stride s (segment t at row t % 32 of warp t / 32's rows), c
// columns at a time: all of them in the resident layout.
struct Plan {
  int per;    // weights per segment, ceil(n / 1024)
  int c, s;   // columns staged at once, and the rows' stride (odd)
  int words;  // dynamic shared memory in all
};

__host__ __device__ inline Plan make_plan(int n, bool resident) {
  Plan p;
  p.per = (n + kThreads - 1) / kThreads;
  p.c = resident ? p.per : imin(p.per, kStreamedColumns);
  p.s = p.c | 1;
  p.words = kFixedWords + kThreads * p.s + (resident ? rank_words(n) : 0);
  return p;
}

// whether the resident layout fits: its slots in 16 bits, its words in an
// SM's shared memory
inline bool resident_fits(int n) {
  return n <= 65536 && make_plan(n, true).words <= kMaxSmemWords;
}

// 4 bytes from global to shared memory without a register (cp.async), and
// the wait for all of this thread's copies; on a host build, a copy
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
#else
  *dst = *src;
#endif
}

__device__ __forceinline__ void copy_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;\n" ::: "memory");
#endif
}

// Start copying columns [c0, c0 + cw) of the warp's 32 segments of `per`
// weights (segment r from w[base + r * per]) into its rows of `stride`
// floats: item f = lane + 32 q is row f / cw, column f % cw, so that
// consecutive lanes read consecutive weights. Then copy_wait() and
// __syncwarp() before the rows are read.
__device__ __forceinline__ void stage(const float* __restrict__ w, int n, int base, int per,
                                      int c0, int cw, int stride, float* rows, int lane) {
  const int dr = 32 / cw, dj = 32 - dr * cw;
  int r = lane / cw, j = lane - r * cw;
  int e = base + r * per + c0 + j;
  for (int q = 0; q < cw; ++q) {
    if (e < n) copy_async(rows + r * stride + j, w + e);
    r += dr;
    j += dj;
    e += dr * per + dj;
    if (j >= cw) {
      j -= cw;
      ++r;
      e += per - cw;
    }
  }
}

// A: 16-bit slots in shared memory, padded (resident layout), or anc
template <bool kResident>
struct Rank {
  using Slot = std::conditional_t<kResident, unsigned short, int>;
  Slot* a;
  __device__ __forceinline__ static int at(int v) { return kResident ? padded(v) : v; }
  __device__ __forceinline__ int get(int v) const { return a[at(v)]; }
  __device__ __forceinline__ void set(int v, int x) const { a[at(v)] = (Slot)x; }
};

// Phase 3 for one lane: cc_i of its segment's elements, and the run ends
// written to A. `prev` is cc of the element before the segment (-1 for
// the first segment). The first c columns are in the rows already (staged
// in phase 1, or during the offset chain); later ones are staged here.
template <bool kMass, bool kResident>
__device__ __forceinline__ void mark_runs(const float* __restrict__ w, int n, const Plan& p,
                                          int base, int lo, int hi, float off, float total,
                                          float nf, float u, int prev, float* rows, int lane,
                                          Rank<kResident> A) {
  const int n_top = (int)nf;
  const float* row = rows + lane * p.s;
  float local = 0.f;
  for (int c0 = 0; c0 < p.per; c0 += p.c) {
    const int cw = imin(p.c, p.per - c0);
    if (c0 > 0) {
      __syncwarp();
      stage(w, n, base, p.per, c0, cw, p.s, rows, lane);
      copy_wait();
      __syncwarp();
    }
    const int end = imin(cw, hi - lo - c0);
    for (int j = 0; j < end; ++j) {
      const int i = lo + c0 + j;
      local += clip0(row[j]);
      const float cdf = kMass ? __fdiv_rn(__fadd_rn(off, local), total)
                              : __fdiv_rn((float)(i + 1), nf);
      const int c = grid_count(cdf, nf, u, n_top);
      // the run of cc_{i-1} = prev ends at i - 1 (i - 1 < n - 1 always)
      if (prev >= 0 && prev < n && (c != prev || i == n - 1)) A.set(prev, i);
      prev = c;
    }
  }
}

// Phase 2: off[k] = the serial sum of seg[0 .. k), in place, for the
// nseg sums; returns the total. Batches of 8 as float4s, the next batch
// loaded before this one's adds, so that only the adds are serial.
__device__ __forceinline__ float offset_chain(float* seg, int nseg) {
  constexpr int kBatch = 8;
  float4* s4 = reinterpret_cast<float4*>(seg);
  const int full = nseg & ~(kBatch - 1);
  float acc = 0.f;
  float4 cur[kBatch / 4];
#pragma unroll
  for (int q = 0; q < kBatch / 4; ++q) cur[q] = s4[q];  // seg holds kThreads floats
  for (int k = 0; k < full; k += kBatch) {
    float4 nxt[kBatch / 4];
    const int kn = imin(k + kBatch, kThreads - kBatch) / 4;
#pragma unroll
    for (int q = 0; q < kBatch / 4; ++q) nxt[q] = s4[kn + q];
#pragma unroll
    for (int q = 0; q < kBatch / 4; ++q) {
      float4 o;
      o.x = acc;
      acc += cur[q].x;
      o.y = acc;
      acc += cur[q].y;
      o.z = acc;
      acc += cur[q].z;
      o.w = acc;
      acc += cur[q].w;
      s4[k / 4 + q] = o;
      cur[q] = nxt[q];
    }
  }
  for (int k = full; k < nseg; ++k) {
    const float x = seg[k];
    seg[k] = acc;
    acc += x;
  }
  return acc;
}

// Phase 4: anc = inclusive max-scan of A. Thread t owns slots [lo, hi).
template <bool kResident>
__device__ __forceinline__ void max_scan(Rank<kResident> A, int n, int lo, int hi,
                                         int* warp_agg, int* __restrict__ anc) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int agg = 0;
  for (int v = lo; v < hi; ++v) agg = max(agg, A.get(v));
  int incl = agg;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl = max(incl, y);
  }
  if (lane == 31) warp_agg[warp] = incl;
  __syncthreads();
  int before = lane < warp ? warp_agg[lane] : 0;  // the warps before this one
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) before = max(before, __shfl_xor_sync(0xffffffffu, before, d));
  const int up = __shfl_up_sync(0xffffffffu, incl, 1);
  int run = max(before, lane > 0 ? up : 0);
  for (int v = lo; v < hi; ++v) {
    run = max(run, A.get(v));
    A.set(v, run);
  }
  if (kResident) {  // A to anc, four slots a thread, coalesced
    __syncthreads();
    const bool aligned = (reinterpret_cast<uintptr_t>(anc) & 15) == 0;
    for (int k = 4 * t; k < n; k += 4 * kThreads) {
      if (aligned && k + 4 <= n) {
        *reinterpret_cast<int4*>(anc + k) =
            make_int4(A.get(k), A.get(k + 1), A.get(k + 2), A.get(k + 3));
      } else {
        for (int j = k; j < imin(k + 4, n); ++j) anc[j] = A.get(j);
      }
    }
  }
}

// kResident: the resident layout (A in shared memory), or the streamed one
// (A is anc)
template <bool kResident>
__global__ void __launch_bounds__(kThreads)
systematic_scan_kernel(const float* __restrict__ w, const float* __restrict__ u_ptr, int n,
                       int* __restrict__ anc, const Plan p) {
  extern __shared__ float smem[];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  float* seg = smem;  // sums, then offsets
  int* warp_agg = reinterpret_cast<int*>(seg + kThreads);
  float* total_s = seg + kThreads + kWarps;
  float* rows = smem + kFixedWords + warp * 32 * p.s;
  Rank<kResident> A;
  if constexpr (kResident) {
    A.a = reinterpret_cast<unsigned short*>(smem + kFixedWords + kThreads * p.s);
  } else {
    A.a = anc;
  }

  const int per = p.per;
  const int nseg = (n + per - 1) / per;  // segments holding weights
  const int base = warp * 32 * per;      // the warp's first weight
  const int lo = t * per, hi = imin(lo + per, n);
  const bool warp_has = warp * 32 < nseg;

  // 1. segment sums
  float s = 0.f;
  if (warp_has) {
    const float* row = rows + lane * p.s;
    for (int c0 = 0; c0 < per; c0 += p.c) {
      const int cw = imin(p.c, per - c0);
      if (c0 > 0) __syncwarp();
      stage(w, n, base, per, c0, cw, p.s, rows, lane);
      copy_wait();
      __syncwarp();
      const int end = imin(cw, hi - lo - c0);
      for (int j = 0; j < end; ++j) s += clip0(row[j]);
    }
  }
  seg[t] = s;
  __syncthreads();

  // 2. the offset chain (thread 0) while the other threads zero A and,
  // where the rows are not resident, copy phase 3's first columns
  if (!kResident && warp_has) stage(w, n, base, per, 0, p.c, p.s, rows, lane);
  if (t == 0) *total_s = offset_chain(seg, nseg);
  if constexpr (kResident) {
    int4* A4 = reinterpret_cast<int4*>(A.a);
    for (int k = t; k < rank_words(n) / 4; k += kThreads) A4[k] = make_int4(0, 0, 0, 0);
  } else {
    for (int k = t; k < n; k += kThreads) anc[k] = 0;
  }
  copy_wait();
  __syncthreads();

  // 3. cumulative counts and run ends
  const float total = *total_s;
  const float u = *u_ptr;
  const float nf = (float)n;
  const bool mass = total > 0.f;
  if (lo < n) {
    const float off = seg[t];
    const int prev = t == 0 ? -1
                            : grid_count(mass ? __fdiv_rn(off, total) : __fdiv_rn((float)lo, nf),
                                         nf, u, (int)nf);
    if (mass) {
      mark_runs<true, kResident>(w, n, p, base, lo, hi, off, total, nf, u, prev, rows, lane, A);
    } else {
      mark_runs<false, kResident>(w, n, p, base, lo, hi, off, total, nf, u, prev, rows, lane, A);
    }
  } else if (warp_has) {
    // a lane past the last weight still joins its warp's later copies
    for (int c0 = p.c; c0 < per; c0 += p.c) {
      __syncwarp();
      stage(w, n, base, per, c0, imin(p.c, per - c0), p.s, rows, lane);
      copy_wait();
      __syncwarp();
    }
  }
  __syncthreads();

  // 4. the rank
  max_scan<kResident>(A, n, lo, hi, warp_agg, anc);
}

// ---------------------------------------------------------------------------
// The comparator
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
systematic_kernel_per_thread(const float* __restrict__ w, const float* __restrict__ u_ptr,
                             int n, int* __restrict__ cc, int* __restrict__ anc) {
  __shared__ float seg_sum[kThreads];
  __shared__ float seg_off[kThreads];
  __shared__ float total_s;
  const int t = threadIdx.x;
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = t * per;
  const int hi = min(lo + per, n);

  float s = 0.f;
  for (int i = lo; i < hi; ++i) s += clip0(w[i]);
  seg_sum[t] = s;
  __syncthreads();
  if (t == 0) {
    float acc = 0.f;
    for (int k = 0; k < kThreads; ++k) {
      seg_off[k] = acc;
      acc += seg_sum[k];
    }
    total_s = acc;
  }
  __syncthreads();

  const float total = total_s;
  const float u = *u_ptr;
  const float nf = (float)n;
  float local = 0.f;
  for (int i = lo; i < hi; ++i) {
    local += clip0(w[i]);
    const float cdf = total > 0.f ? (seg_off[t] + local) / total
                                  : (float)(i + 1) / nf;
    const float c = fminf(fmaxf(ceilf(nf * cdf - u), 0.f), nf);
    cc[i] = (int)c;
  }
  __syncthreads();  // cc (global) is now visible to the whole block

  for (int k = t; k < n; k += kThreads) {
    int a = 0, b = n - 1;  // first index in [0, n-1) with cc > k
    while (a < b) {
      const int mid = (a + b) >> 1;
      if (cc[mid] <= k) a = mid + 1; else b = mid;
    }
    anc[k] = a;
  }
}

// The cards a process may use, for the launch state kept per card.
constexpr int kMaxDevices = 64;

}  // namespace

// The scan kernel: the wrapper's. `layout` -1: resident where it fits,
// else streamed; 0: streamed; 1: resident (cudaErrorInvalidValue where it
// does not fit). Its dynamic shared-memory limit is raised once per card
// (cudaFuncSetAttribute acts on the current card only), kept as an atomic
// flag per card; a failed call is tried again at the next launch.
extern "C" int bipk_systematic_ancestors(const float* w, const float* u, int n, int layout,
                                         int* anc, void* stream) {
  static std::atomic<bool> raised[kMaxDevices];
  if (n < 1 || layout < -1 || layout > 1) return (int)cudaErrorInvalidValue;
  const bool resident = layout == -1 ? resident_fits(n) : layout == 1;
  if (resident && !resident_fits(n)) return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (const cudaError_t err = cudaGetDevice(&dev); err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!raised[dev].load(std::memory_order_acquire)) {
    for (const void* kernel : {(const void*)systematic_scan_kernel<false>,
                               (const void*)systematic_scan_kernel<true>}) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemWords * 4);
      if (err != cudaSuccess) return (int)err;
    }
    raised[dev].store(true, std::memory_order_release);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Plan p = make_plan(n, resident);
  const size_t bytes = (size_t)p.words * 4;
  if (resident)
    systematic_scan_kernel<true><<<1, kThreads, bytes, s>>>(w, u, n, anc, p);
  else
    systematic_scan_kernel<false><<<1, kThreads, bytes, s>>>(w, u, n, anc, p);
  return (int)cudaGetLastError();
}

// The per-thread comparator: the same ancestors, bit for bit, through an
// n-int scratch for cc.
extern "C" int bipk_systematic_ancestors_per_thread(const float* w, const float* u, int n,
                                                    int* cc_scratch, int* anc, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  systematic_kernel_per_thread<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, u, n, cc_scratch, anc);
  return (int)cudaGetLastError();
}
