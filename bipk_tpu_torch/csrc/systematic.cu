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
// Design: ONE block of 1024 threads for any n, one launch. Thread t owns a
// contiguous segment of ceil(n/1024) weights.
//   1. each thread sums its segment serially;
//   2. thread 0 scans the 1024 segment sums serially, so the offset of
//      segment t+1 is exactly fl(offset_t + sum_t) -- the value thread t's
//      running sum reaches at its segment end -- and the cdf is monotone
//      across segment boundaries bit for bit;
//   3. each thread re-walks its segment and writes cc_i to a scratch vector;
//   4. the range fill anc[cc_{i-1} .. cc_i - 1] = i runs from the output
//      side: slot k binary-searches the sorted cc_0..cc_{n-2} for the number
//      of entries <= k. Slots past cc_{n-2} get n-1 even when f32 rounding
//      leaves cc_{n-1} short of n (the clip of the plain version), and a
//      particle that owns every slot costs no single thread n stores.
// The cdf differs from the plain torch.cumsum only in summation order, so
// the ancestors agree except where a grid point and a cdf value tie to
// within rounding (one output slot shifts).
//
// What bounds it on the H100: it moves 8n bytes (~0.26 MB at n = 32768,
// ~0.1 us at 3.35 TB/s) and does ~n log2 n compares, so a launch's fixed
// cost and the one block's serial phases bound it, not bytes.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;

// max(w, 0) that keeps NaN (fmaxf would return 0 for it): one NaN weight
// makes the total NaN, and the `total > 0` test below then gives the
// uniform fallback, as in the plain version.
__device__ __forceinline__ float clip0(float w) { return w < 0.f ? 0.f : w; }

__global__ void __launch_bounds__(kThreads)
systematic_kernel(const float* __restrict__ w, const float* __restrict__ u_ptr,
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

}  // namespace

extern "C" int bipk_systematic_ancestors(const float* w, const float* u,
                                         int n, int* cc_scratch, int* anc,
                                         void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  systematic_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      w, u, n, cc_scratch, anc);
  return (int)cudaGetLastError();
}
