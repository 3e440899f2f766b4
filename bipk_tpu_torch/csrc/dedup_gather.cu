// Gathered draw/update for degenerate weights, with each block's distinct
// ancestor columns read once, for NVIDIA Hopper (sm_90a), m <= 24.
//
// Replaces the TPU kernel of bipk_tpu/ops/pallas_kernels.py:
//   - draw_update_dedup_gather_packed_blocks (:1312) ->
//     _draw_update_dedup_gather_kernel (:903), with the plan of
//     dedup_fits / dedup_plan (:1201-1310).
// It computes what #4 (draw_update_gather_packed_blocks) computes on
// S[:, anc]: the same draw and rank-1 update.
//
// The TPU kernel stages a block's distinct 128-lane source TILES through
// VMEM by a prefetched DMA schedule, because its contiguous-window gather
// cannot reach ancestors that span the source. None of that carries over:
// a thread on the card reads column anc[j] from anywhere. What may carry
// over is the dedup itself: under degenerate weights (the vehicle APF's
// median ESS is ~12 of 32768) the outputs of a block have a handful of
// distinct ancestors.
//
// The wrapper's entry (bipk_draw_update_dedup_gather_packed) launches the
// warp kernel's kDedup mode (warp_mniw.cu): #4's warp kernel (two particles
// per warp, blocks of P <= 16 particles) with its tile filled another way.
// The block finds its D distinct ancestors among its P sorted ones (a
// ballot of the run starts and a prefix count), reads each distinct column
// of S once into the particles' triangles (idle until the core starts:
// no extra shared memory, no fallback to global reads), fills every
// particle's tile column from that copy, and then draws exactly as #4
// does, so the two agree bit for bit.
//
// The per-thread kernel below (dedup_gather_kernel: one thread per output,
// 128 per block, the column core of packed_mniw.cuh in mode kDraw) is what
// the wrapper launched before; it stays compiled as the warp mode's
// comparator behind bipk_draw_update_dedup_gather_packed_per_thread, which
// no wrapper reaches (chip_smoke.py phase 14 holds the two bit for bit).
// A block of 128 outputs
//   1. finds its D distinct ancestors from the sorted ancestors: a thread
//      whose ancestor differs from its left neighbour's starts a run, and
//      a ballot and a prefix count give each thread its run's slot;
//   2. if D * rows floats fit the stage (kStageFloats, 24 KB: D <= 26 at
//      m = 20, n = 1, rows = 232; D <= 17 at m = 24, n = 2, rows = 352),
//      copies the D columns into shared memory, coalesced across the
//      block, element r of slot d at stage[r * D + d];
//   3. runs the column core of each thread on its slot in shared memory
//      (threads of a run read one address: a broadcast), or, when D is
//      over the budget, on its column in global memory as #4 does. The
//      choice is per block and on the device: no plan, no host sync.
// Ancestors out of order stay correct in both (a repeated value starts a
// new run and is staged twice); only the saving needs them sorted.
//
// What bounds it: bytes in principle (~64 MB at m = 20, N = 32768 with
// every column distinct, fewer under degenerate weights); in practice the
// per-thread kernel's Cholesky of dependent local loads, and the warp
// mode's instructions, as #4's (warp_mniw.cu). The warp kernel's staging
// already reads a degenerate block's repeated columns as a few broadcast
// loads per warp, which L1/L2 merge; the dedup cuts the global loads per
// block from P * rows to D * rows. Times: PERF.md.
//
// C interface as packed_mniw.cu: launches on the given stream, never
// synchronises, allocates nothing, returns cudaGetLastError().

#include "packed_mniw.cuh"

using namespace bipk_mniw;

namespace {

// shared-memory stage of one block of the per-thread kernel, in floats
// (24 KB)
constexpr int kStageFloats = 6144;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
dedup_gather_kernel(const Args a) {
  __shared__ float stage[kStageFloats];
  __shared__ int slot_src[kThreads];
  __shared__ int warp_runs[kWarps];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int j = blockIdx.x * kThreads + t;
  const bool live = j < a.n_out;
  const int src = live ? source_column(a, j) : -1;
  const bool starts = live && (t == 0 || a.anc[j - 1] != src);

  // slot = number of run starts at positions <= t, minus one
  const unsigned ballot = __ballot_sync(0xffffffffu, starts);
  if (lane == 0) warp_runs[warp] = __popc(ballot);
  __syncthreads();
  int before = 0, distinct = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_runs[w];
    distinct += warp_runs[w];
  }
  const int slot = before + __popc(ballot & ((2u << lane) - 1u)) - 1;
  if (starts) slot_src[slot] = src;

  const int m = a.m, n = a.n;
  const int rows = m * n + m * (m + 1) / 2 + n * (n + 1) / 2 + 1;
  const bool staged = distinct * rows <= kStageFloats;  // block-uniform
  __syncthreads();
  if (staged) {
    for (int e = t; e < distinct * rows; e += kThreads) {
      const int r = e / distinct, d = e - r * distinct;
      stage[e] = a.S[(int64_t)r * a.n_in + slot_src[d]];
    }
    __syncthreads();
  }
  if (!live) return;
  // one call on a generic pointer: the core is inlined once
  mniw_column<24, kDraw>(a, j, staged ? stage + slot : a.S + src,
                         staged ? (int64_t)distinct : (int64_t)a.n_in);
}

}  // namespace

extern "C" int bipk_draw_update_dedup_gather_packed(
    const float* S, int n_in, const int* anc, int n_out, const float* phi,
    const float* u, const float* v, const float* prior, float p3, int m,
    int n, float jitter, float lam, float* S_new, float* y, float* ld,
    void* stream) {
  if (!anc) return (int)cudaErrorInvalidValue;
  return launch_warp_mniw(draw_args(S, n_in, anc, n_out, phi, u, v, prior, p3, m, n, jitter,
                                    lam, S_new, y, ld),
                          kDedup, static_cast<cudaStream_t>(stream));
}

// The comparator of the warp kernel's dedup mode: the per-thread
// dedup_gather_kernel, which chip_smoke.py calls and no wrapper does.
extern "C" int bipk_draw_update_dedup_gather_packed_per_thread(
    const float* S, int n_in, const int* anc, int n_out, const float* phi,
    const float* u, const float* v, const float* prior, float p3, int m,
    int n, float jitter, float lam, float* S_new, float* y, float* ld,
    void* stream) {
  if (m < 1 || m > 24 || n < 1 || n > 2 || !anc) return (int)cudaErrorInvalidValue;
  if (n_out == 0) return (int)cudaGetLastError();
  const Args a = draw_args(S, n_in, anc, n_out, phi, u, v, prior, p3, m, n, jitter, lam, S_new,
                           y, ld);
  const dim3 grid((n_out + kThreads - 1) / kThreads);
  dedup_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
