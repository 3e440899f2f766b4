// Warp-per-particle MNIW look-ahead and gather/draw for 24 < m <= 48, for
// NVIDIA Hopper (sm_90a).
//
// Replaces, for the cs-layout widths (the toy, m = 40; the single-mass
// oscillator, m = 41), the TPU kernels of bipk_tpu/ops/pallas_kernels.py:
//   - _cs_fp_kernel (:2322) behind _cs_call (:2454), reached from
//     factorize_project_packed (:1740, cs branch :1762-1770): the
//     auxiliary look-ahead, mean / col / row / (logdet_T1, logdet_Psi) of
//     prior + lam * S at phi;
//   - _cs_du_gather_kernel (:2418) behind _cs_du_gather_call (:2482),
//     reached from draw_update_gather_packed_blocks (:1041, cs branch
//     :1067): the matrix-t draw and rank-1 update on S[:, anc], and
//     _cs_du_kernel (:2353), the same without ancestors.
// packed_mniw.cu launches these for m > 24; m <= 24 keeps the per-thread
// packed_mniw_kernel<24, MODE>, and the log-determinant mode keeps
// packed_mniw_kernel<48, kLogdets>.
//
// Design. One warp per particle, its factor in shared memory. A block of
// W warps takes W consecutive output particles and first stages their
// columns of S (rows [T0 | tril(T1) | tril(T2) | T3]) and of phi as one
// (rows + m, W) tile, W neighbouring floats per row (one 32-byte sector at
// W = 8), kLoads loads in flight per thread, the gather done there: column
// w of the tile is S[:, anc[j0 + w]]. Each warp then builds the augmented
// lower triangle
//     rows 0..m-1      A = P1 + lam*T1 (+ jitter * tr/m on the diagonal)
//     rows m..m+n-1    (P0 + lam*T0)^T, the right-hand sides of white
//     row  m+n         phi^T, the right-hand side of v
// (row stride m | 1, odd, so 32 lanes on 32 rows hit 32 banks; lane l
// walks down columns l and l + 32 of A, the prior read through the
// read-only cache) and runs the left-looking Cholesky over it, column by
// column: lane l takes row c + l (and c + l + 32 while there are more than
// 32 rows). A matrix row is scaled by rsqrtf(s_cc); a right-hand-side row
// is divided by the new diagonal: its entry c is then white[c] (or v[c])
// of the forward substitution, so the substitutions ride along with the
// factorization. Psi, mean and col are dot products over the finished
// rows, one lane each, and lane 0 draws. The draw writes S_new into the
// tile in place (the T1 rows as it reads them), and the block writes the
// tile out by rows of W particles. W is the largest of 8, 4, 2, 1 that
// still gives every SM a block, so N = 200 runs 200 one-warp blocks.
//
// Bit for bit equal to the per-thread core (mniw_core<48, MODE>,
// packed_mniw.cuh) by construction: every output entry is the same
// sequence of f32 operations in the same order. Entry (r, c) of the factor
// is s = A[r][c] - sum_{k < c} L[r][k] L[c][k] over k in increasing order,
// one fused multiply-add per term, as the core's Cholesky and forward
// substitutions compute it; white[c] = s / L[c][c] and v[c] likewise, with
// the same IEEE division; the trace, the jitter, logf, the log-determinant
// sum and the Schur complement keep the core's order; the draw and the
// log-determinant of Psi are the core's own helpers (matrix_t_draw,
// logdet_psi_of), and every update is forget_add. Where nvcc contracts the
// core's other multiply-adds was read off its SASS (sm_90a) and is written
// out here with explicit roundings: "lam * raw + prior" is a rounded
// product and a rounded sum (FMUL, then a predicated FADD), the jitter's
// bump likewise, T3's "lam * T3 + p3" one fused multiply-add; only the
// arrays' places differ. chip_smoke.py phase 8 holds these kernels against
// the per-thread ones bit for bit (the comparator is packed_mniw_kernel<48,
// kProject / kDraw> behind bipk_*_per_thread in packed_mniw.cu, which no
// wrapper reaches), and phase 18 against the unpacked kernels.
//
// What bounds it on the H100 at m = 41, n = 1: the bytes are those of the
// per-thread kernels (S read once, 118 MB at N = 32768: 0.037 ms for the
// look-ahead, 0.073 ms for the gathered draw with S_new written), against
// ~26 kflop per particle (0.013 ms at 67 TFLOP/s). In practice one warp's
// chain of dependent shared-memory work: most of a particle's time is the
// Cholesky's columns, each a dot product whose terms wait on their
// shared-memory loads (the compiler's unrolled loop does not overlap one
// group's loads with the previous group's chain) followed by a serial
// shuffle, rsqrtf, division and stores; against the per-thread core's
// m^3/6 dependent local-memory loads. At N = 200 that chain is the whole
// kernel; at N = 32768 two blocks of 8 warps share an SM (~92 KB of shared
// memory each) and the waves of such chains set the time. Tensor cores and
// TMA are not used: a 41 x 41 factorization per particle is a chain of
// dependent columns with ~26 kflop in all, too small and too sequential
// for a 64-row wgmma tile, and the tile of S is a few KB that plain
// coalesced loads bring in. A right-looking update, float4 loads and loads
// started a group ahead of their chain were each slower on the card
// (PERF.md).
//
// The warps of a block are independent between the block barriers; a warp
// whose particle lies past n_out skips the core and only takes part in the
// staging. The kernels use __syncwarp and shuffles, so a serial CPU
// rehearsal (one thread after another) cannot run them; one that runs every
// CUDA thread as a host thread, with barriers for __syncthreads, __syncwarp
// and the shuffles, can.

#include "packed_mniw.cuh"

namespace bipk_mniw {
namespace {

constexpr int kMaxWarps = 8;  // particles per block at large N
constexpr int kLoads = 8;     // global loads in flight per thread while staging
constexpr unsigned kFull = 0xffffffffu;

// The shared-memory plan of a block of W warps at (m, n): the tile of the
// W particles' statistics and phi, then per warp its augmented triangle
// (R = m + n + 1 rows of stride ld) and m log-diagonal slots, then W
// source columns.
struct WarpPlan {
  int rows, tile_rows, ts, ld, R, per_warp, tile_floats;
  __host__ __device__ WarpPlan(int m, int n, int W)
      : rows(m * n + m * (m + 1) / 2 + n * (n + 1) / 2 + 1),
        tile_rows(rows + m),
        ts(W | 1),  // odd row stride: a warp's 32 rows of one column hit 32 banks
        ld(m | 1),  // odd: 32 lanes on 32 rows of one column hit 32 banks
        R(m + n + 1),
        per_warp((m + n + 1) * (m | 1) + m),
        tile_floats((rows + m) * (W | 1)) {}
  __host__ __device__ size_t bytes(int W) const {
    return sizeof(float) * ((size_t)tile_floats + (size_t)W * per_warp) + sizeof(int) * W;
  }
};

// lam * raw + prior as the per-thread core's compiled code rounds
// `x = raw * lam; if (P) x += P[..]`: a rounded product, then a rounded sum
__device__ __forceinline__ float scaled_prior(float raw, float lam, const float* p) {
  const float x = __fmul_rn(raw, lam);
  return p ? __fadd_rn(x, __ldg(p)) : x;
}

// One particle on one warp. x: its column of the block's tile, element r
// at x[r * ts] (rows [0, rows) its statistics, [rows, rows + m) its phi);
// L: its augmented triangle; logs: m floats.
template <int MODE>
__device__ __forceinline__ void warp_particle(const Args& a, int j, float* x, int ts,
                                              float* L, float* logs, int lane) {
  constexpr bool DRAW = MODE == kDraw;
  const int m = a.m, n = a.n;
  const int64_t n_out = a.n_out;
  const int o1 = m * n, o2 = o1 + m * (m + 1) / 2, o3 = o2 + n * (n + 1) / 2;
  const float* phi = x + (o3 + 1) * ts;
  const float lam = a.lam;
  const float* P0 = a.prior;
  const float* P1 = a.prior ? a.prior + m * n : nullptr;
  const float* P2 = a.prior ? a.prior + m * n + m * m : nullptr;
  const int ld = m | 1, R = m + n + 1;

  // A = P1 + lam*T1: lane l walks down columns c = l and l + 32, T1[i][c]
  // (i >= c) at packed rows o1 + tri_off(c, m) + i - c; the draw writes
  // that row of S_new (lam*T1 + phi phi^T) in place as it reads it
  for (int c = lane; c < m; c += 32) {
    const float phi_c = phi[c * ts];
    float* t = x + (o1 + tri_off(c, m) - c) * ts;
#pragma unroll 4
    for (int i = c; i < m; ++i) {
      const float raw = t[i * ts];
      if constexpr (DRAW) t[i * ts] = forget_add(raw, lam, phi[i * ts], phi_c);
      L[i * ld + c] = scaled_prior(raw, lam, P1 ? P1 + i * m + c : nullptr);
    }
  }
  // the right-hand sides: rows m + c = (P0 + lam*T0)[:, c]^T, row m + n = phi^T
  for (int i = lane; i < m; i += 32) {
    for (int c = 0; c < n; ++c)
      L[(m + c) * ld + i] =
          scaled_prior(x[(i * n + c) * ts], lam, P0 ? P0 + i * n + c : nullptr);
    L[(m + n) * ld + i] = phi[i * ts];
  }
  __syncwarp();

  // the relative jitter: the trace summed in the core's order, on lane 0
  if (a.jitter != 0.f) {
    float bump = 0.f;
    if (lane == 0) {
      float trace = 0.f;
      for (int c = 0; c < m; ++c) trace = __fadd_rn(trace, L[c * ld + c]);
      bump = __fmul_rn(__fdiv_rn(a.jitter, (float)m), trace);
    }
    bump = __shfl_sync(kFull, bump, 0);
    for (int c = lane; c < m; c += 32) L[c * ld + c] = __fadd_rn(L[c * ld + c], bump);
    __syncwarp();
  }

  // left-looking Cholesky of the augmented triangle, column by column:
  // lane l on row c + l (and c + l + 32), s = A[r][c] - sum_{k < c} L[r][k]
  // L[c][k] in increasing k; L[c][c] itself goes to logs[c]
  for (int c = 0; c < m; ++c) {
    const float* Lc = L + c * ld;
    const int r0 = c + lane, r1 = r0 + 32;
    const float* L0 = L + (r0 < R ? r0 : R - 1) * ld;
    float s0 = L0[c], s1 = 0.f;
    const bool two = c + 32 < R;  // warp-uniform
    if (two) {
      const float* L1 = L + (r1 < R ? r1 : R - 1) * ld;
      s1 = L1[c];
      for (int k = 0; k < c; ++k) {
        const float lck = Lc[k];
        s0 = __fmaf_rn(-L0[k], lck, s0);
        s1 = __fmaf_rn(-L1[k], lck, s1);
      }
    } else {
      for (int k = 0; k < c; ++k) s0 = __fmaf_rn(-L0[k], Lc[k], s0);
    }
    const float scc = __shfl_sync(kFull, s0, 0);  // lane 0 holds row c
    const float inv = rsqrtf(scc);
    const float d = __fmul_rn(scc, inv);
    if (lane == 0) logs[c] = d;
    else if (r0 < R) L[r0 * ld + c] = r0 < m ? __fmul_rn(s0, inv) : __fdiv_rn(s0, d);
    if (two && r1 < R) L[r1 * ld + c] = r1 < m ? __fmul_rn(s1, inv) : __fdiv_rn(s1, d);
    __syncwarp();
  }
  for (int c = lane; c < m; c += 32) logs[c] = logf(logs[c]);

  // Psi = P2 + lam*T2 - white^T white, mean = white^T v, col = v.v + 1:
  // one lane per entry, each summed over k in the core's order
  const int nn = n * n;
  const float* V = L + (m + n) * ld;
  float val = 0.f;
  if (lane < nn) {
    const int a_ = lane / n, b = lane - (lane / n) * n;
    const int lo = a_ < b ? a_ : b, hi = a_ < b ? b : a_;
    float acc = scaled_prior(x[(o2 + tri_off(lo, n) + hi - lo) * ts], lam,
                             P2 ? P2 + a_ * n + b : nullptr);
    const float* Wa = L + (m + a_) * ld;
    const float* Wb = L + (m + b) * ld;
    for (int k = 0; k < m; ++k) acc = __fmaf_rn(-Wa[k], Wb[k], acc);
    val = acc;
  } else if (lane < nn + n) {
    const float* Wc = L + (m + lane - nn) * ld;
    float acc = 0.f;
    for (int k = 0; k < m; ++k) acc = __fmaf_rn(Wc[k], V[k], acc);
    val = acc;
  } else if (lane == nn + n) {
    float acc = 0.f;
    for (int k = 0; k < m; ++k) acc = __fmaf_rn(V[k], V[k], acc);
    val = __fadd_rn(acc, 1.f);
  }
  __syncwarp();
  float psi[2][2], mean[2];
  for (int a_ = 0; a_ < 2; ++a_)
    for (int b = 0; b < 2; ++b) psi[a_][b] = __shfl_sync(kFull, val, (a_ * n + b) & 31);
  for (int c = 0; c < 2; ++c) mean[c] = __shfl_sync(kFull, val, nn + c);
  const float colv = __shfl_sync(kFull, val, nn + n);

  float yv[2] = {0.f, 0.f};
  if (lane == 0) {
    float half_ld = 0.f;
    for (int c = 0; c < m; ++c) half_ld = __fadd_rn(half_ld, logs[c]);
    a.ld[j] = 2.f * half_ld;
    a.ld[n_out + j] = logdet_psi_of(psi, n);
    if constexpr (MODE == kProject) {
      for (int c = 0; c < n; ++c) a.mean[c * n_out + j] = mean[c];
      a.col[j] = colv;
      for (int a_ = 0; a_ < n; ++a_)
        for (int b = 0; b < n; ++b) a.row[(a_ * n + b) * n_out + j] = psi[a_][b];
    } else {
      const float t3raw = x[o3 * ts];
      const float df_pred = __fadd_rn(__fmaf_rn(t3raw, lam, a.p3), 1.f - n);
      matrix_t_draw(a, j, df_pred, psi, mean, colv, yv);
      // T2 and T3 rows of S_new (the prior never enters the carry)
      for (int b = 0; b < n; ++b)
        for (int a_ = b; a_ < n; ++a_) {
          float* t = x + (o2 + tri_off(b, n) + a_ - b) * ts;
          *t = forget_add(*t, lam, yv[a_], yv[b]);
        }
      x[o3 * ts] = forget_add(t3raw, lam, 1.f, 1.f);
    }
  }
  if constexpr (DRAW) {  // the T0 rows of S_new: lam*T0 + phi y^T
    for (int c = 0; c < 2; ++c) yv[c] = __shfl_sync(kFull, yv[c], 0);
    for (int i = lane; i < m; i += 32)
      for (int c = 0; c < n; ++c) {
        float* t = x + (i * n + c) * ts;
        *t = forget_add(*t, lam, phi[i * ts], yv[c]);
      }
  }
}

template <int MODE>
__global__ void __launch_bounds__(32 * kMaxWarps)
warp_mniw_kernel(const Args a, int log_w) {
  extern __shared__ float smem[];
  const int W = 1 << log_w;
  const WarpPlan p(a.m, a.n, W);
  float* tile = smem;
  int* src = reinterpret_cast<int*>(smem + p.tile_floats + W * p.per_warp);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t j0 = (int64_t)blockIdx.x * W;
  const int64_t n_in = a.n_in, n_out = a.n_out;

  // the block's W source columns; only the draw gathers. A column past
  // n_out reads column 0 (read, never used)
  if (threadIdx.x < W) {
    const int64_t j = j0 + threadIdx.x;
    src[threadIdx.x] = j < n_out ? (MODE == kDraw ? source_column(a, (int)j) : (int)j) : 0;
  }
  __syncthreads();
  // stage S[:, src] and phi[:, j0 .. j0 + W) as the tile, kLoads loads in
  // flight per thread
  const int total = p.tile_rows << log_w;
  for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * blockDim.x) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = min(e0 + u * (int)blockDim.x, total - 1);
      const int r = e >> log_w, w = e & (W - 1);
      v[u] = __ldg(r < p.rows ? a.S + r * n_in + src[w]
                              : a.phi + (r - p.rows) * n_out + min(j0 + w, n_out - 1));
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * (int)blockDim.x;
      if (e < total) tile[(e >> log_w) * p.ts + (e & (W - 1))] = v[u];
    }
  }
  __syncthreads();
  if (j0 + warp < n_out) {
    float* L = smem + p.tile_floats + warp * p.per_warp;
    warp_particle<MODE>(a, (int)(j0 + warp), tile + warp, p.ts, L, L + p.R * p.ld, lane);
  }
  if constexpr (MODE == kDraw) {  // S_new by rows of W particles
    __syncthreads();
    for (int e = threadIdx.x; e < p.rows << log_w; e += blockDim.x) {
      const int r = e >> log_w, w = e & (W - 1);
      if (j0 + w < n_out) a.S_new[r * n_out + j0 + w] = tile[r * p.ts + w];
    }
  }
}

// log2 of W, the most warps per block (8, 4, 2, 1) that still gives every
// SM a block: N = 200 runs 200 blocks of one warp
int warps_per_block(int n_out, int& log_w) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  log_w = 3;  // kMaxWarps
  while (log_w > 0 && (n_out + (1 << log_w) - 1) >> log_w < sms) --log_w;
  return 0;
}

template <int MODE>
int launch_mode(const Args& a, cudaStream_t stream) {
  static bool raised = false;  // the dynamic shared-memory limit, once
  if (!raised) {
    const int most = (int)WarpPlan(48, 2, kMaxWarps).bytes(kMaxWarps);
    const cudaError_t err = cudaFuncSetAttribute(
        warp_mniw_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  int log_w = 0;
  if (const int rc = warps_per_block(a.n_out, log_w)) return rc;
  const int W = 1 << log_w;
  const size_t bytes = WarpPlan(a.m, a.n, W).bytes(W);
  const dim3 grid((a.n_out + W - 1) / W);
  warp_mniw_kernel<MODE><<<grid, 32 * W, bytes, stream>>>(a, log_w);
  return (int)cudaGetLastError();
}

}  // namespace

int launch_warp_mniw(const Args& a, int mode, cudaStream_t stream) {
  if (a.m < 1 || a.m > 48 || a.n < 1 || a.n > 2) return (int)cudaErrorInvalidValue;
  if (a.n_out == 0) return (int)cudaGetLastError();
  if (mode == kProject) return launch_mode<kProject>(a, stream);
  if (mode == kDraw) return launch_mode<kDraw>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace bipk_mniw

// The warp kernels' launch at (m, n) and n_out particles on the current
// card: warps per block and dynamic shared memory in bytes, for reports.
extern "C" int bipk_warp_mniw_plan(int m, int n, int n_out, int* warps, int* smem_bytes) {
  int log_w = 0;
  if (const int rc = bipk_mniw::warps_per_block(n_out, log_w)) return rc;
  *warps = 1 << log_w;
  *smem_bytes = (int)bipk_mniw::WarpPlan(m, n, 1 << log_w).bytes(1 << log_w);
  return 0;
}
