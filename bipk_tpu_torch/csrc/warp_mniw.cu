// Warp-per-particle MNIW look-ahead and gather/draw for 1 <= m <= 48, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of bipk_tpu/ops/pallas_kernels.py that compute
// the auxiliary look-ahead (mean / col / row / (logdet_T1, logdet_Psi) of
// prior + lam * S at phi) and the matrix-t draw with its rank-1 update:
//   - for m <= 24, the tiled kernels: _packed_fp_kernel (:501, core :371)
//     behind factorize_project_packed (:1740); _draw_update_gather_kernel
//     (:878) behind draw_update_gather_packed_blocks (:1041), the draw on
//     S[:, anc]; _draw_update_packed_kernel (:768, tail :691) behind
//     draw_update_packed_blocks (:1848), the same without ancestors;
//   - for 24 < m <= 48, the cs-layout kernels (the toy, m = 40; the
//     single-mass oscillator, m = 41): _cs_fp_kernel (:2322) behind
//     _cs_call (:2454), reached from factorize_project_packed (cs branch
//     :1762-1770); _cs_du_gather_kernel (:2418) behind _cs_du_gather_call
//     (:2482), reached from draw_update_gather_packed_blocks (cs branch
//     :1067); _cs_du_kernel (:2353), the same without ancestors.
// packed_mniw.cu launches these for its look-ahead and draw at every m; the
// log-determinants and the factor-emitting look-ahead stay per-thread.
//
// Design. One particle on 32 / PW lanes of a warp, PW = 2 particles per
// warp for m <= 24 (a half warp each) and 1 above, the factor in shared
// memory. A block of W warps takes P = PW * W consecutive output particles
// and first stages their columns of S (rows [T0 | tril(T1) | tril(T2) |
// T3]) and of phi as one (rows + m, P) tile, P neighbouring floats per row,
// kLoads loads in flight per thread, the gather done there: column w of
// the tile is S[:, anc[j0 + w]]. Each particle's GW lanes then build its
// augmented lower triangle
//     rows 0..m-1      A = P1 + lam*T1 (+ jitter * tr/m on the diagonal)
//     rows m..m+n-1    (P0 + lam*T0)^T, the right-hand sides of white
//     row  m+n         phi^T, the right-hand side of v
// (row stride m | 1, odd, so 32 lanes on 32 rows hit 32 banks; lane l
// walks down columns l, l + GW, ... of A, the prior read through the
// read-only cache) and run the left-looking Cholesky over it, column by
// column: lane l takes row c + l (and c + l + GW while more rows remain;
// R = m + n + 1 <= 2 GW rows always). A matrix row is scaled by
// rsqrtf(s_cc); a right-hand-side row is divided by the new diagonal: its
// entry c is then white[c] (or v[c]) of the forward substitution, so the
// substitutions ride along with the factorization. Psi, mean and col are
// dot products over the finished rows, one lane each, and the particle's
// lane 0 draws. The draw writes S_new into the tile in place (the T1 rows
// as it reads them), and the block writes the tile out by rows of P
// particles. Both halves of a warp share m and n, so they take the same
// branches and loop counts in lockstep: the warp-wide __syncwarp serves
// both, and the shuffles run in segments of GW lanes. W is the largest of
// 8, 4, 2, 1 that still gives every SM a block, so N = 200 at m = 41 runs
// 200 one-warp blocks.
//
// Bit for bit equal to the per-thread core (mniw_core<24 | 48, MODE>,
// packed_mniw.cuh) by construction: every output entry is the same
// sequence of f32 operations in the same order. Entry (r, c) of the factor
// is s = A[r][c] - sum_{k < c} L[r][k] L[c][k] over k in increasing order,
// one fused multiply-add per term, as the core's Cholesky and forward
// substitutions compute it; white[c] = s / L[c][c] and v[c] likewise, with
// the same IEEE division; the trace, the jitter, logf, the log-determinant
// sum and the Schur complement keep the core's order; the draw and the
// log-determinant of Psi are the core's own helpers (matrix_t_draw,
// logdet_psi_of), and every update is forget_add. Where nvcc contracts the
// core's other multiply-adds was read off its SASS (sm_90a; the <24> and
// <48> instantiations issue the same sequence of floating-point
// operations) and is written out here with explicit roundings: "lam * raw
// + prior" is a rounded product and a rounded sum (FMUL, then a predicated
// FADD), the jitter's bump likewise, T3's "lam * T3 + p3" one fused
// multiply-add; only the arrays' places differ. chip_smoke.py holds these
// kernels against the per-thread ones bit for bit (phase 2 at m <= 24,
// phase 8 above; the comparator is packed_mniw_kernel<24 | 48, kProject /
// kDraw> behind bipk_*_per_thread in packed_mniw.cu, which no wrapper
// reaches), and phase 18 against the unpacked kernels;
// tests/test_torch_warp_rehearsal.py runs both on the host (below).
//
// What bounds it on the H100. The bytes are those of the per-thread
// kernels: at m = 20, N = 32768, S is read once (30 MB: 0.010 ms for the
// look-ahead, 0.011 ms for the gathered draw with S_new written); at
// m = 41, 118 MB (0.037 and 0.073 ms); against ~4 and ~26 kflop per
// particle (0.002 and 0.013 ms at 67 TFLOP/s). In practice the instructions
// a particle's lanes issue: most of them are the Cholesky's columns, each
// a dot product whose terms wait on their shared-memory loads followed by
// a serial shuffle, rsqrtf, division and stores, with fewer and fewer of
// the lanes busy as the columns advance; against the per-thread core's
// m^3/6 dependent local-memory loads. At m = 20 a whole warp per particle
// left 10 of its 32 lanes idle from the start and took ~1.5x the time of
// two particles per warp (PERF.md); at N = 200 and m = 41 one particle's
// chain is the whole kernel. Tensor cores and TMA are not
// used: a 20 x 20 or 41 x 41 factorization per particle is a chain of
// dependent columns, too small and too sequential for a 64-row wgmma tile,
// and the tile of S is a few KB that plain coalesced loads bring in. A
// right-looking update, float4 loads, loads started a group ahead of their
// chain, a minimum-blocks launch bound, four warps per block at m <= 24,
// staging S and phi in two loops and spreading the A-build's entries
// evenly over the lanes were each slower or no faster on the card
// (PERF.md).
//
// The warps of a block are independent between the block barriers; a warp
// whose particles all lie past n_out skips the core and only takes part in
// the staging, and a half warp whose particle lies past n_out computes on
// a stand-in column and writes nothing. The kernels use __syncwarp and
// shuffles, so a serial CPU rehearsal (one thread after another) cannot run
// them; one that runs every CUDA thread as a host thread, with barriers for
// __syncthreads, __syncwarp and the shuffles, can
// (tests/test_torch_warp_rehearsal.py).

#include "packed_mniw.cuh"

namespace bipk_mniw {
namespace {

constexpr int kMaxWarps = 8;  // warps per block at large N
constexpr int kLoads = 8;     // global loads in flight per thread while staging
constexpr unsigned kFull = 0xffffffffu;

// The shared-memory plan of a block of P particles at (m, n), GW lanes per
// particle: the tile of the P particles' statistics and phi, then per
// particle its augmented triangle (R = m + n + 1 rows of stride ld) and m
// log-diagonal slots, then P source columns. With two particles on a warp
// (GW = 16) a particle's area is padded to 16 (mod 32) floats: lane l of
// the two halves then reads row c + l of its own triangle from banks that
// differ, as 16 rows of an odd stride cover 16 banks and the other 16 lie
// 16 further on.
struct WarpPlan {
  int rows, tile_rows, ts, ld, R, per_particle, tile_floats;
  __host__ __device__ WarpPlan(int m, int n, int P, int GW)
      : rows(m * n + m * (m + 1) / 2 + n * (n + 1) / 2 + 1),
        tile_rows(rows + m),
        ts(P | 1),  // odd row stride: 32 rows of one column hit 32 banks
        ld(m | 1),  // odd: 32 lanes on 32 rows of one column hit 32 banks
        R(m + n + 1),
        per_particle(padded((m + n + 1) * (m | 1) + m, GW)),
        tile_floats((rows + m) * (P | 1)) {}
  __host__ __device__ static int padded(int floats, int GW) {
    return GW == 32 ? floats : floats + (48 - floats % 32) % 32;
  }
  __host__ __device__ size_t bytes(int P) const {
    return sizeof(float) * ((size_t)tile_floats + (size_t)P * per_particle) +
           sizeof(int) * P;
  }
};

// lam * raw + prior as the per-thread core's compiled code rounds
// `x = raw * lam; if (P) x += P[..]`: a rounded product, then a rounded sum
__device__ __forceinline__ float scaled_prior(float raw, float lam, const float* p) {
  const float x = __fmul_rn(raw, lam);
  return p ? __fadd_rn(x, __ldg(p)) : x;
}

// One particle on GW lanes of a warp (a whole warp, or one half of it with
// the other half on the next particle: both halves take the same branches
// and loop counts, since they share m and n, so the warp-wide __syncwarp
// and shuffles of width GW serve both). x: its column of the block's tile,
// element r at x[r * ts] (rows [0, rows) its statistics, [rows, rows + m)
// its phi); L: its augmented triangle; logs: m floats; lane: 0 .. GW - 1;
// valid: j < n_out (a particle past the end computes on a stand-in column
// and writes nothing to global memory).
template <int MODE, int GW>
__device__ __forceinline__ void warp_particle(const Args& a, int j, bool valid, float* x, int ts,
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

  // A = P1 + lam*T1: lane l walks down columns c = l, l + GW, ...; T1[i][c]
  // (i >= c) at packed rows o1 + tri_off(c, m) + i - c; the draw writes
  // that row of S_new (lam*T1 + phi phi^T) in place as it reads it
  for (int c = lane; c < m; c += GW) {
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
  for (int i = lane; i < m; i += GW) {
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
    bump = __shfl_sync(kFull, bump, 0, GW);
    for (int c = lane; c < m; c += GW) L[c * ld + c] = __fadd_rn(L[c * ld + c], bump);
    __syncwarp();
  }

  // left-looking Cholesky of the augmented triangle, column by column:
  // lane l on row c + l (and c + l + GW), s = A[r][c] - sum_{k < c} L[r][k]
  // L[c][k] in increasing k; L[c][c] itself goes to logs[c]
  for (int c = 0; c < m; ++c) {
    const float* Lc = L + c * ld;
    const int r0 = c + lane, r1 = r0 + GW;
    const float* L0 = L + (r0 < R ? r0 : R - 1) * ld;
    float s0 = L0[c], s1 = 0.f;
    const bool two = c + GW < R;  // warp-uniform
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
    const float scc = __shfl_sync(kFull, s0, 0, GW);  // lane 0 holds row c
    const float inv = rsqrtf(scc);
    const float d = __fmul_rn(scc, inv);
    if (lane == 0) logs[c] = d;
    else if (r0 < R) L[r0 * ld + c] = r0 < m ? __fmul_rn(s0, inv) : __fdiv_rn(s0, d);
    if (two && r1 < R) L[r1 * ld + c] = r1 < m ? __fmul_rn(s1, inv) : __fdiv_rn(s1, d);
    __syncwarp();
  }
  for (int c = lane; c < m; c += GW) logs[c] = logf(logs[c]);

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
    for (int b = 0; b < 2; ++b) psi[a_][b] = __shfl_sync(kFull, val, (a_ * n + b) & 31, GW);
  for (int c = 0; c < 2; ++c) mean[c] = __shfl_sync(kFull, val, nn + c, GW);
  const float colv = __shfl_sync(kFull, val, nn + n, GW);

  float yv[2] = {0.f, 0.f};
  if (lane == 0 && valid) {
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
    for (int c = 0; c < 2; ++c) yv[c] = __shfl_sync(kFull, yv[c], 0, GW);
    for (int i = lane; i < m; i += GW)
      for (int c = 0; c < n; ++c) {
        float* t = x + (i * n + c) * ts;
        *t = forget_add(*t, lam, phi[i * ts], yv[c]);
      }
  }
}

// A block of 1 << log_w warps, 32 / GW particles on each.
template <int MODE, int GW>
__global__ void __launch_bounds__(32 * kMaxWarps)
warp_mniw_kernel(const Args a, int log_w) {
  extern __shared__ float smem[];
  constexpr int kPerWarp = 32 / GW;
  const int log_p = log_w + (kPerWarp == 2);
  const int P = 1 << log_p;  // particles per block
  const WarpPlan p(a.m, a.n, P, GW);
  float* tile = smem;
  int* src = reinterpret_cast<int*>(smem + p.tile_floats + P * p.per_particle);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & (GW - 1);
  const int q = (threadIdx.x & 31) / GW + warp * kPerWarp;  // the block's particle
  const int64_t j0 = (int64_t)blockIdx.x * P;
  const int64_t n_in = a.n_in, n_out = a.n_out;

  // the block's P source columns; only the draw gathers. A column past
  // n_out reads column 0 (read, never used)
  if (threadIdx.x < P) {
    const int64_t j = j0 + threadIdx.x;
    src[threadIdx.x] = j < n_out ? (MODE == kDraw ? source_column(a, (int)j) : (int)j) : 0;
  }
  __syncthreads();
  // stage S[:, src] and phi[:, j0 .. j0 + P) as the tile, kLoads loads in
  // flight per thread
  const int total = p.tile_rows << log_p;
  for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * blockDim.x) {
    float v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = min(e0 + u * (int)blockDim.x, total - 1);
      const int r = e >> log_p, w = e & (P - 1);
      v[u] = __ldg(r < p.rows ? a.S + r * n_in + src[w]
                              : a.phi + (r - p.rows) * n_out + min(j0 + w, n_out - 1));
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      const int e = e0 + u * (int)blockDim.x;
      if (e < total) tile[(e >> log_p) * p.ts + (e & (P - 1))] = v[u];
    }
  }
  __syncthreads();
  if (j0 + warp * kPerWarp < n_out) {  // warp-uniform
    const int64_t j = j0 + q;
    float* L = smem + p.tile_floats + q * p.per_particle;
    warp_particle<MODE, GW>(a, (int)j, j < n_out, tile + q, p.ts, L, L + p.R * p.ld, lane);
  }
  if constexpr (MODE == kDraw) {  // S_new by rows of P particles
    __syncthreads();
    for (int e = threadIdx.x; e < p.rows << log_p; e += blockDim.x) {
      const int r = e >> log_p, w = e & (P - 1);
      if (j0 + w < n_out) a.S_new[r * n_out + j0 + w] = tile[r * p.ts + w];
    }
  }
}

// lanes per particle at width m: a half warp while the augmented triangle
// has at most 32 rows for its two rows per lane (m <= 24, n <= 2), else
// a whole warp
int lanes_per_particle(int m) { return m <= 24 ? 16 : 32; }

// log2 of W, the most warps per block (8, 4, 2, 1) that still gives every
// SM a block: N = 200 at m = 41 runs 200 blocks of one warp
int warps_per_block(int n_out, int m, int& log_w) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
  }
  const int per_warp = 32 / lanes_per_particle(m);
  log_w = 3;  // kMaxWarps
  while (log_w > 0 && (n_out + (per_warp << log_w) - 1) / (per_warp << log_w) < sms) --log_w;
  return 0;
}

template <int MODE, int GW>
int launch_mode(const Args& a, cudaStream_t stream) {
  static bool raised = false;  // the dynamic shared-memory limit, once
  if (!raised) {
    const int P = kMaxWarps * 32 / GW;
    const int most = (int)WarpPlan(GW == 16 ? 24 : 48, 2, P, GW).bytes(P);
    const cudaError_t err = cudaFuncSetAttribute(
        warp_mniw_kernel<MODE, GW>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    raised = true;
  }
  int log_w = 0;
  if (const int rc = warps_per_block(a.n_out, a.m, log_w)) return rc;
  const int P = (32 / GW) << log_w;
  const size_t bytes = WarpPlan(a.m, a.n, P, GW).bytes(P);
  const dim3 grid((a.n_out + P - 1) / P);
  warp_mniw_kernel<MODE, GW><<<grid, 32 << log_w, bytes, stream>>>(a, log_w);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_width(const Args& a, cudaStream_t stream) {
  return lanes_per_particle(a.m) == 16 ? launch_mode<MODE, 16>(a, stream)
                                       : launch_mode<MODE, 32>(a, stream);
}

}  // namespace

int launch_warp_mniw(const Args& a, int mode, cudaStream_t stream) {
  if (a.m < 1 || a.m > 48 || a.n < 1 || a.n > 2) return (int)cudaErrorInvalidValue;
  if (a.n_out == 0) return (int)cudaGetLastError();
  if (mode == kProject) return launch_width<kProject>(a, stream);
  if (mode == kDraw) return launch_width<kDraw>(a, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace bipk_mniw

// The warp kernels' launch at (m, n) and n_out particles on the current
// card: warps and particles per block and dynamic shared memory in bytes,
// for reports.
extern "C" int bipk_warp_mniw_plan(int m, int n, int n_out, int* warps, int* particles,
                                   int* smem_bytes) {
  int log_w = 0;
  if (const int rc = bipk_mniw::warps_per_block(n_out, m, log_w)) return rc;
  const int GW = bipk_mniw::lanes_per_particle(m), P = (32 / GW) << log_w;
  *warps = 1 << log_w;
  *particles = P;
  *smem_bytes = (int)bipk_mniw::WarpPlan(m, n, P, GW).bytes(P);
  return 0;
}
