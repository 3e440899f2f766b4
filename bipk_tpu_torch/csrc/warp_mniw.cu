// Warp-per-particle MNIW look-ahead, gather/draw and log-determinants for
// 1 <= m <= 48, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of bipk_tpu/ops/pallas_kernels.py that compute
// the auxiliary look-ahead (mean / col / row / (logdet_T1, logdet_Psi) of
// prior + lam * S at phi), the matrix-t draw with its rank-1 update, and
// (logdet_T1, logdet_Psi) of prior + S alone, the cSMC ancestor weights'
// "with reference future" term:
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
//     :1067); _cs_du_kernel (:2353), the same without ancestors;
//   - the log-determinants: _packed_lbm_kernel (:1549) behind
//     log_base_measure_packed_logdets (:1941) for m <= 24, _cs_lbm_kernel
//     (:2341) behind _cs_call (:2454) above;
//   - for m <= 24, the factor pair of the reuse path: _packed_fp_emit_kernel
//     (:526) behind factorize_project_packed(emit_factor=True), the
//     look-ahead that also writes the factor LW = [tril(L) | white]; and
//     _du_factor_gather_kernel (:560) behind
//     draw_update_factor_gather_packed_blocks (:1422), the gathered draw
//     that reads L and white from LW[:, anc] instead of factoring again;
//   - for m <= 24, the dedup gather: _draw_update_dedup_gather_kernel
//     (:903) behind draw_update_dedup_gather_packed_blocks (:1312), the
//     gathered draw with each block's distinct ancestor columns read once;
//   - at every m <= 48, the projection from a given factor: _project_kernel
//     (:352) behind project_blocks (:1712), mean = white^T L^{-1} phi and
//     col = |L^{-1} phi|^2 + 1 from a factor read through its strides;
//   - at every m <= 48, on unpacked statistics (structured or flat T0, T1,
//     T2): _factorize_kernel (:299) behind factorize_blocks (:1583), the
//     factor written whole (chol, white, row),
//     _factorize_project_kernel (:468, core :371) behind
//     factorize_project_blocks (:1634), the look-ahead's projection, and
//     _log_base_measure_kernel (:1530) behind log_base_measure_logdets
//     (:2000), logdet sym(T1) and logdet Psi at lam = 1 with no prior.
// packed_mniw.cu launches these for its look-ahead, draw, log-determinants
// and factor pair at every m they serve, dedup_gather.cu and
// unpacked_mniw.cu for the dedup gather, the projection and the three
// unpacked modes. The log-determinants are a third
// mode of the same kernel (kLogdets): no phi (no phi rows in the tile, no
// phi^T row in the triangle), no gather, and lane 0 writes the two
// log-determinants only. The factor-emitting look-ahead (kEmit) is kProject
// that also stores each entry of L and white, as the Cholesky finishes it,
// at its row of LW in the particle's own column of the tile (rows [0,
// m(m+1)/2 + m n), the T0 and T1 it has read by then), which the block
// then writes out as the draw writes S_new. The factor-gather draw (kReuse)
// stages LW[:, anc] beside S[:, anc] and phi and runs no Cholesky: v =
// L^{-1} phi is a pass across the particle's lanes (lane l keeps the
// running sums of rows l and l + 16; for c = 0 .. m-1 every lane takes row
// c's sum from its owner by a shuffle and divides, and every later row
// takes its term), m dependent steps; Psi, mean and col read white from the
// tile, and the draw and the update are kDraw's. The dedup gather (kDedup)
// is kDraw on a tile filled another way: the block finds the runs of equal
// ancestors among its P sorted ones (a ballot of the run starts and a
// prefix count on warp 0), reads each run's column of S once into the
// particles' triangles (idle until the core starts, and always large
// enough: no extra shared memory and no fallback to global reads), and
// copies it on into the tile column of every particle of the run; out-of-
// order ancestors only start more runs. The projection from a given factor
// (kFromFactor) stages tril(L), white and phi of its P particles through
// the factor's element strides (each row P neighbouring floats, read in
// place from views of an augmented factor), runs kReuse's substitution
// across the particle's lanes, and gives mean and col one lane each: no
// S, no Cholesky, no draw. The unpacked modes stage the packed tile from
// the leaves (T0 as stored; T1 in the packed order, each entry read as
// 0.5 (T1[i][c] + T1[c][i]), the per-thread reader's UnpackedStats with
// its roundings written out, both loads rows of P neighbouring floats;
// all n^2 entries of T2 as stored, which Psi reads as T2[a][b], as the
// per-thread core does: no T3 row) and run kProject's core on it
// (kProjectUnpacked) or, without phi, kEmit's (kFactor): each entry of L
// and white goes to LW's rows of the particle's tile column as the
// Cholesky finishes it, Psi over its T2 row, and the block writes chol
// (zeros above the diagonal), white and row out by rows of P particles
// from the tile, whose rows hold P neighbouring floats (read from the
// particles' triangles, 16 (mod 32) floats apart at m <= 24, one entry of
// 16 particles would come from 2 banks). The unpacked log-determinants
// (kLogdetsUnpacked) stage that tile without phi and run kLogdets's core
// on it, T2 read over its n^2 rows as kProjectUnpacked reads it.
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
//     row  m+n         phi^T, the right-hand side of v (not in kLogdets)
// (row stride m | 1, odd, so 32 lanes on 32 rows hit 32 banks; lane l
// walks down columns l, l + GW, ... of A, the prior read through the
// read-only cache) and run the left-looking Cholesky over it, column by
// column: lane l takes row c + l (and c + l + GW while more rows remain;
// R = m + n + 1 <= 2 GW rows always, m + n in kLogdets). A matrix row is scaled by
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
// multiply-add; only the arrays' places differ. The log-determinants
// (kLogdets) were read the same way: <24, 2> and <48, 2> issue one
// sequence of FP operations, and a copy of the core with the prior adds,
// the bump and the Schur complement's start written out as rounded
// products and sums compiles to the same counts of each FP opcode, where
// a copy with the bump or the prior adds fused turns FADDs into FFMAs; so
// with phi compiled out nvcc still rounds them as written here. kEmit
// issues kProject's floating-point operations (<24, kEmit> and <24,
// kProject> compile to the same counts of each FP opcode). The per-thread
// factor_gather_kernel, kReuse's comparator, contracts every multiply-add
// of its substitution, Psi, mean and col into one FFMA (acc - L v as
// fma(-L, v, acc)), divides with the IEEE division, rounds "lam * T2 + P2"
// as a product and a predicated sum, and df_pred as kDraw's; kReuse writes
// those out the same way. kDedup's arithmetic is kDraw's on the same
// values; its comparator dedup_gather_kernel runs the per-thread core in
// mode kDraw as packed_mniw_kernel<24, kDraw> does. project_kernel,
// kFromFactor's comparator, contracts its substitution's acc - L v and
// its mean's and col's multiply-adds into FFMAs as factor_gather_kernel
// does (SASS, PERF.md), which kFromFactor writes out with __fmaf_rn. The
// unpacked modes are kProject's, kEmit's and kLogdets's arithmetic on
// values that the per-thread core reads through UnpackedStats
// (unpacked_mniw_kernel<24 | 48, kProject | kFactor | kLogdets>), the
// symmetric read of T1 written out as a rounded sum and a rounded product.
// chip_smoke.py holds these kernels against the per-thread ones bit for bit (phase 2 at m <= 24,
// phase 8 above, phase 14 for the factor pair and the dedup gather (also
// against #4), phase 18 for the projection and the unpacked modes; the
// comparator is packed_mniw_kernel<24 | 48, kProject / kDraw / kLogdets /
// kEmit> and factor_gather_kernel behind bipk_*_per_thread in
// packed_mniw.cu, dedup_gather_kernel, project_kernel<24 | 48> and
// unpacked_mniw_kernel<24 | 48, kProject | kFactor | kLogdets> behind the
// *_per_thread entries of dedup_gather.cu and unpacked_mniw.cu, which no
// wrapper reaches); tests/test_torch_warp_rehearsal.py,
// test_torch_factor_rehearsal.py, test_torch_dedup_project_rehearsal.py
// and test_torch_unpacked_rehearsal.py run them on the host (below).
//
// What bounds it on the H100. The bytes are those of the per-thread
// kernels: at m = 20, N = 32768, S is read once (30 MB: 0.010 ms for the
// look-ahead, 0.011 ms for the gathered draw with S_new written); at
// m = 41, 118 MB (0.037 and 0.073 ms); against ~4 and ~26 kflop per
// particle (0.002 and 0.013 ms at 67 TFLOP/s). The log-determinants read S
// alone: 9.6 MB at m = 20, N = 10240 (0.0029 ms), 0.72 MB at m = 41,
// N = 200 (0.0002 ms). The factor pair at m = 20, N = 32768: kEmit adds
// LW's 30 MB write (0.019 ms in all), kReuse reads S and LW of the
// distinct ancestors and writes S_new (up to 0.012 ms with every column
// distinct). The dedup gather moves #4's bytes with S read at each
// block's runs (a degenerate block of 16 reads 1-2 columns, not 16); the
// projection from a given factor at m = 20, n = 1 reads tril(L), white
// and phi and writes mean and col, 252 floats per particle (0.0099 ms at
// N = 32768, 0.0031 at 10240); the unpacked modes at m = 20, n = 1 read
// the leaves (421 floats per particle) and write the factor whole (421:
// 0.033 ms at N = 32768), the five small outputs (0.0175 ms) or the two
// log-determinants (0.0166 ms). In
// practice the instructions
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
//
// Launch state is kept per card: the SM count that sizes the blocks and
// the raised dynamic shared-memory limit (cudaFuncSetAttribute acts on the
// current card only) are read and set once per card and kernel, in atomic
// slots indexed by cudaGetDevice, so host threads on different cards may
// launch at once. The host rehearsal's stand-in has two cards with
// different SM counts to show it.

#include <atomic>

#include "packed_mniw.cuh"

namespace bipk_mniw {
namespace {

constexpr int kMaxWarps = 8;  // warps per block at large N
constexpr int kLoads = 8;     // global loads in flight per thread while staging
constexpr unsigned kFull = 0xffffffffu;

// The shared-memory plan of a block of P particles at (m, n), GW lanes per
// particle: the tile of the P particles' statistics (and phi, where the
// mode reads it), then per particle its augmented triangle (R = m + n + 1
// rows of stride ld with the phi^T row, m + n without it) and m
// log-diagonal slots, then P source columns. With two particles on a warp
// (GW = 16) a particle's area is padded to 16 (mod 32) floats: lane l of
// the two halves then reads row c + l of its own triangle from banks that
// differ, as 16 rows of an odd stride cover 16 banks and the other 16 lie
// 16 further on. The log-determinants (kLogdets) read no phi: no phi rows
// in the tile, no phi^T row in the triangle. The factor-gather draw
// (kReuse) stages LW's rows after phi's and keeps no triangle: one row
// holds v, then the m log-diagonal slots. The dedup gather (kDedup) plans
// as the draw; before the core starts it stages the block's distinct
// ancestor columns in the particles' triangles, whose P * per_particle
// floats always hold P * rows (per_particle >= rows at every m, n: no
// extra space and no fallback), and keeps 2P + 1 ints: the runs' source
// columns, each particle's run and the count of runs. The projection from
// a given factor (kFromFactor) stages LW's rows (tril(chol) and white)
// and phi, and keeps one row for v. The unpacked modes (kFactor,
// kProjectUnpacked, kLogdetsUnpacked) stage n^2 rows of T2 and no T3 row;
// kFactor and kLogdetsUnpacked read no phi.
__host__ __device__ constexpr bool unpacked_mode(int mode) {
  return mode == kFactor || mode == kProjectUnpacked || mode == kLogdetsUnpacked;
}
__host__ __device__ constexpr bool reads_phi(int mode) {
  return mode != kLogdets && mode != kFactor && mode != kLogdetsUnpacked;
}

struct WarpPlan {
  int rows, lw_rows, tile_rows, ts, ld, R, per_particle, tile_floats, ints;
  __host__ __device__ WarpPlan(int m, int n, int P, int GW, int mode)
      : rows(m * n + m * (m + 1) / 2 + (unpacked_mode(mode) ? n * n : n * (n + 1) / 2 + 1)),
        lw_rows(m * (m + 1) / 2 + m * n),
        tile_rows(mode == kFromFactor
                      ? lw_rows + m
                      : rows + (reads_phi(mode) ? m : 0) + (mode == kReuse ? lw_rows : 0)),
        ts(P | 1),  // odd row stride: 32 rows of one column hit 32 banks
        ld(m | 1),  // odd: 32 lanes on 32 rows of one column hit 32 banks
        R(mode == kReuse || mode == kFromFactor ? 1 : m + n + reads_phi(mode)),
        per_particle(padded(mode == kFromFactor ? ld
                            : mode == kDedup  ? max(R * ld + m, rows)
                                              : R * ld + m,
                            GW)),
        tile_floats(tile_rows * ts),
        ints(mode == kDedup ? 2 * P + 1 : P) {}
  __host__ __device__ static int padded(int floats, int GW) {
    return GW == 32 ? floats : floats + (48 - floats % 32) % 32;
  }
  __host__ __device__ size_t bytes(int P) const {
    return sizeof(float) * ((size_t)tile_floats + (size_t)P * per_particle) +
           sizeof(int) * ints;
  }
};

// lam * raw + prior as the per-thread core's compiled code rounds
// `x = raw * lam; if (P) x += P[..]`: a rounded product, then a rounded sum
__device__ __forceinline__ float scaled_prior(float raw, float lam, const float* p) {
  const float x = __fmul_rn(raw, lam);
  return p ? __fadd_rn(x, __ldg(p)) : x;
}

// kEmit: entry (r, c) of the finished factor into its row of LW in the
// particle's tile column: L[r][c] at row r(r+1)/2 + c, white[c][r - m] at
// row m(m+1)/2 + c n + r - m (the phi^T row is not in LW)
__device__ __forceinline__ void emit_lw(float* x, int ts, int m, int n, int r, int c, float f) {
  if (r < m) x[(r * (r + 1) / 2 + c) * ts] = f;
  else if (r < m + n) x[(m * (m + 1) / 2 + c * n + r - m) * ts] = f;
}

// v = L^{-1} phi across a particle's GW lanes, L read from LW's rows of
// its tile column (L[i][k] at lw[(i(i+1)/2 + k) * ts]), phi from phi[i *
// ts]; v[c] to V[c] (lane 0 writes). Lane l keeps the running sums of
// rows l and l + GW; for c = 0 .. m-1 every lane takes row c's sum from
// its owner and divides it by L[c][c] (the same v[c] on every lane, with
// no branch), and every row i > c takes fma(-L[i][c], v[c], .), so each
// row sums its terms in increasing k, as the per-thread substitutions do
// (one FFMA per term, the IEEE division): m dependent steps. The loads do
// not wait for v: L0[c] past row r0's end stays inside LW's triangle.
template <int GW>
__device__ __forceinline__ void solve_lanes(const float* lw, const float* phi, int ts, int m,
                                            float* V, int lane) {
  const int r0 = lane, r1 = lane + GW;
  const float* L0 = lw + (r0 < m ? r0 * (r0 + 1) / 2 : 0) * ts;
  const float* L1 = lw + (r1 < m ? r1 * (r1 + 1) / 2 : 0) * ts;
  float s0 = r0 < m ? phi[r0 * ts] : 0.f, s1 = r1 < m ? phi[r1 * ts] : 0.f;
#pragma unroll 4
  for (int c = 0; c < m; ++c) {
    const float l0 = L0[c * ts], l1 = L1[c * ts], d = lw[(c * (c + 1) / 2 + c) * ts];
    const float vc = __fdiv_rn(__shfl_sync(kFull, c < GW ? s0 : s1, c & (GW - 1), GW), d);
    if (lane == 0) V[c] = vc;
    if (r0 > c && r0 < m) s0 = __fmaf_rn(-l0, vc, s0);
    if (r1 > c && r1 < m) s1 = __fmaf_rn(-l1, vc, s1);
  }
}

// One particle on GW lanes of a warp (a whole warp, or one half of it with
// the other half on the next particle: both halves take the same branches
// and loop counts, since they share m and n, so the warp-wide __syncwarp
// and shuffles of width GW serve both). x: its column of the block's tile,
// element r at x[r * ts] (rows [0, rows) its statistics, [rows, rows + m)
// its phi, which kLogdets, kFactor and kLogdetsUnpacked have not, then
// LW's rows in kReuse;
// kEmit and kFactor write LW over rows [0, m(m+1)/2 + m n) once they have
// read them, and kFactor Psi over T2's rows); L: its
// augmented triangle (kReuse: v); logs: m floats; lane: 0 .. GW - 1;
// valid: j < n_out (a particle past the end computes on a stand-in column
// and writes nothing to global memory).
template <int MODE, int GW>
__device__ __forceinline__ void warp_particle(const Args& a, int j, bool valid, float* x, int ts,
                                              float* L, float* logs, int lane) {
  constexpr bool REUSE = MODE == kReuse;
  constexpr bool DRAW = MODE == kDraw || REUSE;  // the draw and the rank-1 update
  constexpr bool PHI = reads_phi(MODE);
  constexpr bool UNPACKED = unpacked_mode(MODE);
  constexpr bool EMIT = MODE == kEmit || MODE == kFactor;  // L and white into LW's rows
  const int m = a.m, n = a.n;
  const int64_t n_out = a.n_out;
  const int o1 = m * n, o2 = o1 + m * (m + 1) / 2, o3 = o2 + n * (n + 1) / 2;
  const int tri = m * (m + 1) / 2;
  // after T3's row, or (unpacked) after T2's n^2 rows; read only where PHI
  const float* phi = x + (UNPACKED ? o2 + n * n : o3 + 1) * ts;
  const float* lw = phi + m * ts;        // kReuse: LW, row r at lw[r * ts]
  const float lam = a.lam;
  const float* P0 = a.prior;
  const float* P1 = a.prior ? a.prior + m * n : nullptr;
  const float* P2 = a.prior ? a.prior + m * n + m * m : nullptr;
  const int ld = m | 1, R = m + n + PHI;

  if constexpr (REUSE) {
    // the T1 rows of S_new in place, lam*T1 + phi phi^T: lane l walks down
    // columns c = l, l + GW, ...
    for (int c = lane; c < m; c += GW) {
      const float phi_c = phi[c * ts];
      float* t = x + (o1 + tri_off(c, m) - c) * ts;
#pragma unroll 4
      for (int i = c; i < m; ++i) t[i * ts] = forget_add(t[i * ts], lam, phi[i * ts], phi_c);
    }
    // v = L^{-1} phi across the lanes, into L
    solve_lanes<GW>(lw, phi, ts, m, L, lane);
    for (int c = lane; c < m; c += GW) logs[c] = logf(lw[(c * (c + 1) / 2 + c) * ts]);
    __syncwarp();
  } else {
    // A = P1 + lam*T1: lane l walks down columns c = l, l + GW, ...; T1[i][c]
    // (i >= c) at packed rows o1 + tri_off(c, m) + i - c; the draw writes
    // that row of S_new (lam*T1 + phi phi^T) in place as it reads it
    for (int c = lane; c < m; c += GW) {
      const float phi_c = DRAW ? phi[c * ts] : 0.f;
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
      if constexpr (PHI) L[(m + n) * ld + i] = phi[i * ts];
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
    // L[c][k] in increasing k; L[c][c] itself goes to logs[c]. kEmit and
    // kFactor also store each finished entry in LW's rows of the tile column x
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
      if (lane == 0) {
        logs[c] = d;
        if constexpr (EMIT) x[(c * (c + 1) / 2 + c) * ts] = d;
      } else if (r0 < R) {
        const float f = r0 < m ? __fmul_rn(s0, inv) : __fdiv_rn(s0, d);
        L[r0 * ld + c] = f;
        if constexpr (EMIT) emit_lw(x, ts, m, n, r0, c, f);
      }
      if (two && r1 < R) {
        const float f = r1 < m ? __fmul_rn(s1, inv) : __fdiv_rn(s1, d);
        L[r1 * ld + c] = f;
        if constexpr (EMIT) emit_lw(x, ts, m, n, r1, c, f);
      }
      __syncwarp();
    }
    if constexpr (MODE != kFactor)  // no log-determinants there
      for (int c = lane; c < m; c += GW) logs[c] = logf(logs[c]);
  }

  // Psi = P2 + lam*T2 - white^T white, mean = white^T v, col = v.v + 1
  // (not without phi): one lane per entry, each summed over k in
  // the core's order. T2[a][b] the stored lower entry, or (unpacked) the
  // entry itself. white[k][c] at W[c * wc + k * wk]: row m + c of the
  // triangle, or (kReuse) LW's row tri + k n + c; v in row m + n, or
  // (kReuse) L
  const float* W = REUSE ? lw + tri * ts : L + m * ld;
  const int wc = REUSE ? ts : ld, wk = REUSE ? n * ts : 1;
  const float* V = REUSE ? L : L + (m + n) * ld;
  const int nn = n * n;
  float val = 0.f;
  if (lane < nn) {
    const int a_ = lane / n, b = lane - (lane / n) * n;
    const int lo = a_ < b ? a_ : b, hi = a_ < b ? b : a_;
    const int t2 = UNPACKED ? o2 + lane : o2 + tri_off(lo, n) + hi - lo;
    float acc = scaled_prior(x[t2 * ts], lam, P2 ? P2 + a_ * n + b : nullptr);
    const float* Wa = W + a_ * wc;
    const float* Wb = W + b * wc;
    for (int k = 0; k < m; ++k) acc = __fmaf_rn(-Wa[k * wk], Wb[k * wk], acc);
    val = acc;
    if constexpr (MODE == kFactor) x[t2 * ts] = acc;  // Psi over its own T2 row
  } else if constexpr (PHI) {
    if (lane < nn + n) {
      const float* Wc = W + (lane - nn) * wc;
      float acc = 0.f;
      for (int k = 0; k < m; ++k) acc = __fmaf_rn(Wc[k * wk], V[k], acc);
      val = acc;
    } else if (lane == nn + n) {
      float acc = 0.f;
      for (int k = 0; k < m; ++k) acc = __fmaf_rn(V[k], V[k], acc);
      val = __fadd_rn(acc, 1.f);
    }
  }
  if constexpr (MODE == kFactor) return;  // the block writes the factor out
  __syncwarp();
  float psi[2][2], mean[2] = {0.f, 0.f}, colv = 0.f;
  for (int a_ = 0; a_ < 2; ++a_)
    for (int b = 0; b < 2; ++b) psi[a_][b] = __shfl_sync(kFull, val, (a_ * n + b) & 31, GW);
  if constexpr (PHI) {
    for (int c = 0; c < 2; ++c) mean[c] = __shfl_sync(kFull, val, nn + c, GW);
    colv = __shfl_sync(kFull, val, nn + n, GW);
  }

  float yv[2] = {0.f, 0.f};
  if (lane == 0 && valid) {
    float half_ld = 0.f;
    for (int c = 0; c < m; ++c) half_ld = __fadd_rn(half_ld, logs[c]);
    a.ld[j] = 2.f * half_ld;
    a.ld[n_out + j] = logdet_psi_of(psi, n);
    if constexpr (MODE == kProject || MODE == kEmit || MODE == kProjectUnpacked) {
      for (int c = 0; c < n; ++c) a.mean[c * n_out + j] = mean[c];
      a.col[j] = colv;
      for (int a_ = 0; a_ < n; ++a_)
        for (int b = 0; b < n; ++b) a.row[(a_ * n + b) * n_out + j] = psi[a_][b];
    } else if constexpr (DRAW) {
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

// kFromFactor: one particle's projection from its given factor on GW lanes
// of a warp. x: its tile column, rows [0, m(m+1)/2) tril(L) row-major,
// then white (row m(m+1)/2 + k n + c), then phi; V: m floats for v.
// mean[c] = white[:, c] . v and col = v . v + 1, one lane each (lanes
// 0 .. n-1 and n), summed over k in increasing order with one fused
// multiply-add per term, as the per-thread project_kernel compiles them.
template <int GW>
__device__ __forceinline__ void warp_from_factor(const Args& a, int j, bool valid,
                                                 const float* x, int ts, float* V, int lane) {
  const int m = a.m, n = a.n;
  const float* white = x + m * (m + 1) / 2 * ts;
  solve_lanes<GW>(x, white + m * n * ts, ts, m, V, lane);
  __syncwarp();
  if (!valid || lane > n) return;
  float acc = 0.f;
  if (lane < n) {
    for (int k = 0; k < m; ++k) acc = __fmaf_rn(white[(k * n + lane) * ts], V[k], acc);
    a.mean[(int64_t)lane * a.n_out + j] = acc;
  } else {
    for (int k = 0; k < m; ++k) acc = __fmaf_rn(V[k], V[k], acc);
    a.col[j] = __fadd_rn(acc, 1.f);
  }
}

// Row i of a packed lower triangle that holds entry r (i(i+1)/2 <= r <
// (i+1)(i+2)/2).
__device__ __forceinline__ int tri_row(int r) {
  int i = (int)((sqrtf(8.f * (float)r + 1.f) - 1.f) * 0.5f);
  if ((i + 1) * (i + 2) / 2 <= r) ++i;
  return i;
}

// kFromFactor: where tile row r of particle j is read: rows [0, m(m+1)/2)
// L[i][k] through chol's strides, then white[k][c] through white's, then
// phi[i]; neighbouring particles are neighbouring floats in all three.
__device__ __forceinline__ const float* factor_source(const Args& a, int r, int64_t j) {
  const int tri = a.m * (a.m + 1) / 2, mn = a.m * a.n;
  if (r < tri) {
    const int i = tri_row(r);
    return a.chol_in + i * a.cs_i + (r - i * (i + 1) / 2) * a.cs_k + j;
  }
  if (r < tri + mn) {
    const int k = (r - tri) / a.n;
    return a.white_in + k * a.ws_k + (r - tri - k * a.n) * a.ws_c + j;
  }
  return a.phi + (int64_t)(r - tri - mn) * a.n_out + j;
}

// The unpacked modes: where tile row r of particle j is read from the
// leaves (each row P neighbouring floats): T0[i][c] at rows [0, m n) as
// stored; the packed T1 row m n + k (column c, row i >= c, column-major:
// k' = m(m+1)/2 - 1 - k lies in row m - 1 - c of a row-packed triangle)
// from T1[i][c] and, its mirror, T1[c][i], which the staging adds and
// halves (sym_entry); T2[a][b] at row m n + m(m+1)/2 + a n + b as stored;
// then phi (kProjectUnpacked). `mirror` is set for T1's rows only.
__device__ __forceinline__ const float* unpacked_source(const Args& a, int r, int64_t j,
                                                        const float*& mirror) {
  const int m = a.m, n = a.n, mn = m * n, tri = m * (m + 1) / 2, o2 = mn + tri;
  const int64_t n_in = a.n_in;
  mirror = nullptr;
  if (r < mn) return a.T0 + r * n_in + j;
  if (r < o2) {
    const int k = r - mn, c = m - 1 - tri_row(tri - 1 - k), i = c + k - tri_off(c, m);
    mirror = a.T1 + (c * m + i) * n_in + j;
    return a.T1 + (i * m + c) * n_in + j;
  }
  if (r < o2 + n * n) return a.T2 + (r - o2) * n_in + j;
  return a.phi + (r - o2 - n * n) * (int64_t)a.n_out + j;
}

// 0.5 (T1[i][c] + T1[c][i]) with the per-thread reader's (UnpackedStats)
// roundings: a rounded sum, then a rounded product
__device__ __forceinline__ float sym_entry(float x, float mirrored) {
  return __fmul_rn(0.5f, __fadd_rn(x, mirrored));
}

// A block of 1 << log_w warps, 32 / GW particles on each.
template <int MODE, int GW>
__global__ void __launch_bounds__(32 * kMaxWarps)
warp_mniw_kernel(const Args a, int log_w) {
  extern __shared__ float smem[];
  constexpr int kPerWarp = 32 / GW;
  const int log_p = log_w + (kPerWarp == 2);
  const int P = 1 << log_p;  // particles per block
  const WarpPlan p(a.m, a.n, P, GW, MODE);
  float* tile = smem;
  int* src = reinterpret_cast<int*>(smem + p.tile_floats + P * p.per_particle);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & (GW - 1);
  const int q = (threadIdx.x & 31) / GW + warp * kPerWarp;  // the block's particle
  const int64_t j0 = (int64_t)blockIdx.x * P;
  const int64_t n_in = a.n_in, n_out = a.n_out;

  constexpr bool GATHER = MODE == kDraw || MODE == kReuse || MODE == kDedup;
  if constexpr (MODE == kDedup) {
    // the block's runs of equal ancestors, on warp 0 (P <= 16): particle t
    // starts a run where its ancestor differs from its left neighbour's; a
    // ballot of the starts and a prefix count give each particle its run.
    // Run d's source column goes to src[d], particle t's run to slot[t],
    // their count D to *runs_of. A particle past n_out takes the last run
    // (computed on, never written). Out-of-order ancestors stay correct:
    // a value seen again starts another run
    int* slot = src + P;
    int* runs_of = slot + P;
    if (threadIdx.x < 32) {
      const int t = threadIdx.x;
      const bool live = t < P && j0 + t < n_out;
      const int col = live ? source_column(a, (int)(j0 + t)) : -1;
      const int left = __shfl_up_sync(kFull, col, 1);
      const bool starts = live && (t == 0 || left != col);
      const unsigned runs = __ballot_sync(kFull, starts);
      const int d = __popc(runs & ((2u << t) - 1u)) - 1;
      if (starts) src[d] = col;
      if (t < P) slot[t] = d;
      if (t == 0) *runs_of = __popc(runs);
    }
    __syncthreads();
    // stage each run's column of S once (element r of run d at stage[r * D
    // + d], neighbouring threads on neighbouring runs) in the particles'
    // triangles, idle until the core starts, and phi[:, j0 .. j0 + P) in
    // the tile, kLoads loads in flight per thread
    const int D = *runs_of;
    float* stage = smem + p.tile_floats;
    const int staged = D * p.rows, total = staged + (a.m << log_p);
    for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * blockDim.x) {
      float v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = min(e0 + u * (int)blockDim.x, total - 1);
        const float* from;
        if (e < staged) {
          const int r = e / D;
          from = a.S + r * n_in + src[e - r * D];
        } else {
          const int f = e - staged, w = f & (P - 1);
          from = a.phi + (f >> log_p) * n_out + min(j0 + w, n_out - 1);
        }
        v[u] = __ldg(from);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * (int)blockDim.x;
        if (e < staged) stage[e] = v[u];
        else if (e < total)
          tile[(p.rows + ((e - staged) >> log_p)) * p.ts + ((e - staged) & (P - 1))] = v[u];
      }
    }
    __syncthreads();
    // every particle's tile column from its run's staged copy
    for (int e = threadIdx.x; e < p.rows << log_p; e += blockDim.x) {
      const int r = e >> log_p, w = e & (P - 1);
      tile[r * p.ts + w] = stage[r * D + slot[w]];
    }
  } else if constexpr (unpacked_mode(MODE)) {
    // the P particles' packed tile from the leaves (unpacked_source), a
    // particle past n_out on column n_out - 1 (read, never written), kLoads
    // entries in flight per thread: T1's mirrored loads go into their own
    // registers, and every sum waits for the store loop, so no load waits
    // on another
    const int total = p.tile_rows << log_p;
    const int t1_rows = a.m * a.n, t1_end = t1_rows + a.m * (a.m + 1) / 2;
    for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * blockDim.x) {
      float v[kLoads], v_mirror[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = min(e0 + u * (int)blockDim.x, total - 1);
        const float* mirror;
        v[u] = __ldg(unpacked_source(a, e >> log_p, min(j0 + (e & (P - 1)), n_out - 1), mirror));
        v_mirror[u] = mirror ? __ldg(mirror) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * (int)blockDim.x, r = e >> log_p;
        if (e < total)
          tile[r * p.ts + (e & (P - 1))] =
              r >= t1_rows && r < t1_end ? sym_entry(v[u], v_mirror[u]) : v[u];
      }
    }
  } else {
    // the block's P source columns; only the draws gather. A column past
    // n_out reads column 0 (read, never used)
    if (threadIdx.x < P) {
      const int64_t j = j0 + threadIdx.x;
      src[threadIdx.x] = j < n_out ? (GATHER ? source_column(a, (int)j) : (int)j) : 0;
    }
    __syncthreads();
    // stage S[:, src], (but for kLogdets) phi[:, j0 .. j0 + P) and (kReuse)
    // LW[:, src] as the tile, or (kFromFactor) the particles' factors and
    // phi, kLoads loads in flight per thread
    const int total = p.tile_rows << log_p;
    for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * blockDim.x) {
      float v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = min(e0 + u * (int)blockDim.x, total - 1);
        const int r = e >> log_p, w = e & (P - 1);
        const float* from;
        if constexpr (MODE == kFromFactor) {
          from = factor_source(a, r, min(j0 + w, n_out - 1));
        } else {
          if (MODE == kLogdets || r < p.rows) from = a.S + r * n_in + src[w];
          else if (MODE != kReuse || r < p.rows + a.m)
            from = a.phi + (r - p.rows) * n_out + min(j0 + w, n_out - 1);
          else from = a.lw + (r - p.rows - a.m) * n_in + src[w];
        }
        v[u] = __ldg(from);
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const int e = e0 + u * (int)blockDim.x;
        if (e < total) tile[(e >> log_p) * p.ts + (e & (P - 1))] = v[u];
      }
    }
  }
  __syncthreads();
  if (j0 + warp * kPerWarp < n_out) {  // warp-uniform
    const int64_t j = j0 + q;
    float* L = smem + p.tile_floats + q * p.per_particle;
    if constexpr (MODE == kFromFactor) {
      warp_from_factor<GW>(a, (int)j, j < n_out, tile + q, p.ts, L, lane);
    } else {  // the dedup gather draws as kDraw on its tile
      warp_particle<MODE == kDedup ? kDraw : MODE, GW>(a, (int)j, j < n_out, tile + q, p.ts, L,
                                                       L + p.R * p.ld, lane);
    }
  }
  if constexpr (GATHER || MODE == kEmit) {  // S_new (kEmit: LW) by rows of P particles
    __syncthreads();
    float* out = MODE == kEmit ? a.lw_out : a.S_new;
    const int out_rows = MODE == kEmit ? p.lw_rows : p.rows;
    for (int e = threadIdx.x; e < out_rows << log_p; e += blockDim.x) {
      const int r = e >> log_p, w = e & (P - 1);
      if (j0 + w < n_out) out[r * n_out + j0 + w] = tile[r * p.ts + w];
    }
  }
  if constexpr (MODE == kFactor) {
    // chol (m m rows, zeros above the diagonal), white (m n) and row (n n)
    // by rows of P particles: L[i][k] from LW's row i(i+1)/2 + k of the
    // tile, white's row q from row m(m+1)/2 + q and Psi's row q from T2's,
    // m(m+1)/2 + m n + q: the two follow each other
    __syncthreads();
    const int m = a.m, mm = m * m, mn = m * a.n, tri = m * (m + 1) / 2;
    const int total = (mm + mn + a.n * a.n) << log_p;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int r = e >> log_p, w = e & (P - 1);
      if (j0 + w >= n_out) continue;
      float v, *out;
      if (r < mm) {
        const int i = r / m, k = r - i * m;
        v = k <= i ? tile[(i * (i + 1) / 2 + k) * p.ts + w] : 0.f;
        out = a.chol + r * n_out;
      } else {
        v = tile[(tri + r - mm) * p.ts + w];
        out = r < mm + mn ? a.white + (r - mm) * n_out : a.row + (r - mm - mn) * n_out;
      }
      out[j0 + w] = v;
    }
  }
}

// lanes per particle at width m: a half warp while the augmented triangle
// has at most 32 rows for its two rows per lane (m <= 24, n <= 2), else
// a whole warp
int lanes_per_particle(int m) { return m <= 24 ? 16 : 32; }

// The cards a process may use, for the launch state kept per card.
constexpr int kMaxDevices = 64;

// The current card, checked against kMaxDevices.
cudaError_t current_device(int& dev) {
  const cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  return dev >= 0 && dev < kMaxDevices ? cudaSuccess : cudaErrorInvalidDevice;
}

// log2 of W, the most warps per block (8, 4, 2, 1) that still gives every
// SM of card `dev` a block: N = 200 at m = 41 runs 200 blocks of one warp.
// Each card's SM count is read once and kept per card; host threads on
// different cards may plan at once (an atomic per card: two that race on
// one card both read and store the same count).
int warps_per_block(int dev, int n_out, int m, int& log_w) {
  static std::atomic<int> sms_of[kMaxDevices];
  int sms = sms_of[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    sms_of[dev].store(sms, std::memory_order_relaxed);
  }
  const int per_warp = 32 / lanes_per_particle(m);
  log_w = 3;  // kMaxWarps
  while (log_w > 0 && (n_out + (per_warp << log_w) - 1) / (per_warp << log_w) < sms) --log_w;
  return 0;
}

// The dynamic shared-memory limit of warp_mniw_kernel<MODE, GW>, raised on
// each card to what its widest shape needs (m = 24 | 48, n = 2, W = 8)
// before the first launch there: cudaFuncSetAttribute acts on the current
// card only. Kept per card as an atomic flag; a failed call is tried
// again at the next launch.
template <int MODE, int GW>
int launch_mode(const Args& a, cudaStream_t stream) {
  static std::atomic<bool> raised[kMaxDevices];
  int dev = 0;
  if (const cudaError_t err = current_device(dev); err != cudaSuccess) return (int)err;
  if (!raised[dev].load(std::memory_order_acquire)) {
    const int P = kMaxWarps * 32 / GW;
    const int most = (int)WarpPlan(GW == 16 ? 24 : 48, 2, P, GW, MODE).bytes(P);
    const cudaError_t err = cudaFuncSetAttribute(
        warp_mniw_kernel<MODE, GW>, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
    if (err != cudaSuccess) return (int)err;
    raised[dev].store(true, std::memory_order_release);
  }
  int log_w = 0;
  if (const int rc = warps_per_block(dev, a.n_out, a.m, log_w)) return rc;
  const int P = (32 / GW) << log_w;
  const size_t bytes = WarpPlan(a.m, a.n, P, GW, MODE).bytes(P);
  const dim3 grid((a.n_out + P - 1) / P);
  warp_mniw_kernel<MODE, GW><<<grid, 32 << log_w, bytes, stream>>>(a, log_w);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_width(const Args& a, cudaStream_t stream) {
  if constexpr (MODE == kEmit || MODE == kReuse || MODE == kDedup) {
    return launch_mode<MODE, 16>(a, stream);  // m <= 24 (takes)
  } else {
    return lanes_per_particle(a.m) == 16 ? launch_mode<MODE, 16>(a, stream)
                                         : launch_mode<MODE, 32>(a, stream);
  }
}

// (mode, m) the warp kernel takes: every m <= 48 but the factor pair's
// (kEmit, kReuse), which serves m <= 24 only, as the TPU's
// (supported_factor), and the dedup gather's, m <= 24 as the TPU's
// (DEDUP_MAX_M)
bool takes(int mode, int m) {
  if (mode == kEmit || mode == kReuse || mode == kDedup) return m <= 24;
  return mode == kProject || mode == kDraw || mode == kLogdets || mode == kFromFactor ||
         unpacked_mode(mode);
}

}  // namespace

int launch_warp_mniw(const Args& a, int mode, cudaStream_t stream) {
  if (a.m < 1 || a.m > 48 || a.n < 1 || a.n > 2 || !takes(mode, a.m))
    return (int)cudaErrorInvalidValue;
  if (a.n_out == 0) return (int)cudaGetLastError();
  switch (mode) {
    case kProject: return launch_width<kProject>(a, stream);
    case kDraw: return launch_width<kDraw>(a, stream);
    case kLogdets: return launch_width<kLogdets>(a, stream);
    case kEmit: return launch_width<kEmit>(a, stream);
    case kReuse: return launch_width<kReuse>(a, stream);
    case kDedup: return launch_width<kDedup>(a, stream);
    case kFactor: return launch_width<kFactor>(a, stream);
    case kProjectUnpacked: return launch_width<kProjectUnpacked>(a, stream);
    case kLogdetsUnpacked: return launch_width<kLogdetsUnpacked>(a, stream);
    default: return launch_width<kFromFactor>(a, stream);
  }
}

}  // namespace bipk_mniw

// The warp kernel's launch in `mode` (kProject, kDraw, kLogdets, kEmit,
// kFactor, kReuse, kDedup, kFromFactor, kProjectUnpacked or
// kLogdetsUnpacked) at (m, n) and n_out particles on the current card:
// warps and particles per block and dynamic shared memory in bytes, for
// reports.
extern "C" int bipk_warp_mniw_plan(int mode, int m, int n, int n_out, int* warps,
                                   int* particles, int* smem_bytes) {
  if (m < 1 || m > 48 || n < 1 || n > 2 || !bipk_mniw::takes(mode, m))
    return (int)cudaErrorInvalidValue;
  int dev = 0, log_w = 0;
  if (const cudaError_t err = bipk_mniw::current_device(dev); err != cudaSuccess) return (int)err;
  if (const int rc = bipk_mniw::warps_per_block(dev, n_out, m, log_w)) return rc;
  const int GW = bipk_mniw::lanes_per_particle(m), P = (32 / GW) << log_w;
  *warps = 1 << log_w;
  *particles = P;
  *smem_bytes = (int)bipk_mniw::WarpPlan(m, n, P, GW, mode).bytes(P);
  return 0;
}
