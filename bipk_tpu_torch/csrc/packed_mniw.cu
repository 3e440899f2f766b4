// Per-particle MNIW factorize / project / draw / update over the packed
// batch-last statistics, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of bipk_tpu/ops/pallas_kernels.py:
//   - factorize_project_packed (:1740) -> _packed_fp_kernel (:501), core
//     _factorize_project_core (:371): the auxiliary look-ahead;
//   - draw_update_packed_blocks (:1848) -> _draw_update_packed_kernel
//     (:768), tail _draw_update_tail (:691);
//   - draw_update_gather_packed_blocks (:1041) -> _draw_update_gather_kernel
//     (:878): the same draw/update on S[:, ancestors], gathered in-kernel;
//   - log_base_measure_packed_logdets (:1941) -> _packed_lbm_kernel (:1549):
//     (logdet_T1, logdet_Psi) of prior + S at lam = 1, the cSMC ancestor
//     weights' "with reference future" term. It is the same per-thread
//     factorization core (Cholesky, forward substitution of T0, Schur
//     complement) with the projection and the draw compiled out; the prior
//     buffer then carries prior + the reference's future statistics, a new
//     offset every step, and nu stays with the caller;
//   - factorize_project_packed(emit_factor=True) -> _packed_fp_emit_kernel
//     (:526): the projection that also writes the factor LW = [tril(L) |
//     white], a fourth mode (kEmit) of the same core, m <= 24 only;
//   - draw_update_factor_gather_packed_blocks (:1422) ->
//     _du_factor_gather_kernel (:560): the gathered draw/update reading
//     L and white from LW[:, anc[j]] instead of factoring again
//     (factor_gather_kernel below, m <= 24).
// All are compiled here as the comparator of the warp kernels (see
// below): packed_mniw_kernel<24, MODE> and factor_gather_kernel serve
// m <= 24, the widths of the TPU's tiled kernels above;
// packed_mniw_kernel<48, MODE> covers 24 < m <= 48 (the toy, m = 40, and
// the single-mass oscillator, m = 41), the widths of the TPU's cs-layout
// kernels: _cs_call (:2454) with _cs_fp_kernel (:2322), _cs_lbm_kernel
// (:2341) and _cs_du_kernel (:2353), and _cs_du_gather_call (:2482) with
// _cs_du_gather_kernel (:2418). It computes what they compute, not their
// column-on-sublane blocking.
//
// At both widths the wrappers' look-ahead, draw and log-determinants (the
// first four above; _cs_fp_kernel, _cs_lbm_kernel, _cs_du_kernel and
// _cs_du_gather_kernel), and at m <= 24 the factor pair (the last two),
// run the warp-per-particle kernels of warp_mniw.cu
// (launch_warp_mniw below): two particles per warp at m <= 24, one above,
// the augmented factor in shared memory, the forward substitutions riding
// along with a left-looking Cholesky. The instructions a particle's lanes
// issue bound them, not HBM; at m = 20 they take ~1/2 of the per-thread
// kernels' time at N = 32768 and ~1/3 at N = 10240, at m = 41 ~1/3 at
// N = 32768 and ~1/15 at N = 200 (PERF.md). They are bit for bit equal to
// packed_mniw_kernel<24 | 48, kProject / kDraw / kLogdets>, <24, kEmit>
// and factor_gather_kernel: each entry is the same f32 operations in the
// same order, with the roundings nvcc gives these kernels written out
// (warp_mniw.cu). Those per-thread kernels stay compiled as their
// comparator, behind the bipk_*_per_thread entries below; no wrapper
// reaches them, and chip_smoke.py holds the warp kernels against them
// (phases 2, 8 and 14).
//
// Layout. S is (rows, N) row-major with rows
// [T0 (m*n) | column-major tril(T1) | tril(T2) | T3] and the particle index
// fastest, so a warp's 32 threads (32 particles) read one row as one
// coalesced 128-byte line. The prior, if any, is one f32 buffer
// [P0 (m*n, row-major) | P1 (m*m) | P2 (n*n)] that every thread reads
// through the read-only cache.
//
// Design: one thread per particle (the column core, packed_mniw.cuh, which
// dedup_gather.cu shares). Each thread reads its particle's column
// of S exactly once, factors A = P1 + lam*T1 + (jitter/m)*trace(.)*I in a
// per-thread packed array (local memory), forward-substitutes the prior
// mean and phi, and writes only the small outputs. The draw/update variant
// writes the T1 rows of S_new (lam*T1 + phi phi^T, independent of the
// draw) as it reads them and the T0/T2/T3 rows after the draw, so S is read
// once and S_new written once, into a separate buffer. With a sorted
// ancestor vector thread j reads column anc[j]; neighbouring threads then
// read the same or nearby columns and the gather costs no extra pass.
// Every gathering kernel checks 0 <= anc[j] < n_in with a device-side
// assert (source_column), as torch's CUDA index_select does: no host
// synchronisation; a bad index traps the kernel, and the next
// synchronisation raises, where it would otherwise read out of bounds.
//
// What bounds it on the H100 at m = 20, N = 32768: each call moves ~34 MB
// (factorize/project) or ~64 MB (draw/update) of statistics, ~10 us and
// ~19 us at 3.35 TB/s, against ~3.6 kflop per particle (~2 us at the
// 67 TFLOP/s f32 rate) -- bytes, in principle. This first version keeps the
// m(m+1)/2-entry factor in local memory (spilled, L1/L2-cached), so the
// Cholesky's ~m^3/6 dependent local loads, not HBM, bound it in practice.
// (The look-ahead, the draw and the log-determinants now keep it in shared
// memory, a warp or a half warp per particle: warp_mniw.cu.)
// The log-determinant variant moves ~4 B * N * (rows + 2) (9.6 MB at
// N = 10240, 2.9 us) and does ~m^3/3 + m^2 n flops per particle: bytes in
// principle, the same local-memory Cholesky in practice. At m = 41
// (rows = 904) factorize/project moves ~124 MB at N = 32768 (37 us) and
// the gathered draw/update ~243 MB (73 us); the frame grows to 5.1-5.9 KB
// and the dependent chain by ~(41/20)^3, so the per-thread <48> kernels
// run ~50x their bound, and at the Gibbs paths' N = 200 (two blocks) one
// thread's chain is the whole time.
//
// The factor pair (m = 20, n = 1, rows_lw = m(m+1)/2 + m = 230). kEmit is
// kProject plus one write of LW, 30 MB at N = 32768: ~64 MB in all, 19 us
// at 3.35 TB/s. factor_gather_kernel reads S and LW of each distinct
// ancestor (up to 60 MB) and writes S_new (30 MB): ~28 us with every
// column distinct. It does no Cholesky: a forward substitution of phi
// reads L row by row from LW, white is read once for Psi and the mean,
// and each thread keeps only phi[m] and v[m]; what remains is m^2/2
// dependent global loads. Both per-thread versions ran 17-20x their byte
// bound on the card, and the warp kernel's kEmit and kReuse now take
// their place on the wrappers' path (PERF.md).
//
// C interface (loaded with ctypes): every function launches on the given
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include "packed_mniw.cuh"

using namespace bipk_mniw;

namespace {

template <int MAXM, int MODE>
__global__ void __launch_bounds__(kThreads)
packed_mniw_kernel(const Args a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.n_out) return;
  // only the draw gathers; the other modes read column j
  const int src = MODE == kDraw ? source_column(a, j) : j;
  mniw_column<MAXM, MODE>(a, j, a.S + src, a.n_in);
}

// #4's draw/update on S[:, anc[j]] with the factor of prior + lam *
// S[:, anc[j]] read from LW[:, anc[j]] (emitted by kEmit for the same
// statistics, prior and lam) instead of factored again.
__global__ void __launch_bounds__(kThreads)
factor_gather_kernel(const Args a) {
  constexpr int MAXM = 24;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.n_out) return;
  const int m = a.m, n = a.n;
  const int64_t n_in = a.n_in, n_out = a.n_out;
  const int src = source_column(a, j);
  const float* Sc = a.S + src;    // element r: Sc[r * n_in]
  const float* LWc = a.lw + src;  // element r: LWc[r * n_in]
  const int o1 = m * n;
  const int o2 = o1 + m * (m + 1) / 2;
  const int o3 = o2 + n * (n + 1) / 2;
  const int tri = m * (m + 1) / 2;
  const float lam = a.lam;
  const float* P2 = a.prior ? a.prior + m * n + m * m : nullptr;

  float phi[MAXM];
  for (int i = 0; i < m; ++i) phi[i] = a.phi[i * n_out + j];

  // the T1 rows of S_new: lam*T1 + phi phi^T, independent of the draw
  for (int c = 0; c < m; ++c) {
    for (int i = c; i < m; ++i) {
      const int k = tri_off(c, m) + i - c;
      a.S_new[(o1 + k) * n_out + j] = forget_add(Sc[(o1 + k) * n_in], lam, phi[i], phi[c]);
    }
  }

  // v = L^{-1} phi, row i of L at LW rows i(i+1)/2 .. i(i+1)/2 + i
  float vv[MAXM];
  float half_ld = 0.f;
  for (int i = 0; i < m; ++i) {
    const float* Li = LWc + (int64_t)(i * (i + 1) / 2) * n_in;
    float acc = phi[i];
    for (int k = 0; k < i; ++k) acc -= Li[k * n_in] * vv[k];
    const float d = Li[i * n_in];
    vv[i] = acc / d;
    half_ld += logf(d);
  }

  // Psi = P2 + lam*T2 - white^T white and mean = white^T v, white read once
  float t2raw[3];
  float psi[2][2];
  for (int b = 0; b < n; ++b) {
    for (int a_ = b; a_ < n; ++a_) {
      t2raw[tri_off(b, n) + a_ - b] = Sc[(o2 + tri_off(b, n) + a_ - b) * n_in];
    }
  }
  for (int a_ = 0; a_ < n; ++a_) {
    for (int b = 0; b < n; ++b) {
      const int lo = a_ < b ? a_ : b, hi = a_ < b ? b : a_;
      float acc = t2raw[tri_off(lo, n) + hi - lo] * lam;
      if (P2) acc += __ldg(P2 + a_ * n + b);
      psi[a_][b] = acc;
    }
  }
  float mean[2] = {0.f, 0.f};
  for (int k = 0; k < m; ++k) {
    float w[2];
    for (int c = 0; c < n; ++c) w[c] = LWc[(tri + k * n + c) * n_in];
    for (int a_ = 0; a_ < n; ++a_)
      for (int b = 0; b < n; ++b) psi[a_][b] -= w[a_] * w[b];
    for (int c = 0; c < n; ++c) mean[c] += w[c] * vv[k];
  }
  a.ld[j] = 2.f * half_ld;
  a.ld[n_out + j] = logdet_psi_of(psi, n);

  float colv = 0.f;
  for (int k = 0; k < m; ++k) colv += vv[k] * vv[k];
  colv += 1.f;

  const float t3raw = Sc[o3 * n_in];
  float yv[2];
  matrix_t_draw(a, j, t3raw * lam + a.p3 + (1.f - n), psi, mean, colv, yv);

  // rank-1 update of the raw statistics, T0 read here for the first time
  for (int i = 0; i < m; ++i)
    for (int c = 0; c < n; ++c)
      a.S_new[(i * n + c) * n_out + j] = forget_add(Sc[(i * n + c) * n_in], lam, phi[i], yv[c]);
  for (int b = 0; b < n; ++b)
    for (int a_ = b; a_ < n; ++a_) {
      const int k = tri_off(b, n) + a_ - b;
      a.S_new[(o2 + k) * n_out + j] = forget_add(t2raw[k], lam, yv[a_], yv[b]);
    }
  a.S_new[o3 * n_out + j] = forget_add(t3raw, lam, 1.f, 1.f);
}

bool bad_shape(const Args& a, int max_m) {
  return a.m < 1 || a.m > max_m || a.n < 1 || a.n > 2;
}

// launch_per_thread: packed_mniw_kernel<24, MODE> for m <= 24, else
// <48, MODE>: the comparator of the warp kernels
template <int MODE>
int launch_per_thread(const Args& a, cudaStream_t stream) {
  // the factor pair serves m <= 24 only, as the TPU's (supported_factor)
  if (bad_shape(a, MODE == kEmit ? 24 : 48)) return (int)cudaErrorInvalidValue;
  if (a.n_out == 0) return (int)cudaGetLastError();
  const dim3 grid((a.n_out + kThreads - 1) / kThreads);
  if (a.m <= 24) {
    packed_mniw_kernel<24, MODE><<<grid, kThreads, 0, stream>>>(a);
  } else if constexpr (MODE != kEmit) {
    packed_mniw_kernel<48, MODE><<<grid, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

Args project_args(const float* S, const float* phi, const float* prior, int n_particles,
                  int m, int n, float jitter, float lam, float* mean, float* col,
                  float* row, float* ld) {
  Args a = {};
  a.S = S; a.anc = nullptr; a.phi = phi; a.prior = prior;
  a.n_in = n_particles; a.n_out = n_particles; a.m = m; a.n = n;
  a.jitter = jitter; a.lam = lam;
  a.mean = mean; a.col = col; a.row = row; a.ld = ld;
  return a;
}

// the factor-gather draw: jitter is not read (it is in LW)
Args factor_gather_args(const float* S, const float* LW, int n_in, const int* anc, int n_out,
                        const float* phi, const float* u, const float* v, const float* prior,
                        float p3, int m, int n, float lam, float* S_new, float* y, float* ld) {
  Args a = draw_args(S, n_in, anc, n_out, phi, u, v, prior, p3, m, n, 0.f, lam, S_new, y, ld);
  a.lw = LW;
  return a;
}

// lam = 1 at run time, as the per-thread core reads it: scaled_prior and
// the core still round the product raw * lam, exactly
Args logdets_args(const float* S, const float* prior, int n_particles, int m, int n,
                  float jitter, float* ld) {
  Args a = {};
  a.S = S; a.anc = nullptr; a.phi = nullptr; a.prior = prior;
  a.n_in = n_particles; a.n_out = n_particles; a.m = m; a.n = n;
  a.jitter = jitter; a.lam = 1.f; a.ld = ld;
  return a;
}

}  // namespace

extern "C" int bipk_factorize_project_packed(
    const float* S, const float* phi, const float* prior, int n_particles,
    int m, int n, float jitter, float lam, float* mean, float* col,
    float* row, float* ld, float* lw, void* stream) {
  Args a = project_args(S, phi, prior, n_particles, m, n, jitter, lam, mean, col, row, ld);
  a.lw_out = lw;
  return launch_warp_mniw(a, lw ? kEmit : kProject, static_cast<cudaStream_t>(stream));
}

extern "C" int bipk_draw_update_packed(
    const float* S, int n_in, const int* anc, int n_out, const float* phi,
    const float* u, const float* v, const float* prior, float p3, int m,
    int n, float jitter, float lam, float* S_new, float* y, float* ld,
    void* stream) {
  return launch_warp_mniw(draw_args(S, n_in, anc, n_out, phi, u, v, prior, p3, m, n, jitter,
                                    lam, S_new, y, ld),
                          kDraw, static_cast<cudaStream_t>(stream));
}

// The comparator: the per-thread packed_mniw_kernel<24, kProject / kDraw>
// for m <= 24 and <48, kProject / kDraw> above, and with lw <24, kEmit>,
// which the warp kernels replace on the wrappers' path and must equal bit
// for bit. chip_smoke.py calls these entries (and the other
// *_per_thread ones below); no wrapper does.
extern "C" int bipk_factorize_project_packed_per_thread(
    const float* S, const float* phi, const float* prior, int n_particles,
    int m, int n, float jitter, float lam, float* mean, float* col,
    float* row, float* ld, float* lw, void* stream) {
  Args a = project_args(S, phi, prior, n_particles, m, n, jitter, lam, mean, col, row, ld);
  a.lw_out = lw;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return lw ? launch_per_thread<kEmit>(a, s) : launch_per_thread<kProject>(a, s);
}

extern "C" int bipk_draw_update_packed_per_thread(
    const float* S, int n_in, const int* anc, int n_out, const float* phi,
    const float* u, const float* v, const float* prior, float p3, int m,
    int n, float jitter, float lam, float* S_new, float* y, float* ld,
    void* stream) {
  return launch_per_thread<kDraw>(draw_args(S, n_in, anc, n_out, phi, u, v, prior, p3, m, n,
                                            jitter, lam, S_new, y, ld),
                                  static_cast<cudaStream_t>(stream));
}

extern "C" int bipk_draw_update_factor_gather_packed(
    const float* S, const float* LW, int n_in, const int* anc, int n_out,
    const float* phi, const float* u, const float* v, const float* prior,
    float p3, int m, int n, float lam, float* S_new, float* y, float* ld,
    void* stream) {
  const Args a = factor_gather_args(S, LW, n_in, anc, n_out, phi, u, v, prior, p3, m, n, lam,
                                    S_new, y, ld);
  if (bad_shape(a, 24) || !anc || !LW) return (int)cudaErrorInvalidValue;
  return launch_warp_mniw(a, kReuse, static_cast<cudaStream_t>(stream));
}

// The comparator of the warp kernel's factor-gather draw (kReuse): the
// per-thread factor_gather_kernel, which chip_smoke.py calls and no
// wrapper does.
extern "C" int bipk_draw_update_factor_gather_packed_per_thread(
    const float* S, const float* LW, int n_in, const int* anc, int n_out,
    const float* phi, const float* u, const float* v, const float* prior,
    float p3, int m, int n, float lam, float* S_new, float* y, float* ld,
    void* stream) {
  const Args a = factor_gather_args(S, LW, n_in, anc, n_out, phi, u, v, prior, p3, m, n, lam,
                                    S_new, y, ld);
  if (bad_shape(a, 24) || !anc || !LW) return (int)cudaErrorInvalidValue;
  if (n_out == 0) return (int)cudaGetLastError();
  const dim3 grid((n_out + kThreads - 1) / kThreads);
  factor_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

extern "C" int bipk_log_base_measure_packed(
    const float* S, const float* prior, int n_particles, int m, int n,
    float jitter, float* ld, void* stream) {
  return launch_warp_mniw(logdets_args(S, prior, n_particles, m, n, jitter, ld), kLogdets,
                          static_cast<cudaStream_t>(stream));
}

// The comparator of the warp log-determinants: the per-thread
// packed_mniw_kernel<24 | 48, kLogdets>, which chip_smoke.py calls and no
// wrapper does.
extern "C" int bipk_log_base_measure_packed_per_thread(
    const float* S, const float* prior, int n_particles, int m, int n,
    float jitter, float* ld, void* stream) {
  return launch_per_thread<kLogdets>(logdets_args(S, prior, n_particles, m, n, jitter, ld),
                                     static_cast<cudaStream_t>(stream));
}
