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
//     offset every step, and nu stays with the caller.
// Each is compiled twice: packed_mniw_kernel<24, MODE> serves m <= 24, the
// widths of the TPU's tiled kernels above; packed_mniw_kernel<48, MODE>
// serves 24 < m <= 48 (the toy, m = 40, and the single-mass oscillator,
// m = 41) and replaces the TPU's cs-layout kernels of those widths:
// _cs_call (:2454) with _cs_fp_kernel (:2322), _cs_lbm_kernel (:2341) and
// _cs_du_kernel (:2353), and _cs_du_gather_call (:2482) with
// _cs_du_gather_kernel (:2418). It computes what they compute, not their
// column-on-sublane blocking.
//
// Layout. S is (rows, N) row-major with rows
// [T0 (m*n) | column-major tril(T1) | tril(T2) | T3] and the particle index
// fastest, so a warp's 32 threads (32 particles) read one row as one
// coalesced 128-byte line. The prior, if any, is one f32 buffer
// [P0 (m*n, row-major) | P1 (m*m) | P2 (n*n)] that every thread reads
// through the read-only cache.
//
// Design: one thread per particle. Each thread reads its particle's column
// of S exactly once, factors A = P1 + lam*T1 + (jitter/m)*trace(.)*I in a
// per-thread packed array (local memory), forward-substitutes the prior
// mean and phi, and writes only the small outputs. The draw/update variant
// writes the T1 rows of S_new (lam*T1 + phi phi^T, independent of the
// draw) as it reads them and the T0/T2/T3 rows after the draw, so S is read
// once and S_new written once, into a separate buffer. With a sorted
// ancestor vector thread j reads column anc[j]; neighbouring threads then
// read the same or nearby columns and the gather costs no extra pass.
//
// What bounds it on the H100 at m = 20, N = 32768: each call moves ~34 MB
// (factorize/project) or ~64 MB (draw/update) of statistics, ~10 us and
// ~19 us at 3.35 TB/s, against ~3.6 kflop per particle (~2 us at the
// 67 TFLOP/s f32 rate) -- bytes, in principle. This first version keeps the
// m(m+1)/2-entry factor in local memory (spilled, L1/L2-cached), so the
// Cholesky's ~m^3/6 dependent local loads, not HBM, bound it in practice.
// Shared-memory staging of the factor and tensor-core panels are later work.
// The log-determinant variant moves ~4 B * N * (rows + 2) (9.6 MB at
// N = 10240, 2.9 us) and does ~m^3/3 + m^2 n flops per particle: bytes in
// principle, the same local-memory Cholesky in practice. At m = 41
// (rows = 904) factorize/project moves ~124 MB at N = 32768 (37 us) and
// the gathered draw/update ~243 MB (73 us); the frame grows to 5.1-5.9 KB
// and the dependent chain by ~(41/20)^3, so the <48> kernels run ~50x
// their bound, and at the Gibbs paths' N = 200 (two blocks) one thread's
// chain is the whole time. Times: PERF.md.
//
// C interface (loaded with ctypes): every function launches on the given
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

// What a launch computes: the projection at phi (factorize_project), the
// draw and the rank-1 update (draw_update), or the log-determinants alone.
enum Mode { kProject = 0, kDraw = 1, kLogdets = 2 };

__device__ __forceinline__ int tri_off(int j, int m) {
  // offset of column j's diagonal in a column-major packed lower triangle
  return j * m - (j * (j - 1)) / 2;
}

struct Args {
  const float* S;       // (rows, n_in)
  const int* anc;       // (n_out,) sorted ancestors, or nullptr = identity
  const float* phi;     // (m, n_out); unused by kLogdets
  const float* u;       // (n, n_out) raw uniforms (draw only)
  const float* v;       // (n, n_out)
  const float* prior;   // [P0 | P1 | P2] or nullptr
  int n_in, n_out, m, n;
  float jitter, lam, p3;
  // factorize/project outputs
  float* mean;          // (n, n_out)
  float* col;           // (n_out,)
  float* row;           // (n, n, n_out)
  // draw/update outputs
  float* S_new;         // (rows, n_out)
  float* y;             // (n, n_out)
  float* ld;            // (2, n_out): logdet_T1, logdet_Psi
};

template <int MAXM, int MODE>
__global__ void __launch_bounds__(kThreads)
packed_mniw_kernel(const Args a) {
  constexpr bool DRAW = MODE == kDraw;
  constexpr bool PHI = MODE != kLogdets;
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.n_out) return;
  const int m = a.m, n = a.n;
  const int64_t n_in = a.n_in, n_out = a.n_out;
  const int src = a.anc ? a.anc[j] : j;
  const float* Sc = a.S + src;  // element r of this column: Sc[r * n_in]
  const int o1 = m * n;
  const int o2 = o1 + m * (m + 1) / 2;
  const int o3 = o2 + n * (n + 1) / 2;
  const float lam = a.lam;
  const float* P0 = a.prior;
  const float* P1 = a.prior ? a.prior + m * n : nullptr;
  const float* P2 = a.prior ? a.prior + m * n + m * m : nullptr;

  float phi[MAXM];
  if constexpr (PHI) {
    for (int i = 0; i < m; ++i) phi[i] = a.phi[i * n_out + j];
  }

  // A = P1 + lam*T1 (T1 stored once per symmetric pair, so sym() is exact)
  float L[MAXM * (MAXM + 1) / 2];
  float trace = 0.f;
  for (int c = 0; c < m; ++c) {
    for (int i = c; i < m; ++i) {
      const int k = tri_off(c, m) + i - c;
      const float raw = Sc[(o1 + k) * n_in];
      if constexpr (DRAW) a.S_new[(o1 + k) * n_out + j] = raw * lam + phi[i] * phi[c];
      float aij = raw * lam;
      if (P1) aij += __ldg(P1 + i * m + c);
      L[k] = aij;
      if (i == c) trace += aij;
    }
  }
  if (a.jitter != 0.f) {
    const float bump = (a.jitter / m) * trace;
    for (int c = 0; c < m; ++c) L[tri_off(c, m)] += bump;
  }

  // left-looking Cholesky, column by column: L[:, c] = s * rsqrt(s_cc)
  float half_ld = 0.f;
  for (int c = 0; c < m; ++c) {
    const int oc = tri_off(c, m);
    for (int i = c; i < m; ++i) {
      float s = L[oc + i - c];
      for (int k = 0; k < c; ++k) {
        const int ok = tri_off(k, m);
        s -= L[ok + i - k] * L[ok + c - k];
      }
      L[oc + i - c] = s;
    }
    const float inv = rsqrtf(L[oc]);
    for (int i = c; i < m; ++i) L[oc + i - c] *= inv;
    half_ld += logf(L[oc]);
  }

  // white = L^{-1}(P0 + lam*T0) and v = L^{-1} phi, one forward pass
  float t0raw[MAXM * 2];
  float white[MAXM * 2];
  float vv[MAXM];
  for (int i = 0; i < m; ++i) {
    const float d = L[tri_off(i, m)];
    for (int c = 0; c < n; ++c) {
      const float raw = Sc[(i * n + c) * n_in];
      t0raw[i * n + c] = raw;
      float acc = raw * lam;
      if (P0) acc += __ldg(P0 + i * n + c);
      for (int k = 0; k < i; ++k) acc -= L[tri_off(k, m) + i - k] * white[k * 2 + c];
      white[i * 2 + c] = acc / d;
    }
    if constexpr (PHI) {
      float acc = phi[i];
      for (int k = 0; k < i; ++k) acc -= L[tri_off(k, m) + i - k] * vv[k];
      vv[i] = acc / d;
    }
  }

  // Psi = P2 + lam*T2 - white^T white, with T2 read as a packed triangle
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
      for (int k = 0; k < m; ++k) acc -= white[k * 2 + a_] * white[k * 2 + b];
      psi[a_][b] = acc;
    }
  }
  float logdet_psi;
  if (n == 1) {
    logdet_psi = logf(psi[0][0]);
  } else {
    const float off = 0.5f * (psi[0][1] + psi[1][0]);
    logdet_psi = logf(psi[0][0] * psi[1][1] - off * off);
  }

  a.ld[j] = 2.f * half_ld;
  a.ld[n_out + j] = logdet_psi;
  if constexpr (MODE == kLogdets) return;

  float mean[2];
  for (int c = 0; c < n; ++c) {
    float acc = 0.f;
    for (int k = 0; k < m; ++k) acc += white[k * 2 + c] * vv[k];
    mean[c] = acc;
  }
  float colv = 0.f;
  for (int k = 0; k < m; ++k) colv += vv[k] * vv[k];
  colv += 1.f;

  if constexpr (MODE == kProject) {
    for (int c = 0; c < n; ++c) a.mean[c * n_out + j] = mean[c];
    a.col[j] = colv;
    for (int a_ = 0; a_ < n; ++a_)
      for (int b = 0; b < n; ++b) a.row[(a_ * n + b) * n_out + j] = psi[a_][b];
    return;
  }

  // matrix-t draw: df_pred = lam*T3 + p3 + 1 - n, polar Student-t from the
  // raw uniforms (w = 1 - u keeps w^{-2/df} finite)
  const float t3raw = Sc[o3 * n_in];
  const float df_pred = t3raw * lam + a.p3 + (1.f - n);
  float t[2];
  for (int c = 0; c < n; ++c) {
    const float w = 1.f - a.u[c * n_out + j];
    const float r = sqrtf(df_pred * expm1f(-(2.f / df_pred) * logf(w)));
    t[c] = r * cospif(2.f * a.v[c * n_out + j]);
  }
  const float inv_df = 1.f / df_pred;
  float scaled[2];
  if (n == 1) {
    scaled[0] = sqrtf(psi[0][0] * inv_df) * t[0];
  } else {
    const float l00 = sqrtf(psi[0][0] * inv_df);
    const float l10 = 0.5f * (psi[0][1] + psi[1][0]) * inv_df / l00;
    const float l11 = sqrtf(psi[1][1] * inv_df - l10 * l10);
    scaled[0] = l00 * t[0];
    scaled[1] = l10 * t[0] + l11 * t[1];
  }
  const float sqrt_col = sqrtf(colv);
  float yv[2];
  for (int c = 0; c < n; ++c) {
    yv[c] = mean[c] + scaled[c] * sqrt_col;
    a.y[c * n_out + j] = yv[c];
  }

  // rank-1 update of the raw statistics (the prior never enters the carry)
  for (int i = 0; i < m; ++i)
    for (int c = 0; c < n; ++c)
      a.S_new[(i * n + c) * n_out + j] = t0raw[i * n + c] * lam + phi[i] * yv[c];
  for (int b = 0; b < n; ++b)
    for (int a_ = b; a_ < n; ++a_) {
      const int k = tri_off(b, n) + a_ - b;
      a.S_new[(o2 + k) * n_out + j] = t2raw[k] * lam + yv[a_] * yv[b];
    }
  a.S_new[o3 * n_out + j] = t3raw * lam + 1.f;
}

template <int MODE>
int launch(const Args& a, cudaStream_t stream) {
  if (a.m < 1 || a.m > 48 || a.n < 1 || a.n > 2) return (int)cudaErrorInvalidValue;
  if (a.n_out == 0) return (int)cudaGetLastError();
  const dim3 grid((a.n_out + kThreads - 1) / kThreads);
  if (a.m <= 24) {
    packed_mniw_kernel<24, MODE><<<grid, kThreads, 0, stream>>>(a);
  } else {
    packed_mniw_kernel<48, MODE><<<grid, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int bipk_factorize_project_packed(
    const float* S, const float* phi, const float* prior, int n_particles,
    int m, int n, float jitter, float lam, float* mean, float* col,
    float* row, float* ld, void* stream) {
  Args a = {};
  a.S = S; a.anc = nullptr; a.phi = phi; a.prior = prior;
  a.n_in = n_particles; a.n_out = n_particles; a.m = m; a.n = n;
  a.jitter = jitter; a.lam = lam;
  a.mean = mean; a.col = col; a.row = row; a.ld = ld;
  return launch<kProject>(a, static_cast<cudaStream_t>(stream));
}

extern "C" int bipk_draw_update_packed(
    const float* S, int n_in, const int* anc, int n_out, const float* phi,
    const float* u, const float* v, const float* prior, float p3, int m,
    int n, float jitter, float lam, float* S_new, float* y, float* ld,
    void* stream) {
  Args a = {};
  a.S = S; a.anc = anc; a.phi = phi; a.u = u; a.v = v; a.prior = prior;
  a.n_in = n_in; a.n_out = n_out; a.m = m; a.n = n;
  a.jitter = jitter; a.lam = lam; a.p3 = p3;
  a.S_new = S_new; a.y = y; a.ld = ld;
  return launch<kDraw>(a, static_cast<cudaStream_t>(stream));
}

extern "C" int bipk_log_base_measure_packed(
    const float* S, const float* prior, int n_particles, int m, int n,
    float jitter, float* ld, void* stream) {
  Args a = {};
  a.S = S; a.anc = nullptr; a.phi = nullptr; a.prior = prior;
  a.n_in = n_particles; a.n_out = n_particles; a.m = m; a.n = n;
  a.jitter = jitter; a.lam = 1.f; a.ld = ld;
  return launch<kLogdets>(a, static_cast<cudaStream_t>(stream));
}
