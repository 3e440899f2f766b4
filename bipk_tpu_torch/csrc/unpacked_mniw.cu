// Per-particle MNIW factorization, projection and log-determinants over
// UNPACKED batch-last statistics, and the projection from a given factor,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels of bipk_tpu/ops/pallas_kernels.py:
//   - factorize_blocks (:1583) -> _factorize_kernel (:299): chol =
//     chol(P1 + lam*sym(T1) + jitter*tr/m*I), written whole (zeros above
//     the diagonal), white = L^{-1}(P0 + lam*T0), row = P2 + lam*T2 -
//     white^T white;
//   - factorize_project_blocks (:1634) -> _factorize_project_kernel (:468),
//     core _factorize_project_core (:371): the same factor projected at
//     phi, only the small outputs written (mean, col, row, logdet_T1,
//     logdet_Psi);
//   - log_base_measure_logdets (:2000) -> _log_base_measure_kernel (:1530):
//     logdet sym(T1) and logdet Psi at lam = 1, no prior;
//   - project_blocks (:1712) -> _project_kernel (:352): from a given factor
//     (chol, white), v = L^{-1} phi, mean = white^T v, col = v.v + 1.
//
// Layout. T0, T1, T2 are structured (m, n, N), (m, m, N), (n, n, N) or flat
// (m*n, N), (m*m, N), (n*n, N): the same row-major memory with the particle
// index fastest, so a warp reads one entry of 32 particles as one coalesced
// line. The prior is one f32 buffer [P0 | P1 | P2], read through the
// read-only cache, as in packed_mniw.cu.
//
// Design. The factorization, the factorization/projection and the
// log-determinants run the warp kernel (warp_mniw.cu) in its unpacked
// modes, kFactor, kProjectUnpacked and kLogdetsUnpacked (the last at
// lam = 1, no prior): a block stages the packed tile of its P particles from the
// leaves (T1 read as 0.5 * (T1[i][c] + T1[c][i]) in the packed order,
// then scaled by lam and P1 added, the order of the JAX kernels'
// _make_read_a; T2 as stored) and factors each particle on 16 or 32 lanes
// of a warp, two particles per warp at m <= 24, one above; kFactor's block
// writes chol, white and row out by rows of P particles. They replaced the
// packed kernels' per-thread column core (packed_mniw.cuh) with the
// UnpackedStats reader, unpacked_mniw_kernel<24 | 48, kFactor | kProject |
// kLogdets>, one thread per particle, which stays compiled as their
// comparator behind bipk_factorize_blocks_per_thread,
// bipk_factorize_project_blocks_per_thread and
// bipk_log_base_measure_logdets_per_thread (no wrapper reaches them); the
// warp modes equal it bit for bit (chip_smoke.py phase 18,
// tests/test_torch_unpacked_rehearsal.py). On exactly symmetric input
// 0.5 * (x + x) = x, so the projection of unpack(S) is, bit for bit, the
// packed projection of S, and the log-determinants of unpack(S) are the
// packed ones (kLogdets) of S. The JAX package's tiled #10 and #12 stop
// at m = 24; these serve m <= 48 and compute the same function.
//
// The projection from a given factor reads it through element strides
// with the particle stride 1: in the rank-1 cSMC, chol = F[:m, :m] and
// white = F[m:, :m]^T are views of the augmented factor F (p, p, N), read
// in place (a copy of chol alone would move 16.4 MB per call at m = 20,
// N = 10240). It reads only the lower triangle of chol. The wrapper's entry
// (bipk_project_blocks) launches the warp kernel's kFromFactor mode
// (warp_mniw.cu): a block stages tril(chol), white and phi of its P
// particles through the strides (each row P neighbouring floats) and
// substitutes across a particle's lanes, m dependent steps instead of
// m(m+1)/2; two particles per warp at m <= 24, one above. project_kernel
// (one thread per particle, v in a per-thread array) is what it launched
// before; it stays compiled as the comparator behind
// bipk_project_blocks_per_thread, which no wrapper reaches, and the warp
// mode equals it bit for bit (chip_smoke.py phase 18).
//
// What bounds them on the H100 at m = 20, n = 1: bytes in principle
// (factorize ~842 floats per particle in and out, 33 us at N = 32768;
// factorize/project ~446, 17 us; log-determinants ~423, 17 us; project
// ~252, 10 us), against a few kflop per particle. In practice, as for the
// packed kernels, the per-thread factor sits in local memory and the
// Cholesky's dependent loads bound the per-thread kernels;
// project_kernel's m^2/2 dependent loads of chol are global ones, each
// feeding one serial FMA chain; the warp modes issue the instructions of
// each particle's column-by-column Cholesky (warp_mniw.cu). Times: PERF.md.
//
// C interface (loaded with ctypes): every function launches on the given
// stream, never synchronises, allocates nothing, and returns
// cudaGetLastError() so the caller can raise on a refused launch.

#include "packed_mniw.cuh"

using namespace bipk_mniw;

namespace {

template <int MAXM, int MODE>
__global__ void __launch_bounds__(kThreads)
unpacked_mniw_kernel(const Args a) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= a.n_out) return;
  mniw_core<MAXM, MODE>(a, j, UnpackedStats{a.T0 + j, a.T1 + j, a.T2 + j, a.n_in, a.m, a.n});
}

struct ProjectArgs {
  const float* chol;    // element (i, k) of particle j at chol[i*cs_i + k*cs_k + j]
  const float* white;   // element (k, c) at white[k*ws_k + c*ws_c + j]
  const float* phi;     // (m, N)
  int64_t cs_i, cs_k, ws_k, ws_c;
  int N, m, n;
  float* mean;          // (n, N)
  float* col;           // (N,)
};

template <int MAXM>
__global__ void __launch_bounds__(kThreads)
project_kernel(const ProjectArgs p) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= p.N) return;
  const int m = p.m, n = p.n;
  const int64_t N = p.N;
  // v = L^{-1} phi, the core's forward substitution
  float vv[MAXM];
  for (int i = 0; i < m; ++i) {
    const float* Li = p.chol + i * p.cs_i + j;
    float acc = p.phi[i * N + j];
    for (int k = 0; k < i; ++k) acc -= Li[k * p.cs_k] * vv[k];
    vv[i] = acc / Li[i * p.cs_k];
  }
  for (int c = 0; c < n; ++c) {
    const float* Wc = p.white + c * p.ws_c + j;
    float acc = 0.f;
    for (int k = 0; k < m; ++k) acc += Wc[k * p.ws_k] * vv[k];
    p.mean[c * N + j] = acc;
  }
  float colv = 0.f;
  for (int k = 0; k < m; ++k) colv += vv[k] * vv[k];
  p.col[j] = colv + 1.f;
}

bool bad_shape(int m, int n) { return m < 1 || m > 48 || n < 1 || n > 2; }

template <int MODE>
int launch(const Args& a, cudaStream_t stream) {
  if (bad_shape(a.m, a.n)) return (int)cudaErrorInvalidValue;
  if (a.n_out == 0) return (int)cudaGetLastError();
  const dim3 grid((a.n_out + kThreads - 1) / kThreads);
  if (a.m <= 24) {
    unpacked_mniw_kernel<24, MODE><<<grid, kThreads, 0, stream>>>(a);
  } else {
    unpacked_mniw_kernel<48, MODE><<<grid, kThreads, 0, stream>>>(a);
  }
  return (int)cudaGetLastError();
}

Args unpacked_args(const float* T0, const float* T1, const float* T2,
                   const float* prior, int n_particles, int m, int n,
                   float jitter, float lam) {
  Args a = {};
  a.T0 = T0; a.T1 = T1; a.T2 = T2; a.prior = prior;
  a.n_in = n_particles; a.n_out = n_particles; a.m = m; a.n = n;
  a.jitter = jitter; a.lam = lam;
  return a;
}

Args factor_args(const float* T0, const float* T1, const float* T2, const float* prior,
                 int n_particles, int m, int n, float jitter, float lam, float* chol,
                 float* white, float* row) {
  Args a = unpacked_args(T0, T1, T2, prior, n_particles, m, n, jitter, lam);
  a.chol = chol; a.white = white; a.row = row;
  return a;
}

Args factor_project_args(const float* T0, const float* T1, const float* T2, const float* phi,
                         const float* prior, int n_particles, int m, int n, float jitter,
                         float lam, float* mean, float* col, float* row, float* ld) {
  Args a = unpacked_args(T0, T1, T2, prior, n_particles, m, n, jitter, lam);
  a.phi = phi; a.mean = mean; a.col = col; a.row = row; a.ld = ld;
  return a;
}

Args logdets_args(const float* T0, const float* T1, const float* T2, int n_particles, int m,
                  int n, float jitter, float* ld) {
  Args a = unpacked_args(T0, T1, T2, nullptr, n_particles, m, n, jitter, 1.f);
  a.ld = ld;
  return a;
}

}  // namespace

extern "C" int bipk_factorize_blocks(
    const float* T0, const float* T1, const float* T2, const float* prior,
    int n_particles, int m, int n, float jitter, float lam, float* chol,
    float* white, float* row, void* stream) {
  return launch_warp_mniw(
      factor_args(T0, T1, T2, prior, n_particles, m, n, jitter, lam, chol, white, row), kFactor,
      static_cast<cudaStream_t>(stream));
}

// The comparator of the warp kernel's kFactor mode: the per-thread
// unpacked_mniw_kernel<24 | 48, kFactor>, which chip_smoke.py calls and no
// wrapper does.
extern "C" int bipk_factorize_blocks_per_thread(
    const float* T0, const float* T1, const float* T2, const float* prior,
    int n_particles, int m, int n, float jitter, float lam, float* chol,
    float* white, float* row, void* stream) {
  return launch<kFactor>(
      factor_args(T0, T1, T2, prior, n_particles, m, n, jitter, lam, chol, white, row),
      static_cast<cudaStream_t>(stream));
}

extern "C" int bipk_factorize_project_blocks(
    const float* T0, const float* T1, const float* T2, const float* phi,
    const float* prior, int n_particles, int m, int n, float jitter,
    float lam, float* mean, float* col, float* row, float* ld, void* stream) {
  return launch_warp_mniw(factor_project_args(T0, T1, T2, phi, prior, n_particles, m, n, jitter,
                                              lam, mean, col, row, ld),
                          kProjectUnpacked, static_cast<cudaStream_t>(stream));
}

// The comparator of the warp kernel's kProjectUnpacked mode: the
// per-thread unpacked_mniw_kernel<24 | 48, kProject>, which chip_smoke.py
// calls and no wrapper does.
extern "C" int bipk_factorize_project_blocks_per_thread(
    const float* T0, const float* T1, const float* T2, const float* phi,
    const float* prior, int n_particles, int m, int n, float jitter,
    float lam, float* mean, float* col, float* row, float* ld, void* stream) {
  return launch<kProject>(factor_project_args(T0, T1, T2, phi, prior, n_particles, m, n, jitter,
                                              lam, mean, col, row, ld),
                          static_cast<cudaStream_t>(stream));
}

extern "C" int bipk_log_base_measure_logdets(
    const float* T0, const float* T1, const float* T2, int n_particles,
    int m, int n, float jitter, float* ld, void* stream) {
  return launch_warp_mniw(logdets_args(T0, T1, T2, n_particles, m, n, jitter, ld),
                          kLogdetsUnpacked, static_cast<cudaStream_t>(stream));
}

// The comparator of the warp kernel's kLogdetsUnpacked mode: the
// per-thread unpacked_mniw_kernel<24 | 48, kLogdets>, which chip_smoke.py
// calls and no wrapper does.
extern "C" int bipk_log_base_measure_logdets_per_thread(
    const float* T0, const float* T1, const float* T2, int n_particles,
    int m, int n, float jitter, float* ld, void* stream) {
  return launch<kLogdets>(logdets_args(T0, T1, T2, n_particles, m, n, jitter, ld),
                          static_cast<cudaStream_t>(stream));
}

extern "C" int bipk_project_blocks(
    const float* chol, long long cs_i, long long cs_k, const float* white,
    long long ws_k, long long ws_c, const float* phi, int n_particles, int m,
    int n, float* mean, float* col, void* stream) {
  Args a = {};
  a.chol_in = chol; a.white_in = white; a.phi = phi;
  a.cs_i = cs_i; a.cs_k = cs_k; a.ws_k = ws_k; a.ws_c = ws_c;
  a.n_in = n_particles; a.n_out = n_particles; a.m = m; a.n = n;
  a.mean = mean; a.col = col;
  return launch_warp_mniw(a, kFromFactor, static_cast<cudaStream_t>(stream));
}

// The comparator of the warp kernel's kFromFactor mode: the per-thread
// project_kernel<24 | 48>, which chip_smoke.py calls and no wrapper does.
extern "C" int bipk_project_blocks_per_thread(
    const float* chol, long long cs_i, long long cs_k, const float* white,
    long long ws_k, long long ws_c, const float* phi, int n_particles, int m,
    int n, float* mean, float* col, void* stream) {
  if (bad_shape(m, n)) return (int)cudaErrorInvalidValue;
  if (n_particles == 0) return (int)cudaGetLastError();
  const ProjectArgs p = {chol, white, phi, cs_i, cs_k, ws_k, ws_c,
                         n_particles, m, n, mean, col};
  const dim3 grid((n_particles + kThreads - 1) / kThreads);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (m <= 24) {
    project_kernel<24><<<grid, kThreads, 0, s>>>(p);
  } else {
    project_kernel<48><<<grid, kThreads, 0, s>>>(p);
  }
  return (int)cudaGetLastError();
}
