// The per-particle MNIW column core shared by packed_mniw.cu,
// dedup_gather.cu and unpacked_mniw.cu: one thread factors prior + lam *
// sym(T1) of its particle's statistics and, by MODE, projects, draws +
// updates, emits the factor, writes the factor whole, or stops at the
// log-determinants. A reader says where the statistics live: PackedStats
// for a column of the packed layout (element r at Sc[r * stride], global
// memory with stride n_in or a column staged in shared memory),
// UnpackedStats for structured or flat T0, T1, T2 leaves. See
// packed_mniw.cu for the layout and the design.

#pragma once

#include <assert.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bipk_mniw {

constexpr int kThreads = 128;

// What a launch computes: the projection at phi (factorize_project), the
// draw and the rank-1 update (draw_update), the log-determinants alone, or
// the projection plus the factor LW (factorize_project with emit_factor),
// or the factor itself, chol / white / row (factorize_blocks), or the
// draw and the update with the factor read from LW (the factor-gather
// draw; a mode of the warp kernel only, warp_mniw.cu).
enum Mode { kProject = 0, kDraw = 1, kLogdets = 2, kEmit = 3, kFactor = 4, kReuse = 5 };

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
  const float* lw;      // kReuse input LW (m(m+1)/2 + m*n, n_in)
  const float* T0;      // unpacked statistics (m*n, n_in), (m*m, n_in),
  const float* T1;      //   (n*n, n_in): structured (m, n, N) etc. or
  const float* T2;      //   flat (m*n, N) etc., the same memory
  int n_in, n_out, m, n;
  float jitter, lam, p3;
  // factorize/project outputs
  float* mean;          // (n, n_out)
  float* col;           // (n_out,)
  float* row;           // (n, n, n_out)
  float* lw_out;        // kEmit: LW (m(m+1)/2 + m*n, n_out)
  float* chol;          // kFactor: (m, m, n_out), zeros above the diagonal
  float* white;         // kFactor: (m, n, n_out)
  // draw/update outputs
  float* S_new;         // (rows, n_out)
  float* y;             // (n, n_out)
  float* ld;            // (2, n_out): logdet_T1, logdet_Psi
};

// The column thread j reads: anc[j], range-checked on the device as
// torch's own CUDA index_select does (a failed check traps the kernel and
// the next synchronisation raises), or j itself without ancestors.
__device__ __forceinline__ int source_column(const Args& a, int j) {
  if (!a.anc) return j;
  const int src = a.anc[j];
  assert(src >= 0 && src < a.n_in);
  return src;
}

// lam * s + x * y as the statistics update writes it: lam * s rounded on
// its own, then one fused multiply-add, so the compiler contracts it the
// same way in every kernel and their S_new agree bit for bit
__device__ __forceinline__ float forget_add(float s, float lam, float x, float y) {
  return __fmaf_rn(x, y, __fmul_rn(s, lam));
}

// The statistics of one particle in the packed layout: rows
// [T0 (m*n) | column-major tril(T1) | tril(T2) | T3], element r at
// Sc[r * stride]. T1 and T2 are stored once per symmetric pair, so
// sym() is exact and t1 reads the stored entry.
struct PackedStats {
  const float* Sc;
  int64_t stride;
  int m, n;
  __device__ __forceinline__ float t0(int i, int c) const { return Sc[(i * n + c) * stride]; }
  // T1[i][c], i >= c, stored at packed row m*n + k
  __device__ __forceinline__ float t1(int i, int c, int k) const {
    return Sc[(m * n + k) * stride];
  }
  __device__ __forceinline__ float t2(int a_, int b) const {
    const int lo = a_ < b ? a_ : b, hi = a_ < b ? b : a_;
    return Sc[(m * n + m * (m + 1) / 2 + tri_off(lo, n) + hi - lo) * stride];
  }
  __device__ __forceinline__ float t3() const {
    return Sc[(m * n + m * (m + 1) / 2 + n * (n + 1) / 2) * stride];
  }
};

// The statistics of one particle as full leaves, structured (m, n, N),
// (m, m, N), (n, n, N) or flat (m*n, N), (m*m, N), (n*n, N) -- the same
// memory -- each pointer at the particle's column, row stride `stride`.
// T1 is read as 0.5 * (T1[i][c] + T1[c][i]) (the JAX kernels' _make_read_a),
// which is T1[i][c] itself, bit for bit, on exactly symmetric input; T2
// is read as stored, as the JAX kernels read it.
struct UnpackedStats {
  const float* T0;
  const float* T1;
  const float* T2;
  int64_t stride;
  int m, n;
  __device__ __forceinline__ float t0(int i, int c) const { return T0[(i * n + c) * stride]; }
  __device__ __forceinline__ float t1(int i, int c, int) const {
    return 0.5f * (T1[(i * m + c) * stride] + T1[(c * m + i) * stride]);
  }
  __device__ __forceinline__ float t2(int a_, int b) const { return T2[(a_ * n + b) * stride]; }
};

__device__ __forceinline__ float logdet_psi_of(const float psi[2][2], int n) {
  if (n == 1) return logf(psi[0][0]);
  const float off = 0.5f * (psi[0][1] + psi[1][0]);
  return logf(psi[0][0] * psi[1][1] - off * off);
}

// matrix-t draw y = mean + chol(Psi / df_pred) t sqrt(col), written to
// a.y: df_pred = lam*T3 + p3 + 1 - n, polar Student-t from the raw
// uniforms (w = 1 - u keeps w^{-2/df} finite)
__device__ __forceinline__ void matrix_t_draw(
    const Args& a, int j, float df_pred, const float psi[2][2],
    const float mean[2], float colv, float yv[2]) {
  const int n = a.n;
  const int64_t n_out = a.n_out;
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
  for (int c = 0; c < n; ++c) {
    yv[c] = mean[c] + scaled[c] * sqrt_col;
    a.y[c * n_out + j] = yv[c];
  }
}

// One particle: thread j, output column j, its statistics read through
// `rd` (PackedStats or UnpackedStats; the draw reads PackedStats only).
template <int MAXM, int MODE, class Reader>
__device__ __forceinline__ void mniw_core(const Args& a, int j, const Reader& rd) {
  constexpr bool DRAW = MODE == kDraw;
  constexpr bool PHI = MODE != kLogdets && MODE != kFactor;
  constexpr bool PROJECT = MODE == kProject || MODE == kEmit;
  const int m = a.m, n = a.n;
  const int64_t n_out = a.n_out;
  const int o1 = m * n;
  const int o2 = o1 + m * (m + 1) / 2;
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
      const float raw = rd.t1(i, c, k);
      if constexpr (DRAW) a.S_new[(o1 + k) * n_out + j] = forget_add(raw, lam, phi[i], phi[c]);
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
    if constexpr (MODE != kFactor) half_ld += logf(L[oc]);
  }

  // white = L^{-1}(P0 + lam*T0) and v = L^{-1} phi, one forward pass
  float t0raw[MAXM * 2];
  float white[MAXM * 2];
  float vv[MAXM];
  for (int i = 0; i < m; ++i) {
    const float d = L[tri_off(i, m)];
    for (int c = 0; c < n; ++c) {
      const float raw = rd.t0(i, c);
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

  // the factor for the factor-reusing draw, in the JAX layout: rows
  // [tril(L) row-major, row i(i+1)/2 + k | white, row tri + i*n + c]
  if constexpr (MODE == kEmit) {
    const int tri = m * (m + 1) / 2;
    for (int i = 0; i < m; ++i) {
      for (int k = 0; k <= i; ++k)
        a.lw_out[(i * (i + 1) / 2 + k) * n_out + j] = L[tri_off(k, m) + i - k];
    }
    for (int i = 0; i < m; ++i)
      for (int c = 0; c < n; ++c) a.lw_out[(tri + i * n + c) * n_out + j] = white[i * 2 + c];
  }

  // the factor whole, as the JAX _factorize_kernel writes it
  if constexpr (MODE == kFactor) {
    for (int i = 0; i < m; ++i)
      for (int k = 0; k < m; ++k)
        a.chol[(i * m + k) * n_out + j] = k <= i ? L[tri_off(k, m) + i - k] : 0.f;
    for (int i = 0; i < m; ++i)
      for (int c = 0; c < n; ++c) a.white[(i * n + c) * n_out + j] = white[i * 2 + c];
  }

  // Psi = P2 + lam*T2 - white^T white
  float t2raw[2][2];
  float psi[2][2];
  for (int a_ = 0; a_ < n; ++a_)
    for (int b = 0; b < n; ++b) t2raw[a_][b] = rd.t2(a_, b);
  for (int a_ = 0; a_ < n; ++a_) {
    for (int b = 0; b < n; ++b) {
      float acc = t2raw[a_][b] * lam;
      if (P2) acc += __ldg(P2 + a_ * n + b);
      for (int k = 0; k < m; ++k) acc -= white[k * 2 + a_] * white[k * 2 + b];
      psi[a_][b] = acc;
    }
  }
  if constexpr (MODE == kFactor) {
    for (int a_ = 0; a_ < n; ++a_)
      for (int b = 0; b < n; ++b) a.row[(a_ * n + b) * n_out + j] = psi[a_][b];
    return;
  }
  const float logdet_psi = logdet_psi_of(psi, n);

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

  if constexpr (PROJECT) {
    for (int c = 0; c < n; ++c) a.mean[c * n_out + j] = mean[c];
    a.col[j] = colv;
    for (int a_ = 0; a_ < n; ++a_)
      for (int b = 0; b < n; ++b) a.row[(a_ * n + b) * n_out + j] = psi[a_][b];
    return;
  }

  if constexpr (DRAW) {
    const float t3raw = rd.t3();
    float yv[2];
    matrix_t_draw(a, j, t3raw * lam + a.p3 + (1.f - n), psi, mean, colv, yv);

    // rank-1 update of the raw statistics (the prior never enters the carry)
    for (int i = 0; i < m; ++i)
      for (int c = 0; c < n; ++c)
        a.S_new[(i * n + c) * n_out + j] = forget_add(t0raw[i * n + c], lam, phi[i], yv[c]);
    for (int b = 0; b < n; ++b)
      for (int a_ = b; a_ < n; ++a_) {
        const int k = tri_off(b, n) + a_ - b;
        a.S_new[(o2 + k) * n_out + j] = forget_add(t2raw[a_][b], lam, yv[a_], yv[b]);
      }
    a.S_new[(o2 + n * (n + 1) / 2) * n_out + j] = forget_add(t3raw, lam, 1.f, 1.f);
  }
}

// The core on a column of the packed layout at Sc, row stride `stride`.
template <int MAXM, int MODE>
__device__ __forceinline__ void mniw_column(
    const Args& a, int j, const float* Sc, int64_t stride) {
  mniw_core<MAXM, MODE>(a, j, PackedStats{Sc, stride, a.m, a.n});
}

}  // namespace bipk_mniw
