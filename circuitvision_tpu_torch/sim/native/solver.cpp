// Native MNA solver: DC operating point (Newton for diodes) and
// single-frequency complex AC, exposed over a C ABI for ctypes.
//
// The JAX package's sim/native/solver.cpp, copied: the first-party
// replacement for the reference's libngspice dependency (reference:
// src/spice_simulator.py:62-76 drives ngspice through PySpice CFFI).
// Circuit simulation is dense LU on tiny matrices — a host workload — so
// it lives in C++ on the host, not on the card. Built with g++ at first
// use by core/native.build_library (sim/native_backend.py).
//
// Element encoding (parallel arrays, one entry per element):
//   kind:  'R','C','L','V','I','D'
//   n1,n2: 0-based non-ground node indices; -1 = ground
//   v_re, v_im: DC value / AC phasor (re,im) / reactance when flag set
//   flags: bit0 = value is a complex impedance (j-valued C/L)
// Branch rows (V in AC; V and L in DC) are ordered by first appearance,
// matching the Python solver exactly.

#include <cmath>
#include <complex>
#include <cstring>
#include <vector>

namespace {

using cplx = std::complex<double>;

constexpr double kDiodeIs = 1e-14;
constexpr double kDiodeVt = 0.02585;

// SPICE3 pnjlim: limit junction-voltage steps logarithmically above
// vcrit. Clamping the voltage inside the stamp instead makes Newton
// "converge" to a non-solution (the linearization point stops moving
// while the extrapolated current is orders of magnitude off).
inline double pnjlim(double vnew, double vold) {
  static const double vcrit =
      kDiodeVt * std::log(kDiodeVt / (1.4142135623730951 * kDiodeIs));
  if (vnew > vcrit && std::fabs(vnew - vold) > 2.0 * kDiodeVt) {
    if (vold > 0.0) {
      const double arg = 1.0 + (vnew - vold) / kDiodeVt;
      return arg > 0.0 ? vold + kDiodeVt * std::log(arg) : vcrit;
    }
    return kDiodeVt * std::log(vnew / kDiodeVt);
  }
  return vnew;
}

// Dense partial-pivot LU solve, in-place. Returns false when singular.
template <typename T>
bool lu_solve(std::vector<T>& A, std::vector<T>& b, int n) {
  std::vector<int> piv(n);
  for (int i = 0; i < n; ++i) piv[i] = i;
  for (int col = 0; col < n; ++col) {
    int best = col;
    double best_mag = std::abs(A[col * n + col]);
    for (int r = col + 1; r < n; ++r) {
      double m = std::abs(A[r * n + col]);
      if (m > best_mag) { best_mag = m; best = r; }
    }
    if (best_mag < 1e-300) return false;
    if (best != col) {
      for (int c = 0; c < n; ++c) std::swap(A[best * n + c], A[col * n + c]);
      std::swap(b[best], b[col]);
    }
    const T pivot = A[col * n + col];
    for (int r = col + 1; r < n; ++r) {
      const T f = A[r * n + col] / pivot;
      if (f == T(0)) continue;
      A[r * n + col] = T(0);
      for (int c = col + 1; c < n; ++c) A[r * n + c] -= f * A[col * n + c];
      b[r] -= f * b[col];
    }
  }
  for (int r = n - 1; r >= 0; --r) {
    T acc = b[r];
    for (int c = r + 1; c < n; ++c) acc -= A[r * n + c] * b[c];
    b[r] = acc / A[r * n + r];
  }
  return true;
}

template <typename T>
void stamp_g(std::vector<T>& A, int n, int i, int j, T g) {
  if (i >= 0) A[i * n + i] += g;
  if (j >= 0) A[j * n + j] += g;
  if (i >= 0 && j >= 0) {
    A[i * n + j] -= g;
    A[j * n + i] -= g;
  }
}

}  // namespace

extern "C" {

// Returns 0 on success; 1 singular matrix; 2 no convergence.
// out_x has n_nodes voltages followed by n_branches currents.
int cv_solve_dc(int n_elements, const char* kinds, const int* n1,
                const int* n2, const double* value, int n_nodes,
                double gmin, double abstol, double reltol, int max_iters,
                double* out_x, int* out_n_branches) {
  std::vector<int> branch_rows;
  for (int e = 0; e < n_elements; ++e)
    if (kinds[e] == 'V' || kinds[e] == 'L') branch_rows.push_back(e);
  const int m = static_cast<int>(branch_rows.size());
  const int size = n_nodes + m;
  *out_n_branches = m;

  bool has_diode = false;
  for (int e = 0; e < n_elements; ++e) has_diode |= (kinds[e] == 'D');

  std::vector<double> x(size, 0.0);
  // Per-diode linearization voltage, advanced by pnjlim each iteration.
  std::vector<double> vd_state(static_cast<size_t>(n_elements), 0.0);
  bool converged = !has_diode;
  const int iters = has_diode ? max_iters : 1;
  for (int it = 0; it < iters; ++it) {
    std::vector<double> A(static_cast<size_t>(size) * size, 0.0);
    std::vector<double> b(size, 0.0);
    for (int i = 0; i < n_nodes; ++i) A[i * size + i] += gmin;

    for (int e = 0; e < n_elements; ++e) {
      const int i = n1[e], j = n2[e];
      switch (kinds[e]) {
        case 'R':
          stamp_g(A, size, i, j, 1.0 / value[e]);
          break;
        case 'C':
          break;  // open at DC
        case 'I': {
          const double cur = value[e];
          if (i >= 0) b[i] -= cur;
          if (j >= 0) b[j] += cur;
          break;
        }
        case 'D': {
          const double vd = vd_state[e];
          const double ex = std::exp(vd / kDiodeVt);
          const double gd = (kDiodeIs / kDiodeVt) * ex + gmin;
          const double id_lin = kDiodeIs * (ex - 1.0) - gd * vd;
          stamp_g(A, size, i, j, gd);
          if (i >= 0) b[i] -= id_lin;
          if (j >= 0) b[j] += id_lin;
          break;
        }
        default:
          break;  // V/L handled as branches below
      }
    }
    for (int k = 0; k < m; ++k) {
      const int e = branch_rows[k];
      const int i = n1[e], j = n2[e];
      const int row = n_nodes + k;
      if (i >= 0) { A[i * size + row] += 1.0; A[row * size + i] += 1.0; }
      if (j >= 0) { A[j * size + row] -= 1.0; A[row * size + j] -= 1.0; }
      b[row] = (kinds[e] == 'V') ? value[e] : 0.0;
    }

    if (!lu_solve(A, b, size)) return 1;
    if (!has_diode) {
      std::memcpy(out_x, b.data(), sizeof(double) * size);
      return 0;
    }
    double delta = 0.0, ref = 0.0;
    for (int s = 0; s < size; ++s) {
      delta = std::max(delta, std::fabs(b[s] - x[s]));
      ref = std::max(ref, std::fabs(b[s]));
      x[s] = b[s];
    }
    // Advance each diode's linearization point under pnjlim; converged
    // only when the solution AND every junction voltage have settled
    // (a still-limited step means the next stamp changes the system).
    double vd_delta = 0.0;
    for (int e = 0; e < n_elements; ++e) {
      if (kinds[e] != 'D') continue;
      const int i = n1[e], j = n2[e];
      const double vd_new =
          (i >= 0 ? x[i] : 0.0) - (j >= 0 ? x[j] : 0.0);
      const double vd_lim = pnjlim(vd_new, vd_state[e]);
      vd_delta = std::max(vd_delta, std::fabs(vd_lim - vd_state[e]));
      vd_state[e] = vd_lim;
    }
    if (delta <= abstol + reltol * ref &&
        vd_delta <= abstol + reltol * ref) {
      converged = true;
      break;
    }
  }
  if (!converged) return 2;
  std::memcpy(out_x, x.data(), sizeof(double) * size);
  return 0;
}

// flags bit0: complex impedance supplied directly in (v_re, v_im).
// out_x: interleaved re/im — n_nodes voltages then n_branches currents.
int cv_solve_ac(int n_elements, const char* kinds, const int* n1,
                const int* n2, const double* v_re, const double* v_im,
                const int* flags, int n_nodes, double omega, double gmin,
                double* out_x, int* out_n_branches) {
  std::vector<int> branch_rows;
  for (int e = 0; e < n_elements; ++e)
    if (kinds[e] == 'V') branch_rows.push_back(e);
  const int m = static_cast<int>(branch_rows.size());
  const int size = n_nodes + m;
  *out_n_branches = m;

  std::vector<cplx> A(static_cast<size_t>(size) * size, cplx(0, 0));
  std::vector<cplx> b(size, cplx(0, 0));
  for (int i = 0; i < n_nodes; ++i) A[i * size + i] += gmin;

  for (int e = 0; e < n_elements; ++e) {
    const int i = n1[e], j = n2[e];
    const cplx val(v_re[e], v_im[e]);
    const bool is_reactance = flags[e] & 1;
    switch (kinds[e]) {
      case 'R':
        stamp_g(A, size, i, j, cplx(1.0, 0) / val);
        break;
      case 'C':
        if (is_reactance) stamp_g(A, size, i, j, cplx(1.0, 0) / val);
        else stamp_g(A, size, i, j, cplx(0, omega) * val);
        break;
      case 'L':
        if (is_reactance) stamp_g(A, size, i, j, cplx(1.0, 0) / val);
        else stamp_g(A, size, i, j, cplx(1.0, 0) / (cplx(0, omega) * val));
        break;
      case 'I':
        if (i >= 0) b[i] -= val;
        if (j >= 0) b[j] += val;
        break;
      case 'D':
        stamp_g(A, size, i, j, cplx(gmin, 0));
        break;
      default:
        break;
    }
  }
  for (int k = 0; k < m; ++k) {
    const int e = branch_rows[k];
    const int i = n1[e], j = n2[e];
    const int row = n_nodes + k;
    if (i >= 0) { A[i * size + row] += 1.0; A[row * size + i] += 1.0; }
    if (j >= 0) { A[j * size + row] -= 1.0; A[row * size + j] -= 1.0; }
    b[row] = cplx(v_re[e], v_im[e]);
  }

  if (!lu_solve(A, b, size)) return 1;
  for (int s = 0; s < size; ++s) {
    out_x[2 * s] = b[s].real();
    out_x[2 * s + 1] = b[s].imag();
  }
  return 0;
}

}  // extern "C"
