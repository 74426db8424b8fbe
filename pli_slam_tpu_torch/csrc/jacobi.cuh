// Float64 arithmetic shared by the port's Jacobi kernels (csrc/svd_small.cu,
// csrc/eig4.cu, csrc/rot3.cu's float64 branch): reciprocal square roots
// without IEEE division or sqrt on the card, the plane rotation of a
// symmetric 2x2, and one-sided Jacobi's rotation with LAPACK's test.
//
// Float64 sqrt and division are IEEE's on the card only through a slow-path
// subroutine, whose calling convention gives a kernel a stack frame and
// spills; `root` and `inv_root` instead refine the hardware's approximation
// by Newton steps, and `plane_rotation` is written with reciprocal square
// roots alone. On a host (no __CUDA_ARCH__) they are IEEE's, so the
// kernels' arithmetic compiles as plain C++ and can be held against a numpy
// transcription bit for bit.

#pragma once

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define JACOBI_FN __host__ __device__ __forceinline__
#else
#include <cmath>
#define JACOBI_FN inline
#endif

namespace jacobi {

constexpr double kEps = 2.220446049250313e-16;    // float64 machine epsilon
constexpr double kTiny = 2.2250738585072014e-308;  // the least normal float64

// 1 / sqrt of a positive normal float64, and sqrt (`root` gives 0 below the
// least normal: a square root under 1.5e-154, zero to float32). On the card
// from the hardware's approximations (MUFU), refined by Newton steps in
// fma: within an ulp or two of IEEE's. On a host, IEEE's.
JACOBI_FN double inv_root(double x) {
#ifdef __CUDA_ARCH__
  double y;
  asm("rsqrt.approx.ftz.f64 %0, %1;" : "=d"(y) : "d"(x));
  const double hx = 0.5 * x;
#pragma unroll
  for (int i = 0; i < 2; ++i) y = fma(y, fma(-hx * y, y, 0.5), y);  // ~2^-22 -> ~2^-44 -> float64's rounding
  return y;
#else
  return 1.0 / sqrt(x);
#endif
}

JACOBI_FN double root(double x) {
#ifdef __CUDA_ARCH__
  const double y = inv_root(x), r = x * y;
  return x >= kTiny ? fma(fma(-r, r, x), 0.5 * y, r) : 0.0;  // the approximations flush subnormals to zero
#else
  return sqrt(x);
#endif
}

// The Jacobi rotation of [[alpha, gamma], [gamma, beta]]: (cs, sn) with
// p' = cs p - sn q, q' = sn p + cs q zeroing gamma, |angle| <= pi / 4, and
// x = d^2 + g^2 (d = beta - alpha, g = 2 gamma; the caller's tests read it).
// t = tan(angle) = sign(zeta) / (|zeta| + sqrt(1 + zeta^2)), zeta = d / g, is
// sign(d) g / D with h = sqrt(d^2 + g^2), D = |d| + h; and 1 + t^2 = 2 h / D,
// so cs = D / sqrt(2 h D), sn = sign(d) g / sqrt(2 h D): two reciprocal square
// roots of positive normal numbers, and no zeta^2 to overflow. `hr` gets
// 2 h / sqrt(2 h D), so that t = sn * hr (1 / D = 2 h / (2 h D)). Where x is
// not a positive normal number the results are not numbers: the caller
// tests and selects the identity.
JACOBI_FN void plane_rotation(double alpha, double beta, double gamma, double* cs, double* sn, double* x,
                              double* hr) {
  const double d = beta - alpha, g = 2.0 * gamma;
  *x = d * d + g * g;
  const double h = *x * inv_root(*x), D = fabs(d) + h, r = inv_root(2.0 * h * D);
  *cs = D * r;
  *sn = (d >= 0.0 ? g : -g) * r;
  *hr = 2.0 * h * r;
}

// One-sided Jacobi: the rotation of columns (b_p, b_q) from their summed
// (alpha, beta, gamma) = (|b_p|^2, |b_q|^2, b_p . b_q): whether it rotates,
// and (cs, sn), the identity where it does not. Computed whole and
// then selected, so that the test's latency hides under the roots'.
JACOBI_FN bool rotation(const double* sums, double tol2, double* cs, double* sn) {
  const double alpha = sums[0], beta = sums[1], gamma = sums[2];
  double c, t, x, hr;
  plane_rotation(alpha, beta, gamma, &c, &t, &x, &hr);
  // LAPACK's test, squared: gamma^2 > n eps^2 alpha beta. A column whose
  // squared norm is below the least normal float64 is zero to it, and
  // LAPACK's gesvj skips a column of zero norm: rotating it goes on,
  // shrinking it by ~eps a sweep, until it underflows. Below that, too,
  // d^2 + g^2 would leave the normal range; and a subnormal angle is below
  // float64's resolution.
  const bool ok = gamma * gamma > tol2 * alpha * beta &&
                  fmin(fmin(alpha, beta), fmin(fabs(gamma), x)) >= kTiny && fabs(t) >= kTiny;
  *cs = ok ? c : 1.0;
  *sn = ok ? t : 0.0;
  return ok;
}

}  // namespace jacobi
