// Closest rotation of a batch of 3x3 matrices for Hopper (sm_90a).
//
// The port's own kernel: it has no TPU counterpart. The reference's
// NormalizeRotation (pli_slam_tpu/ops/lie.py `normalize_rotation`) is
// jnp.linalg.svd + det, which XLA lowers inside the one jitted frame
// program. PyTorch's `torch.linalg.svd` on a CUDA tensor checks cuSOLVER's
// `info` on the host after every call, and that read is not allowed while a
// stream is being captured into a CUDA graph; this kernel computes the same
// function without leaving the device, so the fused per-frame steps can be
// captured. Its plain twin is `ops.kernels.rot3.closest_rotation_reference`
// (torch.linalg.svd + det), which the CPU runs.
//
// Function: for A = U diag(s) V^T (s descending), the rotation
//     U diag(1, 1, sign(det(U V^T))) V^T,
// i.e. the polar factor when det(A) > 0 and the closest proper rotation
// otherwise.
//
// Two branches:
// - Near rotations (det(A) > 0 and every squared singular value inside
//   (0.75, 1.25): what the main path hands the kernel -- pose updates
//   so3_exp(d) R, preintegration's products of increments, a BA window's
//   poses) take the Newton-Schulz polar iteration in float64 (`polar`):
//   X <- X - X E / 2 with E = X^T X - I, from X = A, until every entry of E
//   is within kPolarTol (at most kPolarIters steps). The iteration
//   converges to the polar factor, which is the closest rotation where
//   det(A) > 0; with s^2 - 1 = e a step maps e to -3 e^2 / 4 + e^3 / 4, so
//   a step from E within kPolarLast is the last, without the next E: the
//   main path's matrices (e ~ 1e-7) take one step, the gate's edge five. The result is the float64 answer for the float32 input, rounded
//   to float32 once at the store (`ROT3_STORE`, round to nearest; another
//   rounding can be put in by defining it before this file is included).
//   The gate is exact in float64 arithmetic and costs no eigenvalues:
//   every eigenvalue of M = A^T A lies in (0.75, 1.25) exactly when
//   1.25 I - M and M - 0.75 I are both positive definite, which Sylvester's
//   test of their leading minors decides (`inside`); Gershgorin's discs
//   decide the main path's matrices before it (`near_gram`).
// - Every other matrix (det <= 0, far from orthogonal, rank-deficient):
//   one-sided (Hestenes) Jacobi on the columns of A in float64
//   (`closest_f64`), rounded to float32 once at the store. Plane rotations
//   applied on the right make the columns of B = A V mutually orthogonal; V
//   is a product of rotations (det +1). The columns are sorted by norm,
//   descending, each swap negating one column so that det V stays +1. Then
//   u0 = b0/|b0|, u1 = b1 made orthogonal to u0 and normalised, u2 = u0 x u1,
//   so det U = +1 and A = U diag(s0, s1, +-s2) V^T: the sign of det(A) sits
//   in the last singular value, and U V^T is the twin's result. The
//   conditioning of the closest rotation (1 / (s1 +- s2)) amplifies a
//   float32 Jacobi's rounding past LAPACK's float32 SVD on such matrices
//   (ROADMAP queue 3 A4); in float64 the result is the float64 answer for
//   the float32 input. LAPACK's test and gesvj's skip of a zero column
//   (`jacobi::rotation`), at most kSweeps64 sweeps.
// What bounds it on an H100: nothing the card offers. A call reads 36 bytes
// and writes 36 bytes per matrix and does a few hundred float64
// operations per matrix (full rate on Hopper); the main path hands it 1 to
// 32 matrices, so a call is one launch's latency (0.0011-0.0012 ms in a
// CUDA graph, chip_smoke.py phase 3b). One thread per matrix keeps that
// launch the only cost and never synchronises with the host.
//
// The arithmetic also compiles as plain C++ (no __CUDACC__), with IEEE sqrt
// and division: `rot3_host` runs it matrix after matrix, so the method can
// be run on a host (tests/test_torch_small_kernels.py holds it against its
// numpy transcription bit for bit). The card's build differs from it in the
// last bits (fused multiply-adds, the refined roots).

#include "jacobi.cuh"

#ifdef __CUDACC__
#define ROT3_FN __host__ __device__ __forceinline__
#else
#define ROT3_FN inline
#endif

#ifndef ROT3_STORE
#define ROT3_STORE(x) static_cast<float>(x)  // the polar branch's store: round to nearest
#endif

namespace rot3 {

constexpr int kPolarIters = 8;       // Newton-Schulz steps at most: the gate's edge needs five
constexpr double kPolarTol = 1e-13;  // |X^T X - I| entries at or below this: converged (the store rounds at ~3e-8)
constexpr double kPolarLast = 1e-6;  // below this the step is the last: the next E would be ~3/4 of its square
constexpr double kDisc = 0.24;       // Gershgorin discs of A^T A within this of 1: inside the gate, no minors
constexpr int kSweeps64 = 16;
constexpr double kRank = 1e-24;  // |b1 - (u0 . b1) u0|^2 at or below this share of |b0|^2 is zero: rank one or zero

// ---- near rotations: the polar iteration in float64 ----

// The symmetric [[a, b, c], [b, d, e], [c, e, f]] is positive definite
// (Sylvester: its leading minors positive).
ROT3_FN bool positive_definite(double a, double b, double c, double d, double e, double f) {
  return a > 0.0 && a * d - b * b > 0.0 && a * (d * f - e * e) - b * (b * f - e * c) + c * (b * e - d * c) > 0.0;
}

// Every eigenvalue of the symmetric m (m00, m01, m02, m11, m12, m22) lies
// in (lo, hi).
ROT3_FN bool inside(const double* m, double lo, double hi) {
  return positive_definite(hi - m[0], -m[1], -m[2], hi - m[3], -m[4], hi - m[5]) &&
         positive_definite(m[0] - lo, m[1], m[2], m[3] - lo, m[4], m[5] - lo);
}

// X^T X of the row-major x [9] less the identity: (e00, e01, e02, e11, e12, e22).
ROT3_FN void gram_defect(const double* x, double* e) {
  e[0] = x[0] * x[0] + x[3] * x[3] + x[6] * x[6] - 1.0;
  e[1] = x[0] * x[1] + x[3] * x[4] + x[6] * x[7];
  e[2] = x[0] * x[2] + x[3] * x[5] + x[6] * x[8];
  e[3] = x[1] * x[1] + x[4] * x[4] + x[7] * x[7] - 1.0;
  e[4] = x[1] * x[2] + x[4] * x[5] + x[7] * x[8];
  e[5] = x[2] * x[2] + x[5] * x[5] + x[8] * x[8] - 1.0;
}

// Every eigenvalue of A^T A = I + E inside (0.75, 1.25), E as `gram_defect`
// gives it: Gershgorin's discs within kDisc of 1 decide it at once (what the
// main path hands the kernel), else the minors (`inside`).
ROT3_FN bool near_gram(const double* e) {
  const double r0 = fabs(e[0]) + fabs(e[1]) + fabs(e[2]);
  const double r1 = fabs(e[1]) + fabs(e[3]) + fabs(e[4]);
  const double r2 = fabs(e[2]) + fabs(e[4]) + fabs(e[5]);
  if (r0 < kDisc && r1 < kDisc && r2 < kDisc) return true;
  const double m[6] = {e[0] + 1.0, e[1], e[2], e[3] + 1.0, e[4], e[5] + 1.0};
  return inside(m, 0.75, 1.25);
}

// The polar factor of the row-major x [9] (a near rotation, in float64)
// into o [9]; `e` holds X^T X - I on entry. Returns the steps taken.
ROT3_FN int polar(double* x, double* e, float* o) {
  int k = 0;
  for (;;) {
    double err = fabs(e[0]);
#pragma unroll
    for (int i = 1; i < 6; ++i) err = fmax(err, fabs(e[i]));
    if (!(err > kPolarTol) || k == kPolarIters) break;
#pragma unroll
    for (int r = 0; r < 3; ++r) {  // row r of X <- row r of X (I - E / 2)
      const double x0 = x[3 * r], x1 = x[3 * r + 1], x2 = x[3 * r + 2];
      x[3 * r] = x0 - 0.5 * (x0 * e[0] + x1 * e[1] + x2 * e[2]);
      x[3 * r + 1] = x1 - 0.5 * (x0 * e[1] + x1 * e[3] + x2 * e[4]);
      x[3 * r + 2] = x2 - 0.5 * (x0 * e[2] + x1 * e[4] + x2 * e[5]);
    }
    ++k;
    if (err < kPolarLast) break;
    gram_defect(x, e);
  }
#pragma unroll
  for (int i = 0; i < 9; ++i) o[i] = ROT3_STORE(x[i]);
  return k;
}

// ---- every other matrix: float64 ----

ROT3_FN double dot3(const double* a, const double* b) { return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]; }

ROT3_FN void swap_neg(double (*c)[3], double (*v)[3], int i, int j) {
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    double t = c[i][r];
    c[i][r] = c[j][r];
    c[j][r] = -t;
    t = v[i][r];
    v[i][r] = v[j][r];
    v[j][r] = -t;
  }
}

// One-sided Jacobi in float64 (a float32 input's nonzero squared norm is a
// normal float64, the roots' range). Returns the sweeps.
ROT3_FN int closest_f64(const float* a, float* o) {
  double c[3][3], v[3][3];
#pragma unroll
  for (int j = 0; j < 3; ++j)
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      c[j][r] = static_cast<double>(a[3 * r + j]);
      v[j][r] = r == j ? 1.0 : 0.0;
    }
  const double tol2 = 3.0 * jacobi::kEps * jacobi::kEps;
  int s = 0;
  for (; s < kSweeps64; ++s) {
    bool rotated = false;
#pragma unroll
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0, q = pair == 0 ? 1 : 2;
      const double sums[3] = {dot3(c[p], c[p]), dot3(c[q], c[q]), dot3(c[p], c[q])};
      double cs, sn;
      if (!jacobi::rotation(sums, tol2, &cs, &sn)) continue;
      rotated = true;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const double bp = c[p][r], bq = c[q][r];
        c[p][r] = cs * bp - sn * bq;
        c[q][r] = sn * bp + cs * bq;
        const double vp = v[p][r], vq = v[q][r];
        v[p][r] = cs * vp - sn * vq;
        v[q][r] = sn * vp + cs * vq;
      }
    }
    if (!rotated) break;
  }
  double n0 = dot3(c[0], c[0]), n1 = dot3(c[1], c[1]), n2 = dot3(c[2], c[2]);
  if (n0 < n1) { swap_neg(c, v, 0, 1); const double t = n0; n0 = n1; n1 = t; }
  if (n0 < n2) { swap_neg(c, v, 0, 2); const double t = n0; n0 = n2; n2 = t; }
  if (n1 < n2) { swap_neg(c, v, 1, 2); const double t = n1; n1 = n2; n2 = t; }
  double u[3][3];
  if (n0 > 0.0) {
    const double inv = jacobi::inv_root(n0);
#pragma unroll
    for (int r = 0; r < 3; ++r) u[0][r] = c[0][r] * inv;
  } else {
    u[0][0] = 1.0; u[0][1] = 0.0; u[0][2] = 0.0;
  }
  double w[3];
  const double d01 = dot3(u[0], c[1]);
#pragma unroll
  for (int r = 0; r < 3; ++r) w[r] = c[1][r] - d01 * u[0][r];
  double wn = dot3(w, w);
  if (!(wn > kRank * (n0 > 0.0 ? n0 : 1.0))) {
    const bool first = fabs(u[0][0]) < 0.9;  // e_0, else e_1 (selected, not indexed: no local memory)
    const double e[3] = {first ? 1.0 : 0.0, first ? 0.0 : 1.0, 0.0};
    const double d = dot3(u[0], e);
#pragma unroll
    for (int r = 0; r < 3; ++r) w[r] = e[r] - d * u[0][r];
    wn = dot3(w, w);
  }
  const double winv = jacobi::inv_root(wn);
#pragma unroll
  for (int r = 0; r < 3; ++r) u[1][r] = w[r] * winv;
  u[2][0] = u[0][1] * u[1][2] - u[0][2] * u[1][1];
  u[2][1] = u[0][2] * u[1][0] - u[0][0] * u[1][2];
  u[2][2] = u[0][0] * u[1][1] - u[0][1] * u[1][0];
#pragma unroll
  for (int r = 0; r < 3; ++r)
#pragma unroll
    for (int col = 0; col < 3; ++col)
      o[3 * r + col] = static_cast<float>(u[0][r] * v[0][col] + u[1][r] * v[1][col] + u[2][r] * v[2][col]);
  return s;
}

// The closest rotation of the row-major a [9] into o [9]: the polar
// iteration where A is a near rotation (det(A) > 0 and every eigenvalue of
// A^T A in (0.75, 1.25), both in float64), else the float64 Jacobi branch.
// Returns the branch and its work: the polar iteration's steps (>= 0), or
// -1 - the Jacobi branch's sweeps (<= -1).
ROT3_FN int closest(const float* a, float* o) {
  double x[9], e[6];
#pragma unroll
  for (int i = 0; i < 9; ++i) x[i] = static_cast<double>(a[i]);
  const double det = x[0] * (x[4] * x[8] - x[5] * x[7]) - x[1] * (x[3] * x[8] - x[5] * x[6]) +
                     x[2] * (x[3] * x[7] - x[4] * x[6]);
  gram_defect(x, e);
  if (det > 0.0 && near_gram(e)) return polar(x, e, o);
  return -1 - closest_f64(a, o);
}

}  // namespace rot3

#ifdef __CUDACC__
namespace {

__global__ void rot3_kernel(const float* __restrict__ in, float* __restrict__ out, int n, int* __restrict__ sweeps) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  const int code = rot3::closest(in + 9 * m, out + 9 * m);
  if (sweeps != nullptr) sweeps[m] = code;
}

}  // namespace

// `in` and `out` are [n, 3, 3] float32, row-major, on the device; `sweeps`
// ([n] int32) may be null, else it receives each matrix's branch and work:
// the polar iteration's steps (>= 0), or -1 - the Jacobi branch's sweeps.
// Launches on `stream` (a cudaStream_t). Returns 0 or the cudaError of the
// launch.
extern "C" int rot3_launch(const void* in, void* out, int n, void* sweeps, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 128;
  rot3_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), n, static_cast<int*>(sweeps));
  return static_cast<int>(cudaGetLastError());
}
#else
// The same function on a host, matrix after matrix (`closest`).
extern "C" int rot3_host(const float* in, float* out, int n, int* sweeps) {
  for (int m = 0; m < n; ++m) {
    const int code = rot3::closest(in + 9 * m, out + 9 * m);
    if (sweeps != nullptr) sweeps[m] = code;
  }
  return 0;
}
#endif
