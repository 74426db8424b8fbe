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
// Method: one-sided (Hestenes) Jacobi on the columns of A, one thread per
// matrix. Plane rotations applied on the right make the columns of
// B = A V mutually orthogonal; V is a product of rotations (det +1). The
// columns are sorted by norm, descending, each swap negating one column
// so that det V stays +1. Then u0 = b0/|b0|, u1 = b1 made orthogonal to
// u0 and normalised, u2 = u0 x u1, so det U = +1 and
// A = U diag(s0, s1, +-s2) V^T: the sign of det(A) sits in the last
// singular value, and U V^T is the twin's result. Two branches of it:
// - Near rotations (det(A) > 0 and every squared singular value within
//   0.25 of 1, `closest`): what the main path hands the kernel (pose updates
//   so3_exp(d) R, preintegration's products of increments, a BA window's
//   poses), in float32 (`closest_f32`), the kernel's first arithmetic bit
//   for bit. Sweeps stop when a whole sweep finds every pair orthogonal to
//   float32 precision (at most kSweeps32); such a matrix takes 0-3. Its
//   result lies ~2e-7 from the float64 answer, as near as cuSOLVER's float32
//   SVD or nearer; but one ulp of difference here moves chip_smoke.py phase
//   6a's tracking over 0.018-0.137 m of ATE (ROADMAP queue 3 A6), so these
//   bits are kept until that is repaired.
// - Every other matrix (det <= 0, far from orthogonal, rank-deficient) in
//   float64, rounded to float32 once at the store (`closest_f64`): the
//   conditioning of the closest rotation (1 / (s1 +- s2)) amplifies a
//   float32 Jacobi's rounding past LAPACK's float32 SVD on such matrices
//   (ROADMAP queue 3 A4); in float64 the result is the float64 answer for
//   the float32 input. LAPACK's test and gesvj's skip of a zero column
//   (`jacobi::rotation`), at most kSweeps64 sweeps.
//
// What bounds it on an H100: nothing the card offers. A call reads 36 bytes
// and writes 36 bytes per matrix and does a few hundred float32
// operations per matrix; the main path hands it 1 to 32 matrices, so a call
// is one launch's latency (0.0011-0.0012 ms in a CUDA graph, chip_smoke.py
// phase 3b, and the kernel ~0.0004 ms more). One thread per matrix keeps
// that launch the only cost and never synchronises with the host.
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

namespace rot3 {

constexpr int kSweeps32 = 12;
constexpr int kSweeps64 = 16;
constexpr double kRank = 1e-24;  // |b1 - (u0 . b1) u0|^2 at or below this share of |b0|^2 is zero: rank one or zero

// ---- near rotations: float32 ----

ROT3_FN float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

ROT3_FN void swap_neg(float (*c)[3], float (*v)[3], int i, int j) {
  // swap columns i and j of B and V, negating the new column j of both:
  // B = A V still holds and det V stays +1
  for (int r = 0; r < 3; ++r) {
    float t = c[i][r];
    c[i][r] = c[j][r];
    c[j][r] = -t;
    t = v[i][r];
    v[i][r] = v[j][r];
    v[j][r] = -t;
  }
}

// The closest rotation of the row-major a [9] into o [9], and the largest
// and smallest squared singular values it found (its sorted column norms).
// Returns the sweeps.
ROT3_FN int closest_f32(const float* a, float* o, float* n_max, float* n_min) {
  // c[j] is column j of B (initially A), v[j] column j of V
  float c[3][3], v[3][3];
  for (int j = 0; j < 3; ++j)
    for (int r = 0; r < 3; ++r) {
      c[j][r] = a[3 * r + j];
      v[j][r] = (r == j) ? 1.0f : 0.0f;
    }
  int s = 0;
  for (; s < kSweeps32; ++s) {
    bool rotated = false;
    for (int pair = 0; pair < 3; ++pair) {
      const int p = pair == 2 ? 1 : 0;
      const int q = pair == 0 ? 1 : 2;
      const float alpha = dot3(c[p], c[p]);
      const float beta = dot3(c[q], c[q]);
      const float gamma = dot3(c[p], c[q]);
      if (!(fabsf(gamma) > 1e-7f * sqrtf(alpha * beta))) continue;
      rotated = true;
      const float zeta = (beta - alpha) / (2.0f * gamma);
      const float t = copysignf(1.0f, zeta) / (fabsf(zeta) + sqrtf(1.0f + zeta * zeta));
      const float cs = 1.0f / sqrtf(1.0f + t * t);
      const float sn = cs * t;
      for (int r = 0; r < 3; ++r) {
        const float bp = c[p][r], bq = c[q][r];
        c[p][r] = cs * bp - sn * bq;
        c[q][r] = sn * bp + cs * bq;
        const float vp = v[p][r], vq = v[q][r];
        v[p][r] = cs * vp - sn * vq;
        v[q][r] = sn * vp + cs * vq;
      }
    }
    if (!rotated) break;
  }
  // sort the columns by norm, descending
  float n0 = dot3(c[0], c[0]), n1 = dot3(c[1], c[1]), n2 = dot3(c[2], c[2]);
  if (n0 < n1) { swap_neg(c, v, 0, 1); float t = n0; n0 = n1; n1 = t; }
  if (n0 < n2) { swap_neg(c, v, 0, 2); float t = n0; n0 = n2; n2 = t; }
  if (n1 < n2) { swap_neg(c, v, 1, 2); float t = n1; n1 = n2; n2 = t; }
  // U: proper, from the two leading columns
  float u[3][3];
  if (n0 > 0.0f) {
    const float inv = 1.0f / sqrtf(n0);
    for (int r = 0; r < 3; ++r) u[0][r] = c[0][r] * inv;
  } else {
    u[0][0] = 1.0f; u[0][1] = 0.0f; u[0][2] = 0.0f;
  }
  float w[3];
  const float d01 = dot3(u[0], c[1]);
  for (int r = 0; r < 3; ++r) w[r] = c[1][r] - d01 * u[0][r];
  float wn = dot3(w, w);
  if (!(wn > 1e-30f * (n0 > 0.0f ? n0 : 1.0f))) {
    // rank one or zero: any unit vector orthogonal to u0
    const int k = fabsf(u[0][0]) < 0.9f ? 0 : 1;
    float e[3] = {0.0f, 0.0f, 0.0f};
    e[k] = 1.0f;
    const float d = dot3(u[0], e);
    for (int r = 0; r < 3; ++r) w[r] = e[r] - d * u[0][r];
    wn = dot3(w, w);
  }
  const float winv = 1.0f / sqrtf(wn);
  for (int r = 0; r < 3; ++r) u[1][r] = w[r] * winv;
  u[2][0] = u[0][1] * u[1][2] - u[0][2] * u[1][1];
  u[2][1] = u[0][2] * u[1][0] - u[0][0] * u[1][2];
  u[2][2] = u[0][0] * u[1][1] - u[0][1] * u[1][0];
  // R = U V^T, row-major
  for (int r = 0; r < 3; ++r)
    for (int col = 0; col < 3; ++col)
      o[3 * r + col] = u[0][r] * v[0][col] + u[1][r] * v[1][col] + u[2][r] * v[2][col];
  *n_max = n0;
  *n_min = n2;
  return s;
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

// As closest_f32, in float64 (a float32 input's nonzero squared norm is a
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

// The closest rotation of the row-major a [9] into o [9]. The float32
// branch runs first and stores its result; its sorted column norms are the
// squared singular values, so A is a near rotation when every one lies in
// (0.75, 1.25) (the defect's spectral norm below 0.25) and det(A) > 0
// (exact in sign there: |det| > 0.64). Otherwise the float64 branch
// overwrites the result. A near rotation pays a float32 determinant beside
// its chain and one test after its stores. Returns the branch and its
// sweeps: the float32 branch's sweeps (>= 0), or -1 - the float64 branch's
// (<= -1).
ROT3_FN int closest(const float* a, float* o) {
  const float det = a[0] * (a[4] * a[8] - a[5] * a[7]) - a[1] * (a[3] * a[8] - a[5] * a[6]) +
                    a[2] * (a[3] * a[7] - a[4] * a[6]);  // read before the stores
  float n_max, n_min;
  const int s = closest_f32(a, o, &n_max, &n_min);
  if (det > 0.0f && n_min > 0.75f && n_max < 1.25f) return s;
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
// ([n] int32) may be null, else it receives each matrix's branch and
// sweeps: the float32 branch's sweeps (>= 0), or -1 - the float64 branch's.
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
