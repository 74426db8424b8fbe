// Singular value decomposition of a batch of small square matrices (n <= 12)
// for Hopper (sm_90a).
//
// The port's own kernel: it has no TPU counterpart. The reference's
// depth-free PnP (pli_slam_tpu/solve/pnp.py `ransac_pnp_dlt`, the monocular
// relocalization) solves a 6-point DLT per hypothesis with jnp.linalg.svd --
// the null vector of A [H, 12, 12], then U, S, V of the rotation block
// M [H, 3, 3] -- which XLA lowers inside the jitted relocalization program.
// PyTorch's `torch.linalg.svd` on a CUDA tensor checks cuSOLVER's `info` on
// the host after every call, which a stream being captured into a CUDA graph
// may not do; this kernel computes the same factorisation without leaving the
// device, so the mono PnP stage can be captured. Its plain twin is
// `ops.kernels.svd_small.svd_reference` (torch.linalg.svd), which the CPU
// runs.
//
// Function: A = U diag(S) V^T for a square A [n, n], n <= 12, S descending,
// U and V orthogonal; the signs of a pair (u_j, v_j) are free, as the
// twin's are. Columns of U for exactly zero singular values are completed
// to an orthonormal basis.
//
// Method: one-sided (Hestenes) Jacobi on the columns of A in float64, one
// thread per matrix, as csrc/rot3.cu does for 3x3 in float32. Plane
// rotations applied on the right make the columns of B = A V mutually
// orthogonal: a pair (p, q) is rotated
// while |b_p . b_q| > sqrt(n) eps |b_p| |b_q| (LAPACK's gesvj test), at most
// kSweeps cyclic sweeps. Then S = the column norms, sorted descending with V's
// columns, and U = B diag(1/S). It works on A itself and never forms A^T A, so
// the smallest singular vector's accuracy follows A's condition number, not
// its square (the fault of an eigenvector of A^T A in float32, ROADMAP
// queue 3 B5). The arithmetic is float64 because a float32 Jacobi's
// rotations round: on 12x12 systems its smallest singular vector lies
// ~1e-6 from the float64 answer, farther than a float32 LAPACK SVD; in
// float64 the result is the float64 factorisation of the float32 input,
// rounded to float32 once.
//
// What bounds it on an H100: nothing the card offers. A call reads 4 n^2 and
// writes 4 (2 n^2 + n) bytes per matrix and does ~12 n float64 operations per
// pair rotation, n (n - 1) / 2 pairs a sweep; the main path hands it 256
// matrices of 12x12 or 3x3 (the mono PnP hypotheses), so a call is one
// launch's latency plus a few thousand dependent operations per thread. One
// thread per matrix keeps the launch the only synchronisation; B and V
// (2 n^2 doubles) live in the thread's local memory, which at 256 threads
// stays in L1.
//
// The arithmetic (`svd_small::factor`) also compiles as plain C++ (no
// __CUDACC__), so the method can be run on a host.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define SVD_FN __host__ __device__ __forceinline__
#else
#include <cmath>
#define SVD_FN inline
#endif

namespace svd_small {

constexpr int kMaxN = 12;
constexpr int kSweeps = 30;
constexpr double kEps = 2.220446049250313e-16;  // float64 machine epsilon

SVD_FN double dot(const double* a, const double* b, int n) {
  double s = 0.0;
  for (int r = 0; r < n; ++r) s += a[r] * b[r];
  return s;
}

SVD_FN void swap_cols(double (*c)[kMaxN], int i, int j, int n) {
  for (int r = 0; r < n; ++r) {
    const double t = c[i][r];
    c[i][r] = c[j][r];
    c[j][r] = t;
  }
}

// The row-major a [n * n] -> u [n * n] (row-major), s [n] (descending),
// vt [n * n] (row-major, rows = right singular vectors). Returns the sweeps.
SVD_FN int factor(const float* a, int n, float* u, float* s, float* vt) {
  double c[kMaxN][kMaxN], v[kMaxN][kMaxN];  // c[j]: column j of B = A V; v[j]: column j of V
  for (int j = 0; j < n; ++j)
    for (int r = 0; r < n; ++r) {
      c[j][r] = static_cast<double>(a[n * r + j]);
      v[j][r] = (r == j) ? 1.0 : 0.0;
    }
  const double tol = sqrt(static_cast<double>(n)) * kEps;
  int sw = 0;
  for (; sw < kSweeps; ++sw) {
    bool rotated = false;
    for (int p = 0; p < n - 1; ++p)
      for (int q = p + 1; q < n; ++q) {
        const double alpha = dot(c[p], c[p], n);
        const double beta = dot(c[q], c[q], n);
        const double gamma = dot(c[p], c[q], n);
        if (!(fabs(gamma) > tol * sqrt(alpha) * sqrt(beta))) continue;
        const double zeta = (beta - alpha) / (2.0 * gamma);
        const double t = copysign(1.0, zeta) / (fabs(zeta) + sqrt(1.0 + zeta * zeta));
        if (t == 0.0) continue;  // zeta^2 overflowed: the angle is below float64's resolution
        rotated = true;
        const double cs = 1.0 / sqrt(1.0 + t * t);
        const double sn = cs * t;
        for (int r = 0; r < n; ++r) {
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
  // the column norms, sorted descending (selection sort, V's columns along)
  double nrm[kMaxN];
  for (int j = 0; j < n; ++j) nrm[j] = dot(c[j], c[j], n);
  for (int i = 0; i < n - 1; ++i) {
    int k = i;
    for (int j = i + 1; j < n; ++j)
      if (nrm[j] > nrm[k]) k = j;
    if (k != i) {
      swap_cols(c, i, k, n);
      swap_cols(v, i, k, n);
      const double t = nrm[i];
      nrm[i] = nrm[k];
      nrm[k] = t;
    }
  }
  for (int j = 0; j < n; ++j) {
    const double sj = sqrt(nrm[j]);
    s[j] = static_cast<float>(sj);
    if (nrm[j] > 1e-300) {
      const double inv = 1.0 / sj;
      for (int r = 0; r < n; ++r) c[j][r] *= inv;
      continue;
    }
    // a zero singular value: the first unit vector e_k that keeps at least
    // 1 / (2n) of its squared length orthogonal to the columns before it
    // (Gram-Schmidt, twice); the complement's projections of the n unit
    // vectors sum to its dimension, so one keeps at least 1 / n
    for (int k = 0; k < n; ++k) {
      for (int r = 0; r < n; ++r) c[j][r] = (r == k) ? 1.0 : 0.0;
      for (int pass = 0; pass < 2; ++pass)
        for (int i = 0; i < j; ++i) {
          const double d = dot(c[i], c[j], n);
          for (int r = 0; r < n; ++r) c[j][r] -= d * c[i][r];
        }
      const double w = dot(c[j], c[j], n);
      if (w > 0.5 / n || k == n - 1) {
        const double inv = 1.0 / sqrt(w);
        for (int r = 0; r < n; ++r) c[j][r] *= inv;
        break;
      }
    }
  }
  for (int r = 0; r < n; ++r)
    for (int j = 0; j < n; ++j) {
      u[n * r + j] = static_cast<float>(c[j][r]);
      vt[n * j + r] = static_cast<float>(v[j][r]);
    }
  return sw;
}

}  // namespace svd_small

#ifdef __CUDACC__
namespace {

__global__ void svd_small_kernel(const float* __restrict__ in, float* __restrict__ u, float* __restrict__ s,
                                 float* __restrict__ vt, int count, int n, int* __restrict__ sweeps) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= count) return;
  const int sq = n * n;
  const int sw = svd_small::factor(in + sq * m, n, u + sq * m, s + n * m, vt + sq * m);
  if (sweeps != nullptr) sweeps[m] = sw;
}

}  // namespace

// `in` is [count, n, n] float32 row-major on the device, n in 1..12; `u` and
// `vt` are [count, n, n], `s` [count, n], float32 on the device; `sweeps`
// ([count] int32, the Jacobi sweeps each matrix took) may be null. Launches
// on `stream` (a cudaStream_t). Returns 0, -1 for an n out of range, or the
// cudaError of the launch.
extern "C" int svd_small_launch(const void* in, void* u, void* s, void* vt, int count, int n, void* sweeps,
                                void* stream) {
  if (n < 1 || n > svd_small::kMaxN) return -1;
  if (count <= 0) return 0;
  constexpr int kThreads = 64;
  svd_small_kernel<<<(count + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(u), static_cast<float*>(s), static_cast<float*>(vt),
      count, n, static_cast<int*>(sweeps));
  return static_cast<int>(cudaGetLastError());
}
#endif
