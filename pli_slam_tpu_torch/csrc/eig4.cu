// The largest eigenpair of a batch of symmetric 4x4 matrices for Hopper (sm_90a).
//
// The port's own kernel: it has no TPU counterpart. The reference's Horn
// alignment (pli_slam_tpu/solve/sim3.py `horn_alignment`) takes the
// eigenvector of the largest eigenvalue of Horn's 4x4 matrix N with
// jnp.linalg.eigh, which XLA lowers inside the jitted relocalization and
// loop-verification programs. PyTorch's `torch.linalg.eigh` on a CUDA tensor
// checks cuSOLVER's `info` on the host after every call, which a stream being
// captured into a CUDA graph may not do; this kernel computes the same
// function without leaving the device, so the stereo PnP RANSAC
// (solve/pnp.py) and the loop's 3D-3D RANSAC (solve/sim3.py) can be
// captured. Its plain twin is `ops.kernels.eig4.largest_eigvec_reference`
// (torch.linalg.eigh), which the CPU runs.
//
// Function: for a symmetric A [4, 4], the unit eigenvector of its largest
// eigenvalue (and that eigenvalue). Its sign is free, as eigh's is: Horn's
// q and -q give one rotation.
//
// Method: cyclic Jacobi in float64, one thread per matrix. Each sweep visits
// the six pairs (p, q) in order and zeroes a[p][q] with the plane rotation
// t = tan(phi) = sign(theta) / (|theta| + sqrt(theta^2 + 1)),
// theta = (a_qq - a_pp) / (2 a_pq), applied to both sides of A and to the
// columns of V (A = V diag(a) V^T throughout). A pair whose off-diagonal
// entry lies below 1e-15 of ||A||_F is left alone; the sweeps stop when a
// whole sweep leaves every pair (at most kSweeps; quadratic convergence
// needs 4-6). The answer is V's column at the largest diagonal entry,
// normalised, rounded to float32. The arithmetic is float64 because a
// float32 Jacobi's rotations round: ~30 of them leave the eigenvector
// ~6e-7 from the float64 answer, farther than a float32 eigh; in float64 the
// result is the float64 eigenvector of the float32 input to its last
// rounding. The card's float64 rate costs nothing here: the call is one
// launch's latency.
//
// What bounds it on an H100: nothing the card offers. A call reads 64 bytes
// and writes 16 (20 with the eigenvalue) per matrix and does ~70 float64
// operations per rotation, six rotations a sweep; the main path hands it 256
// matrices (the PnP hypotheses, the loop's Sim3 hypotheses) or one
// (the consensus refit), so a call is one launch's latency. One thread per
// matrix keeps that launch the only cost and never synchronises with the
// host.
//
// The arithmetic (`jacobi4`) also compiles as plain C++ (no __CUDACC__), so
// the method can be run on a host.

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define EIG4_FN __host__ __device__ __forceinline__
#else
#include <cmath>
#define EIG4_FN inline
#endif

namespace eig4 {

constexpr int kSweeps = 16;
constexpr double kTol = 1e-15;  // an off-diagonal entry below this share of ||A||_F is left

// Diagonalise the symmetric a (both triangles) in place, accumulating the
// rotations into v (columns: eigenvectors). Returns the sweeps taken.
EIG4_FN int jacobi4(double a[4][4], double v[4][4]) {
  double fro = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      fro += a[i][j] * a[i][j];
      v[i][j] = (i == j) ? 1.0 : 0.0;
    }
  const double tol = kTol * sqrt(fro);
  int s = 0;
  for (; s < kSweeps; ++s) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
#pragma unroll
      for (int q = p + 1; q < 4; ++q) {
        const double apq = a[p][q];
        if (!(fabs(apq) > tol)) continue;
        rotated = true;
        const double theta = (a[q][q] - a[p][p]) / (2.0 * apq);
        const double t = copysign(1.0, theta) / (fabs(theta) + sqrt(1.0 + theta * theta));
        const double c = 1.0 / sqrt(1.0 + t * t);
        const double sn = t * c;
        a[p][p] -= t * apq;
        a[q][q] += t * apq;
        a[p][q] = 0.0;
        a[q][p] = 0.0;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (r != p && r != q) {
            const double g = a[r][p], h = a[r][q];
            a[r][p] = c * g - sn * h;
            a[p][r] = a[r][p];
            a[r][q] = sn * g + c * h;
            a[q][r] = a[r][q];
          }
          const double vg = v[r][p], vh = v[r][q];
          v[r][p] = c * vg - sn * vh;
          v[r][q] = sn * vg + c * vh;
        }
      }
    }
    if (!rotated) break;
  }
  return s;
}

// The largest eigenpair of the row-major symmetric m [16]: vec [4] (unit), *val.
EIG4_FN int largest(const float* m, float* vec, float* val) {
  double a[4][4], v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[i][j] = m[4 * i + j];
  const int s = jacobi4(a, v);
  int k = 0;
  double best = a[0][0];
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (a[i][i] >= best) {  // the last of equal eigenvalues, as eigh's ascending order gives
      best = a[i][i];
      k = i;
    }
  double col[4];
  double n2 = 0.0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    col[r] = (k == 0) ? v[r][0] : (k == 1) ? v[r][1] : (k == 2) ? v[r][2] : v[r][3];
    n2 += col[r] * col[r];
  }
  const double inv = 1.0 / sqrt(n2);
#pragma unroll
  for (int r = 0; r < 4; ++r) vec[r] = static_cast<float>(col[r] * inv);
  *val = static_cast<float>(best);
  return s;
}

}  // namespace eig4

#ifdef __CUDACC__
namespace {

__global__ void eig4_kernel(const float* __restrict__ in, float* __restrict__ vec, float* __restrict__ val, int n,
                            int* __restrict__ sweeps) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  float e[4], lam;
  const int s = eig4::largest(in + 16 * m, e, &lam);
#pragma unroll
  for (int r = 0; r < 4; ++r) vec[4 * m + r] = e[r];
  if (val != nullptr) val[m] = lam;
  if (sweeps != nullptr) sweeps[m] = s;
}

}  // namespace

// `in` is [n, 4, 4] float32 (symmetric, row-major), `vec` [n, 4] float32, on
// the device; `val` ([n] float32, the largest eigenvalues) and `sweeps` ([n]
// int32, the Jacobi sweeps each matrix took) may be null. Launches on
// `stream` (a cudaStream_t). Returns 0 or the cudaError of the launch.
extern "C" int eig4_launch(const void* in, void* vec, void* val, int n, void* sweeps, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 128;
  eig4_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(vec), static_cast<float*>(val), n,
      static_cast<int*>(sweeps));
  return static_cast<int>(cudaGetLastError());
}
#endif
