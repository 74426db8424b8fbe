// Closest rotation of a batch of 3x3 matrices for Hopper (sm_90a).
//
// The port's own kernel: it has no TPU counterpart. The reference's
// NormalizeRotation (pli_slam_tpu/ops/lie.py `normalize_rotation`) is
// jnp.linalg.svd + det, which XLA lowers inside the one jitted frame
// program. PyTorch's `torch.linalg.svd` on a CUDA tensor checks cuSOLVER's
// `info` on the host after every call, and that read is not allowed while a
// stream is being captured into a CUDA graph; this kernel computes the same
// function without leaving the device, so the fused per-frame steps can be
// captured. Its plain twin is `ops.lie.normalize_rotation_reference`
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
// singular value, and U V^T is the twin's result. Sweeps stop when a whole
// sweep finds every pair orthogonal to float32 precision (at most kSweeps).
//
// What bounds it on an H100: nothing the card offers. A call reads 36 bytes
// and writes 36 bytes per matrix and does a few hundred float32
// operations per matrix; the main path hands it 1 to 32 matrices, so a call
// is one launch's latency. One thread per matrix keeps that launch the only
// cost and never synchronises with the host.

#include <cuda_runtime.h>

namespace {

constexpr int kSweeps = 12;

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void swap_neg(float (*c)[3], float (*v)[3], int i, int j) {
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

__global__ void rot3_kernel(const float* __restrict__ in, float* __restrict__ out, int n, int* __restrict__ sweeps) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= n) return;
  const float* a = in + 9 * m;
  // c[j] is column j of B (initially A), v[j] column j of V
  float c[3][3], v[3][3];
  for (int j = 0; j < 3; ++j)
    for (int r = 0; r < 3; ++r) {
      c[j][r] = a[3 * r + j];
      v[j][r] = (r == j) ? 1.0f : 0.0f;
    }
  int s = 0;
  for (; s < kSweeps; ++s) {
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
  if (sweeps != nullptr) sweeps[m] = s;
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
  float* o = out + 9 * m;
  for (int r = 0; r < 3; ++r)
    for (int col = 0; col < 3; ++col)
      o[3 * r + col] = u[0][r] * v[0][col] + u[1][r] * v[1][col] + u[2][r] * v[2][col];
}

}  // namespace

// `in` and `out` are [n, 3, 3] float32, row-major, on the device; `sweeps`
// ([n] int32, the Jacobi sweeps each matrix took) may be null. Launches on
// `stream` (a cudaStream_t). Returns 0 or the cudaError of the launch.
extern "C" int rot3_launch(const void* in, void* out, int n, void* sweeps, void* stream) {
  if (n <= 0) return 0;
  constexpr int kThreads = 128;
  rot3_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), n, static_cast<int*>(sweeps));
  return static_cast<int>(cudaGetLastError());
}
