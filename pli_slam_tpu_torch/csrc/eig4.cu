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
// q and -q give one rotation. The kernel reads A's lower triangle, as the
// twin (eigh, UPLO "L") does.
//
// Method: two-sided Jacobi in float64. A pair (p, q) is zeroed by the plane
// rotation of [[a_pp, a_pq], [a_pq, a_qq]] (`jacobi::plane_rotation`,
// |angle| <= pi / 4), applied to both sides of A and to the columns of V
// (A = V diag(a) V^T throughout); a pair whose off-diagonal entry lies at
// or below 1e-15 of ||A||_F (kTol) is left alone, and the sweeps stop when no
// pair would rotate (`diagonalize`; at most kSweeps). The order is round-robin
// (Brent and Luk's parallel ordering): a sweep is three steps of two
// disjoint rotations, (0,1)(2,3), then (0,2)(1,3), then (0,3)(1,2) (step k
// rotates (0, k) and its complement, `pairs`), in place of six serial ones;
// the two rotations of a step commute, so a step applies both at once. Luk
// and Park (1989) showed the round-robin ordering equivalent to the cyclic-
// by-rows one (the same rotations up to a relabelling of the indices), so it
// keeps the cyclic method's global and asymptotically quadratic convergence
// (Horn's matrices of chip_smoke.py phase 3c take 3-4). The answer is
// V's column at the largest diagonal entry (the last of equal ones, as
// eigh's ascending order gives), normalised, rounded to float32. The
// arithmetic is float64 because a float32 Jacobi's rotations round: ~30 of
// them leave the eigenvector ~6e-7 from the float64 answer, farther than a
// float32 eigh; in float64 the result is the float64 eigenvector of the
// float32 input to its last rounding.
//
// Layout: four lanes a matrix, eight matrices a warp, one warp a block, so
// the main path's 256 matrices (the PnP hypotheses, the loop's Sim3
// hypotheses) spread over 32 SMs. Every lane of a matrix holds all of A's
// upper triangle (ten float64) and computes both rotations of a step and
// A's update itself: the same instructions on the same values, so every
// lane derives the same rotations bit for bit, with no shuffle. Lane r
// holds row r of V and rotates it; at the end an xor butterfly over the
// four lanes sums the chosen column's squared entries (bit-identical in
// every lane: float addition is commutative) and lane r stores entry r.
//
// What bounds it on an H100: not the card's rates but one dependent chain a
// step: the two rotations' parameters, each two refined float64 reciprocal
// square roots in series (no IEEE division or sqrt: their slow-path
// subroutine would give the kernel a stack frame), then A's 2x2 blocks, two
// fma deep. A call reads 64 bytes and writes 16 (20 with the eigenvalue) a
// matrix; ~4 sweeps of 3 steps is a chain of ~12 steps, and a launch lasts
// as long as its slowest matrix. Tensor cores and TMA do not serve: there
// is no product to tile and nothing to stream.
//
// The arithmetic (`load_lower`, `pairs`, `rotations`, `rotate_a`, `rotate_rows`,
// `diagonalize`, `top`) also compiles as plain C++ (no __CUDACC__), with
// IEEE sqrt and division (csrc/jacobi.cuh): `eig4_host` runs it matrix after
// matrix with V's four rows in one place (the lanes' rows one after
// another), so the method can be run on a host
// (tests/test_torch_small_kernels.py holds it against its numpy
// transcription bit for bit). The card's build differs from it in the last
// bits (fused multiply-adds, the refined roots).

#include "jacobi.cuh"

#ifdef __CUDACC__
#define EIG4_FN __host__ __device__ __forceinline__
#else
#define EIG4_FN inline
#endif

namespace eig4 {

constexpr int kSweeps = 16;
constexpr double kTol = 1e-15;  // an off-diagonal entry at or below this share of ||A||_F is left
constexpr int kLanes = 4;       // lanes a matrix on the card
constexpr int kBlock = 32;      // threads a block: one warp, eight matrices

// A's entry (i, j) in its upper triangle a[min][max] (the lower one is never read).
EIG4_FN double& at(double a[4][4], int i, int j) { return i <= j ? a[i][j] : a[j][i]; }

// The row-major m [16]'s lower triangle into a's upper one. Returns ||A||_F^2.
EIG4_FN double load_lower(const float* m, double a[4][4]) {
  double fro = 0.0;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = i; j < 4; ++j) {
      a[i][j] = static_cast<double>(m[4 * j + i]);
      fro += (i == j ? 1.0 : 2.0) * (a[i][j] * a[i][j]);
    }
  return fro;
}

// Step k (1, 2, 3) of a sweep rotates the pairs (0, k) and (p2, q2), its complement.
EIG4_FN void pairs(int k, int* p2, int* q2) {
  *p2 = k == 1 ? 2 : 1;
  *q2 = k == 3 ? 2 : 3;
}

struct Rot {
  double cs, sn, tq;  // p' = cs p - sn q, q' = sn p + cs q; tq = tan(angle) a_pq
  bool ok;            // the pair rotates (else the identity, tq = 0)
};

// The rotation zeroing a_pq, computed whole and then selected.
EIG4_FN Rot pair_rotation(double app, double aqq, double apq, double tol) {
  double c, s, x, hr;
  jacobi::plane_rotation(app, aqq, apq, &c, &s, &x, &hr);
  // |apq| > tol >= 1e-15 ||A||_F keeps x = (a_qq - a_pp)^2 + 4 a_pq^2 a positive normal float64 for any float32
  // input: the roots' range
  Rot r;
  r.ok = fabs(apq) > tol;
  r.cs = r.ok ? c : 1.0;
  r.sn = r.ok ? s : 0.0;
  r.tq = r.ok ? s * hr * apq : 0.0;
  return r;
}

// Step k's two rotations, both from A as it is.
EIG4_FN void rotations(double a[4][4], int k, double tol, Rot* r1, Rot* r2) {
  int p2, q2;
  pairs(k, &p2, &q2);
  *r1 = pair_rotation(a[0][0], a[k][k], a[0][k], tol);
  *r2 = pair_rotation(a[p2][p2], a[q2][q2], a[p2][q2], tol);
}

// A <- J^T A J for step k's two rotations.
EIG4_FN void rotate_a(double a[4][4], int k, const Rot* r1, const Rot* r2) {
  int p2, q2;
  pairs(k, &p2, &q2);
  const double c1 = r1->cs, s1 = r1->sn, c2 = r2->cs, s2 = r2->sn;
  // the block of rows (0, k) and columns (p2, q2): J1^T B J2, the right side first
  const double b00 = at(a, 0, p2), b01 = at(a, 0, q2), b10 = at(a, k, p2), b11 = at(a, k, q2);
  const double x00 = c2 * b00 - s2 * b01, x01 = s2 * b00 + c2 * b01;
  const double x10 = c2 * b10 - s2 * b11, x11 = s2 * b10 + c2 * b11;
  at(a, 0, p2) = c1 * x00 - s1 * x10;
  at(a, k, p2) = s1 * x00 + c1 * x10;
  at(a, 0, q2) = c1 * x01 - s1 * x11;
  at(a, k, q2) = s1 * x01 + c1 * x11;
  // within each pair: the diagonal moves by tan(angle) a_pq, a_pq becomes 0
  a[0][0] -= r1->tq;
  a[k][k] += r1->tq;
  a[0][k] = r1->ok ? 0.0 : a[0][k];
  a[p2][p2] -= r2->tq;
  a[q2][q2] += r2->tq;
  a[p2][q2] = r2->ok ? 0.0 : a[p2][q2];
}

// Rows of V (each v[i][0..3]) <- rows V J for step k's rotations.
template <int Rows>
EIG4_FN void rotate_rows(double (*v)[4], int k, const Rot& r1, const Rot& r2) {
  int p2, q2;
  pairs(k, &p2, &q2);
#pragma unroll
  for (int i = 0; i < Rows; ++i) {
    const double g = v[i][0], h = v[i][k];
    v[i][0] = r1.cs * g - r1.sn * h;
    v[i][k] = r1.sn * g + r1.cs * h;
    const double g2 = v[i][p2], h2 = v[i][q2];
    v[i][p2] = r2.cs * g2 - r2.sn * h2;
    v[i][q2] = r2.sn * g2 + r2.cs * h2;
  }
}

// Whether no pair would rotate: every off-diagonal entry at or below tol.
EIG4_FN bool converged(const double a[4][4], double tol) {
  return !(fabs(a[0][1]) > tol || fabs(a[0][2]) > tol || fabs(a[0][3]) > tol || fabs(a[1][2]) > tol ||
           fabs(a[1][3]) > tol || fabs(a[2][3]) > tol);
}

// Diagonalise a (upper triangle) by round-robin sweeps, rotating the Rows
// rows of V in v. Returns the sweeps in which a pair rotated. The sweeps
// stop when no pair would rotate, which is tested before every step: a
// step of the sweep after it would rotate nothing and change nothing, so
// the result is the one a whole idle sweep would give, a sweep's three
// steps sooner.
template <int Rows>
EIG4_FN int diagonalize(double a[4][4], double (*v)[4], double tol) {
  for (int s = 0; s < kSweeps; ++s) {
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      if (converged(a, tol)) return k == 1 ? s : s + 1;  // a pair of this sweep rotated, unless at its start
      Rot r1, r2;
      rotations(a, k, tol, &r1, &r2);
      rotate_a(a, k, &r1, &r2);
      rotate_rows<Rows>(v, k, r1, r2);
    }
  }
  return kSweeps;
}

// The index of the largest diagonal entry (the last of equal ones, as
// eigh's ascending order gives) and the entry.
EIG4_FN int top(const double a[4][4], double* best) {
  int k = 0;
  *best = a[0][0];
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (a[i][i] >= *best) {
      *best = a[i][i];
      k = i;
    }
  return k;
}

// v[k] for a k known only at run time, selected (not indexed: no local memory).
EIG4_FN double pick(const double v[4], int k) { return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3]; }

}  // namespace eig4

#ifdef __CUDACC__
namespace {

__global__ void __launch_bounds__(eig4::kBlock)
    eig4_kernel(const float* __restrict__ in, float* __restrict__ vec, float* __restrict__ val, int n,
                int* __restrict__ sweeps) {
  using namespace eig4;
  const int t = blockIdx.x * kBlock + threadIdx.x, m = t / kLanes, r = t % kLanes;
  if (m >= n) return;  // the matrix's four lanes together
  const unsigned group = 0xfu << (threadIdx.x & 28u);  // the matrix's lanes in the warp
  double a[4][4], v[1][4];
  const double tol = kTol * jacobi::root(load_lower(in + 16 * m, a));
#pragma unroll
  for (int c = 0; c < 4; ++c) v[0][c] = c == r ? 1.0 : 0.0;
  const int s = diagonalize<1>(a, v, tol);
  double best;
  const int k = top(a, &best);
  const double col = pick(v[0], k);
  double n2 = col * col;
  n2 += __shfl_xor_sync(group, n2, 1);
  n2 += __shfl_xor_sync(group, n2, 2);
  vec[kLanes * m + r] = static_cast<float>(col * jacobi::inv_root(n2));
  if (r == 0) {
    if (val != nullptr) val[m] = static_cast<float>(best);
    if (sweeps != nullptr) sweeps[m] = s;
  }
}

}  // namespace

// `in` is [n, 4, 4] float32 (symmetric, row-major; the lower triangle is
// read), `vec` [n, 4] float32, on the device; `val` ([n] float32, the
// largest eigenvalues) and `sweeps` ([n] int32, the Jacobi sweeps each
// matrix took) may be null. Launches on `stream` (a cudaStream_t). Returns
// 0 or the cudaError of the launch.
extern "C" int eig4_launch(const void* in, void* vec, void* val, int n, void* sweeps, void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + eig4::kBlock / eig4::kLanes - 1) / (eig4::kBlock / eig4::kLanes);
  eig4_kernel<<<blocks, eig4::kBlock, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(vec), static_cast<float*>(val), n,
      static_cast<int*>(sweeps));
  return static_cast<int>(cudaGetLastError());
}
#else
// The same function on a host, matrix after matrix: V's four rows rotated in
// one place, the butterfly's sum as the lanes form it.
extern "C" int eig4_host(const float* in, float* vec, float* val, int n, int* sweeps) {
  using namespace eig4;
  for (int m = 0; m < n; ++m) {
    double a[4][4], v[4][4];
    const double tol = kTol * jacobi::root(load_lower(in + 16 * m, a));
    for (int i = 0; i < 4; ++i)
      for (int c = 0; c < 4; ++c) v[i][c] = c == i ? 1.0 : 0.0;
    const int s = diagonalize<4>(a, v, tol);
    double best;
    const int k = top(a, &best);
    double col[4];
    for (int i = 0; i < 4; ++i) col[i] = pick(v[i], k);
    const double n2 = (col[0] * col[0] + col[1] * col[1]) + (col[2] * col[2] + col[3] * col[3]);
    const double inv = jacobi::inv_root(n2);
    for (int i = 0; i < 4; ++i) vec[4 * m + i] = static_cast<float>(col[i] * inv);
    if (val != nullptr) val[m] = static_cast<float>(best);
    if (sweeps != nullptr) sweeps[m] = s;
  }
  return 0;
}
#endif
