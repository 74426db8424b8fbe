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
// Method: one-sided (Hestenes) Jacobi on the columns of A in float64. Plane
// rotations applied on the right make the columns of B = A V mutually
// orthogonal: a pair (p, q) is rotated while |b_p . b_q| > sqrt(n) eps |b_p|
// |b_q| (LAPACK's gesvj test, compared squared), at most kSweeps sweeps; as
// gesvj does, a column whose norm is zero to float64 is not rotated. Then
// S = the column norms, sorted descending with V's columns, and U = B
// diag(1/S). It works on A itself and never forms A^T A, so the smallest
// singular vector's accuracy follows A's condition number, not its square
// (the fault of an eigenvector of A^T A in float32, ROADMAP queue 3 B5). The
// arithmetic is float64 because a float32 Jacobi's rotations round: on
// 12x12 systems its smallest singular vector lies ~1e-6 from the float64
// answer, farther than a float32 LAPACK SVD; in float64 the result is the
// float64 factorisation of the float32 input, rounded to float32 once.
//
// Layout: one warp a matrix, four warps (matrices) a block of 128 threads,
// so the main path's 256 matrices spread over 64 SMs. B and V live in
// shared memory as float64, each column contiguous with a padded stride
// (kStride = 13), 2 x 12 x 13 x 8 = 2,496 bytes a warp (3,888 with the
// tail's scratch, 15,552 a block), static and under 48 KB, so the launch
// needs no attribute and stays safe to capture. The kernel is a template on
// n (one instance for each n from 1 to 12), so the layout below, the row
// loops and the butterfly's rounds are constants and unrolled, and no
// integer division is left (a build with n at run time had 16 bytes of
// stack frame and spills, and took ~1.5x the cycles a step).
//
// Ordering: round-robin ("tournament", Brent and Luk's). An odd n gets one
// phantom column, n' = n rounded up to even; each step rotates n'/2
// disjoint pairs at once, and a sweep of n' - 1 steps visits every pair
// exactly once (`first_pair`, `next_pair`; ops/kernels/svd_small.py
// `schedule` is their copy for the tests). Pairs with the phantom column
// are skipped. Each pair gets `lanes` lanes, the largest power of two with
// n'/2 x lanes <= 32, and each lane ceil(n / lanes) rows (for n = 12: 6
// pairs of 4 lanes, 3 rows a lane; n = 3: 2 pairs of 16 lanes, 1 row). A
// lane loads its rows of b_p, b_q, v_p, v_q into registers, forms their
// parts of alpha = |b_p|^2, beta = |b_q|^2 and gamma = b_p . b_q, an xor
// butterfly sums them within the pair's lanes (every lane then holds the
// same sums, bit for bit, since float addition is commutative, so every
// lane derives the same rotation), and each lane stores its rotated rows.
// The round-robin ordering is one of the parallel orderings that Luk and
// Park (1989) showed equivalent to the cyclic-by-rows ordering: the same
// rotations up to a relabelling of the columns, hence the same global and
// asymptotically quadratic convergence. The 256 DLT systems of
// chip_smoke.py phase 3d take 1,805 sweeps in all, 1,897 in the cyclic
// order; a sweep is 11 steps in place of 66 serial rotations.
//
// What bounds it on an H100: not the card's rates but one dependent chain.
// A matrix brings 4 n^2 bytes in and 4 (2 n^2 + n) out (576 in for 12x12),
// and every step depends on the one before it: each step loads its rows
// from shared memory, sums them (three fma deep), reduces them over the
// butterfly (two shuffle rounds for 12x12), takes two float64 reciprocal
// square roots in series and stores the rotated rows before the warp
// synchronises. A general 12x12 matrix converges in ~7 sweeps, a chain of
// ~77 steps; a rank-deficient one (a point drawn twice among the DLT's
// six) in up to 16, 176 steps, and a launch lasts as long as its slowest
// matrix. Tensor cores and TMA do not serve: there is no product to tile
// and nothing to stream, 576 bytes a matrix arrive in one coalesced read,
// and the chain leaves nothing to overlap them with.
//
// Float64 sqrt and division are IEEE's on the card only through a slow-path
// subroutine, whose calling convention gave the kernel a stack frame and
// spills; `root` and `inv_root` (csrc/jacobi.cuh, shared with rot3.cu and
// eig4.cu) instead refine the hardware's approximation by Newton steps, and
// the rotation is written with reciprocal square roots alone (`rotation`).
//
// The tail runs over lanes: the column norms (a lane a column), the
// descending sort (a lane a column counts its rank), U = B diag(1/S) (a
// lane a column), the Gram-Schmidt completion of zero columns (lane k tries
// the unit vector e_k, the first accepted one is taken), the stores (lanes
// over entries).
//
// The arithmetic (`layout`, `first_pair`, `next_pair`, `fetch`, `partials`,
// `rotation`, `apply` and the tail's steps) also compiles as plain C++ (no
// __CUDACC__), with IEEE sqrt and division: `factor_host` there runs the
// warp's lanes one after another between the points where the warp
// synchronises, with the same butterfly, so the method can be run on a host
// (tests/test_torch_rare_stages.py holds it against its numpy transcription
// bit for bit). The card's build differs from it in the last bits (fused
// multiply-adds, the refined roots).

#include "jacobi.cuh"

#ifdef __CUDACC__
#define SVD_FN __host__ __device__ __forceinline__
#else
#define SVD_FN inline
#endif

namespace svd_small {

using jacobi::inv_root;
using jacobi::kEps;
using jacobi::root;
using jacobi::rotation;

constexpr int kMaxN = 12;
constexpr int kStride = kMaxN + 1;  // a column's stride in shared memory, padded
constexpr int kRows = 3;            // the most rows a lane takes (n = 9..12: 4 lanes a pair)
constexpr int kWarp = 32;
constexpr int kWarps = 4;  // matrices a block
constexpr int kSweeps = 30;

// One warp's matrix in shared memory: column j of B = A V at b[kStride * j],
// of V at v[kStride * j]; the tail's candidates, squared norms and column
// permutation.
struct Work {
  double b[kStride * kMaxN];
  double v[kStride * kMaxN];
  double cand[kStride * kMaxN];  // the completion's candidates, one a lane
  double nrm[kMaxN];             // column j's squared norm
  int perm[kMaxN];               // the column of sorted place j
};

struct Layout {
  int n, pairs, lanes, shift, steps;  // lanes a pair = 1 << shift; steps a sweep = n' - 1
};

SVD_FN Layout layout(int n) {
  Layout l;
  l.n = n;
  l.pairs = (n + 1) / 2;
  l.shift = 0;
  while (l.pairs << (l.shift + 1) <= kWarp) ++l.shift;
  l.lanes = 1 << l.shift;
  l.steps = 2 * l.pairs - 1;
  return l;
}

// Slot k's pair at the first step of a round-robin sweep over n' = 2 pairs
// columns (m = n' - 1 steps), and at the step after: column m meets s, the
// others meet across the circle of the m columns left, (s + k, s - k) mod m.
// The pair is (min, max) of (a, c); max == m == n is an odd n's phantom.
SVD_FN void first_pair(int k, int m, int* a, int* c) {
  *a = k == 0 ? m : k;
  *c = k == 0 ? 0 : m - k;
}

SVD_FN void next_pair(int k, int m, int* a, int* c) {
  if (k > 0) *a = *a + 1 == m ? 0 : *a + 1;
  *c = *c + 1 == m ? 0 : *c + 1;
}

// A lane's rows r = sub + lanes i below n of b_p, b_q, v_p, v_q, in
// registers for the step (on the card).
struct Rows {
  double bp[kRows], bq[kRows], vp[kRows], vq[kRows];
};

SVD_FN void fetch(const Work& w, const Layout& l, int p, int q, int sub, Rows& x) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = sub + (i << l.shift);
    if (r < l.n) {
      x.bp[i] = w.b[kStride * p + r];
      x.bq[i] = w.b[kStride * q + r];
      x.vp[i] = w.v[kStride * p + r];
      x.vq[i] = w.v[kStride * q + r];
    }
  }
}

// The lane's part of (alpha, beta, gamma) = (|b_p|^2, |b_q|^2, b_p . b_q).
SVD_FN void partials(const Layout& l, int sub, const Rows& x, double* sums) {
  sums[0] = sums[1] = sums[2] = 0.0;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (sub + (i << l.shift) < l.n) {
      sums[0] += x.bp[i] * x.bp[i];
      sums[1] += x.bq[i] * x.bq[i];
      sums[2] += x.bp[i] * x.bq[i];
    }
}

// The rotation applied to the lane's rows, stored back.
SVD_FN void apply(Work& w, const Layout& l, int p, int q, int sub, const Rows& x, double cs, double sn) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = sub + (i << l.shift);
    if (r < l.n) {
      w.b[kStride * p + r] = cs * x.bp[i] - sn * x.bq[i];
      w.b[kStride * q + r] = sn * x.bp[i] + cs * x.bq[i];
      w.v[kStride * p + r] = cs * x.vp[i] - sn * x.vq[i];
      w.v[kStride * q + r] = sn * x.vp[i] + cs * x.vq[i];
    }
  }
}

SVD_FN double dot(const double* a, const double* b, int n) {
  double s = 0.0;
  for (int r = 0; r < n; ++r) s += a[r] * b[r];
  return s;
}

// Entry e (of n^2) of the row-major input into B, and V = I.
SVD_FN void load(Work& w, const float* a, int n, int e) {
  const int r = e / n, j = e - n * r;
  w.b[kStride * j + r] = static_cast<double>(a[e]);
  w.v[kStride * j + r] = (r == j) ? 1.0 : 0.0;
}

// Column j's place in the descending order of the squared norms: the
// columns of larger norm, and those of equal norm before it (a stable sort).
SVD_FN int rank_of(const Work& w, int n, int j) {
  const double x = w.nrm[j];
  int r = 0;
  for (int i = 0; i < n; ++i) r += (w.nrm[i] > x || (i < j && w.nrm[i] == x)) ? 1 : 0;
  return r;
}

// Sorted column j: S_j, and B's column scaled to unit length unless it is zero.
SVD_FN void normalize(Work& w, int n, int j, float* s) {
  const double x = w.nrm[w.perm[j]];
  s[j] = static_cast<float>(root(x));
  if (x > 1e-300) {
    const double inv = inv_root(x);
    double* c = w.b + kStride * w.perm[j];
    for (int r = 0; r < n; ++r) c[r] *= inv;
  }
}

// Zero singular values, in sorted order: the first unit vector e_k that
// keeps at least 1 / (2n) of its squared length orthogonal to the columns
// before it (Gram-Schmidt, twice); the complement's projections of the n
// unit vectors sum to its dimension, so one keeps at least 1 / n.
// `candidate` makes e_k orthogonal to the sorted columns before j in c and
// returns its squared length; `accept` says whether it is the one.
SVD_FN double candidate(const Work& w, int n, int j, int k, double* c) {
  for (int r = 0; r < n; ++r) c[r] = (r == k) ? 1.0 : 0.0;
  for (int pass = 0; pass < 2; ++pass)
    for (int i = 0; i < j; ++i) {
      const double* ci = w.b + kStride * w.perm[i];
      const double d = dot(ci, c, n);
      for (int r = 0; r < n; ++r) c[r] -= d * ci[r];
    }
  return dot(c, c, n);
}

SVD_FN bool accept(int n, int k, double x) { return 2.0 * n * x > 1.0 || k == n - 1; }

// Entry e (of n^2) of the row-major outputs: u[r, j] and vt[j', r'].
SVD_FN void store(const Work& w, int n, int e, float* u, float* vt) {
  const int r = e / n, j = e - n * r;
  u[e] = static_cast<float>(w.b[kStride * w.perm[j] + r]);
  vt[e] = static_cast<float>(w.v[kStride * w.perm[r] + j]);
}

#ifndef __CUDACC__
// The warp on a host: each lane's part between two of the warp's
// synchronisations, lane after lane; the butterfly as the shuffles do it
// (own value + the partner's). Returns the sweeps.
inline int factor_host(const float* a, int n, float* u, float* s, float* vt) {
  Work w;
  const Layout l = layout(n);
  for (int e = 0; e < n * n; ++e) load(w, a, n, e);
  const double tol2 = n * kEps * kEps;
  int sw = 0;
  for (; sw < kSweeps; ++sw) {
    bool rotated = false;
    int pa[kWarp], pc[kWarp];
    for (int lane = 0; lane < kWarp; ++lane) first_pair(lane >> l.shift, l.steps, &pa[lane], &pc[lane]);
    for (int st = 0; st < l.steps; ++st) {
      double sums[kWarp][3], next[kWarp][3];
      Rows rows[kWarp];
      bool live[kWarp];
      int pp[kWarp], qq[kWarp];
      for (int lane = 0; lane < kWarp; ++lane) {
        if (st > 0) next_pair(lane >> l.shift, l.steps, &pa[lane], &pc[lane]);
        pp[lane] = pa[lane] < pc[lane] ? pa[lane] : pc[lane];
        qq[lane] = pa[lane] < pc[lane] ? pc[lane] : pa[lane];
        live[lane] = (lane >> l.shift) < l.pairs && qq[lane] < n;
        sums[lane][0] = sums[lane][1] = sums[lane][2] = 0.0;
        if (live[lane]) {
          fetch(w, l, pp[lane], qq[lane], lane & (l.lanes - 1), rows[lane]);
          partials(l, lane & (l.lanes - 1), rows[lane], sums[lane]);
        }
      }
      for (int off = 1; off < l.lanes; off <<= 1) {
        for (int lane = 0; lane < kWarp; ++lane)
          for (int c = 0; c < 3; ++c) next[lane][c] = sums[lane][c] + sums[lane ^ off][c];
        for (int lane = 0; lane < kWarp; ++lane)
          for (int c = 0; c < 3; ++c) sums[lane][c] = next[lane][c];
      }
      for (int lane = 0; lane < kWarp; ++lane) {
        double cs, sn;
        if (live[lane] && rotation(sums[lane], tol2, &cs, &sn)) {
          apply(w, l, pp[lane], qq[lane], lane & (l.lanes - 1), rows[lane], cs, sn);
          rotated = true;
        }
      }
    }
    if (!rotated) break;
  }
  for (int j = 0; j < n; ++j) {
    w.nrm[j] = dot(w.b + kStride * j, w.b + kStride * j, n);
    w.perm[j] = j;
  }
  for (int j = 0; j < n; ++j) w.perm[rank_of(w, n, j)] = j;
  for (int j = 0; j < n; ++j) normalize(w, n, j, s);
  for (int j = 0; j < n; ++j) {
    if (w.nrm[w.perm[j]] > 1e-300) continue;
    double* c = w.b + kStride * w.perm[j];
    for (int k = 0; k < n; ++k) {
      const double x = candidate(w, n, j, k, c);
      if (accept(n, k, x)) {
        const double inv = inv_root(x);
        for (int r = 0; r < n; ++r) c[r] *= inv;
        break;
      }
    }
  }
  for (int e = 0; e < n * n; ++e) store(w, n, e, u, vt);
  return sw;
}
#endif

}  // namespace svd_small

#ifdef __CUDACC__
namespace {

// One warp a matrix of N x N; the layout is a constant of each instance.
template <int N>
__global__ void __launch_bounds__(svd_small::kWarp * svd_small::kWarps)
    svd_small_kernel(const float* __restrict__ in, float* __restrict__ u, float* __restrict__ s,
                     float* __restrict__ vt, int count, int* __restrict__ sweeps) {
  using namespace svd_small;
  constexpr unsigned kAll = 0xffffffffu;
  __shared__ Work work[kWarps];
  const int lane = threadIdx.x & (kWarp - 1), warp = threadIdx.x >> 5;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= count) return;  // the whole warp: nothing below synchronises the block
  Work& w = work[warp];
  constexpr int sq = N * N;
  for (int e = lane; e < sq; e += kWarp) load(w, in + sq * m, N, e);
  __syncwarp();
  const Layout l = layout(N);
  const double tol2 = N * kEps * kEps;
  const int k = lane >> l.shift, sub = lane & (l.lanes - 1);
  int sw = 0;
  for (; sw < kSweeps; ++sw) {
    bool rotated = false;
    int a, c;
    first_pair(k, l.steps, &a, &c);
    for (int st = 0; st < l.steps; ++st) {
      if (st > 0) next_pair(k, l.steps, &a, &c);
      const int p = min(a, c), q = max(a, c);
      const bool live = k < l.pairs && q < N;  // a real pair, not the phantom column's
      Rows x;
      double sums[3] = {0.0, 0.0, 0.0};
      if (live) {
        fetch(w, l, p, q, sub, x);
        partials(l, sub, x, sums);
      }
#pragma unroll
      for (int off = 1; off < l.lanes; off <<= 1) {
#pragma unroll
        for (int i = 0; i < 3; ++i) sums[i] += __shfl_xor_sync(kAll, sums[i], off);
      }
      // every lane of the pair holds the same sums, bit for bit, so derives the same rotation; a pair that does
      // not rotate gets the identity, and its rows are stored back unchanged
      double cs, sn;
      rotated |= rotation(sums, tol2, &cs, &sn) && live;
      if (live) apply(w, l, p, q, sub, x, cs, sn);
      __syncwarp();
    }
    if (!__any_sync(kAll, rotated)) break;
  }
  if (lane < N) {
    w.nrm[lane] = dot(w.b + kStride * lane, w.b + kStride * lane, N);
    w.perm[lane] = lane;  // every place holds a column, whatever the ranks (NaN compares false)
  }
  __syncwarp();
  if (lane < N) w.perm[rank_of(w, N, lane)] = lane;
  __syncwarp();
  if (lane < N) normalize(w, N, lane, s + N * m);
  __syncwarp();
  for (int j = 0; j < N; ++j) {  // zero singular values: lane k tries e_k, the first accepted one is taken
    if (w.nrm[w.perm[j]] > 1e-300) continue;
    const double x = lane < N ? candidate(w, N, j, lane, w.cand + kStride * lane) : 0.0;
    const unsigned ok = __ballot_sync(kAll, lane < N && accept(N, lane, x));
    const int kk = __ffs(ok) - 1;  // lane N - 1 always accepts
    const double inv = inv_root(__shfl_sync(kAll, x, kk));
    if (lane < N) w.b[kStride * w.perm[j] + lane] = w.cand[kStride * kk + lane] * inv;
    __syncwarp();
  }
  for (int e = lane; e < sq; e += kWarp) store(w, N, e, u + sq * m, vt + sq * m);
  if (sweeps != nullptr && lane == 0) sweeps[m] = sw;
}

template <int N>
int launch(const float* in, float* u, float* s, float* vt, int count, int* sweeps, cudaStream_t stream) {
  using namespace svd_small;
  svd_small_kernel<N><<<(count + kWarps - 1) / kWarps, kWarp * kWarps, 0, stream>>>(in, u, s, vt, count, sweeps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// `in` is [count, n, n] float32 row-major on the device, n in 1..12; `u` and
// `vt` are [count, n, n], `s` [count, n], float32 on the device; `sweeps`
// ([count] int32, the Jacobi sweeps each matrix took) may be null. Launches
// on `stream` (a cudaStream_t). Returns 0, -1 for an n out of range, or the
// cudaError of the launch.
extern "C" int svd_small_launch(const void* in, void* u, void* s, void* vt, int count, int n, void* sweeps,
                                void* stream) {
  using Launch = int (*)(const float*, float*, float*, float*, int, int*, cudaStream_t);
  static constexpr Launch kLaunch[svd_small::kMaxN] = {launch<1>, launch<2>, launch<3>, launch<4>,
                                                        launch<5>, launch<6>, launch<7>, launch<8>,
                                                        launch<9>, launch<10>, launch<11>, launch<12>};
  if (n < 1 || n > svd_small::kMaxN) return -1;
  if (count <= 0) return 0;
  return kLaunch[n - 1](static_cast<const float*>(in), static_cast<float*>(u), static_cast<float*>(s),
                        static_cast<float*>(vt), count, static_cast<int*>(sweeps), static_cast<cudaStream_t>(stream));
}
#else
// The same factorisation on a host, matrix after matrix (`factor_host`).
extern "C" int svd_small_host(const float* in, float* u, float* s, float* vt, int count, int n, int* sweeps) {
  if (n < 1 || n > svd_small::kMaxN) return -1;
  for (int m = 0; m < count; ++m) {
    const int sq = n * n;
    const int sw = svd_small::factor_host(in + sq * m, n, u + sq * m, s + n * m, vt + sq * m);
    if (sweeps != nullptr) sweeps[m] = sw;
  }
  return 0;
}
#endif
