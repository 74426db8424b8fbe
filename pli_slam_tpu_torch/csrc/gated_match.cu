// Fused gated Hamming nearest-neighbour search for Hopper (sm_90a).
//
// Replaces the TPU kernel pli_slam_tpu/ops/pallas/hamming.py
// (`_kernel`, launched by `gated_match_pallas`). For every frame feature i
// it finds, among store rows j that pass
//     du*du + dv*dv <= r2   (du, dv = frame uv - projected store uv)
//     && fvalid[i] && svalid[j]
// the row with the smallest Hamming distance (256 - <f_i, s_j>) / 2 of
// the +-1 int8 descriptors, the lowest such row on a tie, and the
// smallest distance over every OTHER row (an exact duplicate of the
// winner gives second == best). A feature with no passing row gets
// idx = -1 and best = 1e9. The [N, P] distance matrix is never written.
//
// What bounds it on this card: N*P*256 int8 multiply-adds, ~1.26 G per
// tracking call (N=1200 features x P=4096 local-map rows) and ~5 G per
// keyframe fuse (P=16384). At __dp4a's rate (4 MACs per instruction) that
// is a few microseconds of issue across 132 SMs, and the inputs are
// 1.3 MB (4096 rows) to 4.4 MB, so at these sizes the launch and the
// host's synchronisation, not the arithmetic, set the pace.
//
// Design, kept simple and exact:
//  * one thread per frame row holds its 256-byte descriptor in 64
//    registers; a block of 128 threads covers 128 frame rows;
//  * grid.y splits the store into chunks of kChunk rows so that ~100+
//    blocks fill the SMs even though N is only ~1200; each block stages
//    its chunk through shared memory kTile rows at a time (every thread
//    reads the same row: a broadcast, no bank conflicts) and masks the
//    ragged tail, so P need not be a multiple of any tile;
//  * the dot is 64 __dp4a on int8x4 words: an exact integer for any int8
//    input (zero rows included), unlike a popcount on packed sign bits;
//  * the gate is computed with __fmul_rn/__fadd_rn so nvcc cannot fuse it
//    into an FMA: it rounds exactly like the plain PyTorch version, whose
//    du*du, dv*dv and sum are separate float32 kernels;
//  * each thread folds (best, second, idx) over its chunk in ascending
//    row order with strict '<', and a second tiny kernel folds the chunks
//    in ascending order with the Pallas kernel's cross-tile rule
//    (hamming.py:78-84), which keeps the lowest-row tie rule and the
//    "second = min over all other rows" rule across chunks.
// Nothing here synchronises: r2 is read from device memory (the tracking
// radius is a device scalar), and launches go on the caller's stream.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRowsPerBlock = 128;  // frame rows per block, one per thread
constexpr int kChunk = 256;         // store rows per block (grid.y)
constexpr int kTile = 32;           // store rows staged in shared memory at once
constexpr int kWords = 64;          // 256 int8 = 64 int32 words
constexpr int kVec = kWords / 4;    // int4 loads per descriptor row
constexpr float kBig = 1e9f;

__global__ void __launch_bounds__(kRowsPerBlock)
gated_match_partial(const int4* __restrict__ fdesc, const float2* __restrict__ fuv,
                    const unsigned char* __restrict__ fvalid, const int4* __restrict__ sdesc,
                    const float2* __restrict__ suv, const unsigned char* __restrict__ svalid,
                    const float* __restrict__ r2p, int n, int p, float* __restrict__ pbest,
                    float* __restrict__ psecond, int* __restrict__ pidx) {
  __shared__ int4 s_desc[kTile][kVec];
  __shared__ float2 s_uv[kTile];
  __shared__ unsigned char s_ok[kTile];

  const int row = blockIdx.x * kRowsPerBlock + threadIdx.x;
  const int c0 = blockIdx.y * kChunk;
  const int c_end = min(c0 + kChunk, p);
  const float r2 = *r2p;
  const bool have_row = row < n;

  int f[kWords];
  float2 uv = make_float2(0.f, 0.f);
  bool fok = false;
#pragma unroll
  for (int w = 0; w < kVec; ++w) {
    const int4 v = have_row ? fdesc[static_cast<size_t>(row) * kVec + w] : make_int4(0, 0, 0, 0);
    f[4 * w] = v.x;
    f[4 * w + 1] = v.y;
    f[4 * w + 2] = v.z;
    f[4 * w + 3] = v.w;
  }
  if (have_row) {
    uv = fuv[row];
    fok = fvalid[row] != 0;
  }

  float best = kBig, second = kBig;
  int idx = -1;
  for (int t0 = c0; t0 < c_end; t0 += kTile) {
    __syncthreads();
    for (int e = threadIdx.x; e < kTile * kVec; e += kRowsPerBlock) {
      const int r = e / kVec, w = e % kVec, j = t0 + r;
      s_desc[r][w] = j < c_end ? sdesc[static_cast<size_t>(j) * kVec + w] : make_int4(0, 0, 0, 0);
    }
    if (threadIdx.x < kTile) {
      const int j = t0 + threadIdx.x;
      s_uv[threadIdx.x] = j < c_end ? suv[j] : make_float2(0.f, 0.f);
      s_ok[threadIdx.x] = j < c_end ? svalid[j] : 0;
    }
    __syncthreads();
    const int nt = min(kTile, c_end - t0);
    for (int r = 0; r < nt; ++r) {
      int dot = 0;
#pragma unroll
      for (int w = 0; w < kVec; ++w) {
        const int4 s = s_desc[r][w];
        dot = __dp4a(f[4 * w], s.x, dot);
        dot = __dp4a(f[4 * w + 1], s.y, dot);
        dot = __dp4a(f[4 * w + 2], s.z, dot);
        dot = __dp4a(f[4 * w + 3], s.w, dot);
      }
      const float du = __fsub_rn(uv.x, s_uv[r].x);
      const float dv = __fsub_rn(uv.y, s_uv[r].y);
      const bool gate = fok && s_ok[r] != 0 && __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) <= r2;
      const float d = gate ? static_cast<float>(256 - dot) * 0.5f : kBig;
      if (d < best) {
        second = best;
        best = d;
        idx = t0 + r;
      } else if (d < second) {
        second = d;
      }
    }
  }
  if (have_row) {
    const size_t o = static_cast<size_t>(blockIdx.y) * n + row;
    pbest[o] = best;
    psecond[o] = second;
    pidx[o] = idx;
  }
}

__global__ void gated_match_merge(const float* __restrict__ pbest, const float* __restrict__ psecond,
                                  const int* __restrict__ pidx, int n, int n_chunks,
                                  float* __restrict__ best, float* __restrict__ second,
                                  int* __restrict__ idx) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  float b = kBig, s = kBig;
  int i = -1;
  for (int c = 0; c < n_chunks; ++c) {
    const size_t o = static_cast<size_t>(c) * n + row;
    const float cb = pbest[o];
    const bool better = cb < b;
    s = fminf(better ? b : cb, fminf(s, psecond[o]));
    if (better) {
      b = cb;
      i = pidx[o];
    }
  }
  best[row] = b;
  second[row] = s;
  idx[row] = i;
}

}  // namespace

extern "C" int gated_match_chunk_rows() { return kChunk; }

// All pointers are device pointers; `stream` is a cudaStream_t. Scratch
// `pbest`/`psecond`/`pidx` hold ceil(p / kChunk) * n entries each.
// Returns cudaGetLastError() after the launches.
extern "C" int gated_match_launch(const void* fdesc, const void* fuv, const void* fvalid,
                                  const void* sdesc, const void* suv, const void* svalid,
                                  const void* r2, int n, int p, void* pbest, void* psecond,
                                  void* pidx, void* best, void* second, void* idx, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (p + kChunk - 1) / kChunk;
  if (n > 0 && n_chunks > 0) {
    const dim3 grid((n + kRowsPerBlock - 1) / kRowsPerBlock, n_chunks);
    gated_match_partial<<<grid, kRowsPerBlock, 0, st>>>(
        static_cast<const int4*>(fdesc), static_cast<const float2*>(fuv),
        static_cast<const unsigned char*>(fvalid), static_cast<const int4*>(sdesc),
        static_cast<const float2*>(suv), static_cast<const unsigned char*>(svalid),
        static_cast<const float*>(r2), n, p, static_cast<float*>(pbest),
        static_cast<float*>(psecond), static_cast<int*>(pidx));
  }
  if (n > 0) {
    gated_match_merge<<<(n + 255) / 256, 256, 0, st>>>(
        static_cast<const float*>(pbest), static_cast<const float*>(psecond),
        static_cast<const int*>(pidx), n, n_chunks, static_cast<float*>(best),
        static_cast<float*>(second), static_cast<int*>(idx));
  }
  return static_cast<int>(cudaGetLastError());
}
