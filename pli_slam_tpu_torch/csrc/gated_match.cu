// Fused gated Hamming nearest-neighbour search for Hopper (sm_90a).
//
// Replaces the TPU kernel pli_slam_tpu/ops/pallas/hamming.py
// (`_kernel`, launched by `gated_match_pallas`). For every frame feature i
// it finds, among store rows j that pass
//     du*du + dv*dv <= r*r   (du, dv = frame uv - projected store uv)
//     && fvalid[i] && svalid[j]
// the row with the smallest Hamming distance (256 - <f_i, s_j>) / 2 of
// the +-1 int8 descriptors, the lowest such row on a tie, and the
// smallest distance over every OTHER row (an exact duplicate of the
// winner gives second == best). A feature with no passing row gets
// idx = -1 and best = second = 1e9. The kernel also writes the
// acceptance flag ok = fvalid && best <= max_dist && idx >= 0 &&
// (no ratio test || best < ratio * second). The [N, P] distance matrix is
// never written, not even to shared memory.
//
// What bounds it on an H100: the product, 2*N*P*256 int8 operations. A
// tracking call (N=1200 features x P=4096 local-map rows) is 2.52 G
// operations, 1.27 us at the tensor cores' 1,979 TOP/s; its inputs and
// outputs are 1.41 MB, 0.42 us at 3.35 TB/s. A keyframe fuse (P=16384) is
// 10.07 G operations, 5.09 us, against 4.67 MB, 1.39 us. Both are bound
// by operations, and only the tensor cores reach that rate: the CUDA
// cores' __dp4a issues about 1/17 of it. With the product on the tensor
// cores, what is left on the CUDA cores is the gate, N*P float tests: the
// design keeps that to a few instructions for a pair that is far apart.
//
// Design:
//  * the product runs as wgmma.mma_async m64n128k32 s8 x s8 -> s32: one
//    consumer warpgroup per 64 frame rows, 128 store rows per tile, eight
//    k-steps for K=256, accumulators in registers. s32 sums are exact for
//    any int8 input (zero rows of padded slots included);
//  * both operands are K-major already ([rows, 256] int8), which is what
//    wgmma reads from shared memory. TMA (cp.async.bulk.tensor with a
//    128-byte swizzle, one tensor map per operand, encoded on the host for
//    each call) copies them. A producer warp issues the copies: the block's
//    frame tile once, store tiles through a ring of kStages buffers. A
//    "landed" mbarrier per buffer tells the consumers a tile is there, a
//    "read" mbarrier tells the producer every consumer warp is done with
//    it, so copies run ahead of the product and the warpgroups drift apart:
//    one's epilogue overlaps another's product. Rows past N or P are
//    zero-filled by the TMA unit and masked by row index: no divisibility
//    test on N or P;
//  * kWarpgroups warpgroups of a block share each store tile, which
//    halves the L2 traffic per product. grid.y splits the store into
//    chunks; the host sizes them from the shape and the card's SM count
//    (plan_chunk_tiles) so that the grid is one wave of two blocks to an
//    SM: 160 blocks of 2 tiles at P=4096 and 260 blocks of 5 tiles at
//    P=16384 on 132 SMs;
//  * validity is folded into the gate: an invalid or out-of-range row gets
//    NaN coordinates, so its gate compares false with no extra test. The
//    gate uses __fsub_rn/__fmul_rn/__fadd_rn so nvcc cannot fuse it into an
//    FMA: it rounds exactly like the plain PyTorch version, whose du*du,
//    dv*dv and sum are separate float32 kernels. Before it comes a cheaper
//    test that never rejects what the gate accepts (the larger of |du| and
//    |dv| against a radius a little above r), one compare and one branch
//    for four pairs: most pairs are far apart and cost two subtractions and
//    two or three min/max;
//  * the epilogue runs on the accumulator fragments. A thread sees two
//    rows and, per tile, 32 of their columns, in ascending order, and folds
//    them into (best, idx, second) without a branch. The four lanes of a
//    quad share a row, and blocks finish in no order, so partial results
//    are merged with an order-free rule: the winner is the lexicographic
//    minimum of (distance, row), and second = min(loser's best, both
//    seconds). That associative, commutative merge serves the quad
//    (__shfl_xor_sync) and the chunks across blocks
//    (`merge_partials_reference` in ops/kernels/hamming.py is its plain
//    twin);
//  * one launch: each block writes its chunk's partials and takes a
//    ticket for its row tile (atomicAdd after __threadfence); the block
//    that draws the last ticket merges the chunks, writes idx, best,
//    second and ok, and puts the ticket back to 0 for the next call.
// Nothing here synchronises with the host or allocates: the radius is
// read from device memory when it is a device scalar, and the launch goes
// on the caller's stream.

#include <cstdint>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>

#ifndef GM_WARPGROUPS
#define GM_WARPGROUPS 2  // consumer warpgroups per block, 64 frame rows each
#endif
#ifndef GM_STAGES
#define GM_STAGES 2  // shared-memory ring of store tiles
#endif
// -DGM_CHUNK_TILES=k fixes the store tiles per block; otherwise the shape and the card decide (plan_chunk_tiles).
// -DGM_TWO_PASS merges the chunks in a second kernel; -DGM_NO_EPILOGUE leaves the gate and the fold out (wrong
// results): both exist so that utils/kernel_bench.py can time what the ticket and the epilogue cost.


namespace {

constexpr int kK = 256;                         // descriptor bytes per row
constexpr int kAtom = 128;                      // bytes of K per 128-byte swizzle atom
constexpr int kWarpgroups = GM_WARPGROUPS;
constexpr int kBlockRows = 64 * kWarpgroups;    // frame rows per block
constexpr int kConsumers = 128 * kWarpgroups;   // consumer threads; the producer warp comes after them
constexpr int kThreads = kConsumers + 32;
constexpr int kTile = 128;                      // store rows per wgmma (its N)
constexpr int kStages = GM_STAGES;
constexpr int kMaxChunkTiles = 15;              // store tiles per block at most: their uv stay in shared memory
constexpr int kFrameBytes = kBlockRows * kK;
constexpr int kStageBytes = kTile * kK;
constexpr int kUvBytes = kMaxChunkTiles * kTile * 8;
constexpr int kSmemBytes = 1024 + kFrameBytes + kStages * kStageBytes + kUvBytes + 128;
constexpr float kBig = 1e9f;
constexpr unsigned long long kWaitLimitNs = 2000000000ull;  // a copy that has not landed by then traps
// two blocks on an SM where their shared memory allows it
constexpr int kMinBlocks = 2 * (kSmemBytes + 1024) <= 232448 ? 2 : 1;

static_assert(kStages >= 1 && kStages <= 7 && kBlockRows <= 256, "TMA boxes hold at most 256 rows");

struct Top {  // best distance, its store row, and the best distance over every other row
  float best;
  int idx;
  float second;
};

__device__ __forceinline__ Top merge(const Top& a, const Top& b) {
  const bool a_wins = a.best < b.best || (a.best == b.best && a.idx < b.idx);
  Top r;
  r.best = a_wins ? a.best : b.best;
  r.idx = a_wins ? a.idx : b.idx;
  r.second = fminf(a_wins ? b.best : a.best, fminf(a.second, b.second));
  return r;
}

// One more column into a thread's running result, without a branch. A thread
// meets its columns in ascending order, so a tie never displaces the winner; a
// pair that fails the gate comes as kBig and changes nothing.
__device__ __forceinline__ void fold(Top& t, float d, int col) {
  const bool win = d < t.best;
  t.second = win ? t.best : fminf(t.second, d);
  t.idx = win ? col : t.idx;
  t.best = fminf(t.best, d);
}

// The gate in the plain version's own arithmetic, then the fold.
__device__ __forceinline__ void gate_and_fold(Top& t, float du, float dv, float r2, int dot, int col) {
  const bool pass = __fadd_rn(__fmul_rn(du, du), __fmul_rn(dv, dv)) <= r2;
  fold(t, pass ? static_cast<float>(kK - dot) * 0.5f : kBig, col);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// Waits for the phase of `parity` to complete. A copy that never lands (a
// refused tensor map) traps after kWaitLimitNs instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  unsigned long long t0 = 0;
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    unsigned long long now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (t0 == 0) t0 = now;
    if (now - t0 > kWaitLimitNs) __trap();
  }
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Both 128-byte halves of K of `rows`-row boxes starting at `row`, into one tile.
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, int row, int rows, uint32_t bar) {
  mbar_expect_tx(bar, rows * kK);
  tma_load_2d(dst, map, 0, row, bar);
  tma_load_2d(dst + rows * kAtom, map, kAtom, row, bar);
}

// Shared-memory matrix descriptor of a K-major tile of 128-byte rows under
// the 128-byte swizzle: groups of 8 rows lie 1024 bytes apart.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]), "+r"(d[7]),
        "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),
        "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]),
        "+r"(d[24]), "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31]),
        "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]),
        "+r"(d[48]), "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),
        "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Final values of one frame row from its merged partial.
__device__ __forceinline__ void write_row(const Top& t, int row, const unsigned char* fvalid, float max_dist,
                                          float ratio, int use_ratio, int* idx, float* best, float* second,
                                          unsigned char* ok) {
  const int i = t.best < kBig ? t.idx : -1;
  bool good = fvalid[row] != 0 && t.best <= max_dist && i >= 0;
  if (use_ratio) good = good && t.best < __fmul_rn(ratio, t.second);
  idx[row] = i;
  best[row] = t.best;
  second[row] = t.second;
  ok[row] = good ? 1 : 0;
}

// One row's partials of chunks first, first + step, ... merged. The loads of
// several chunks are in flight together: the merge runs at the very end of the
// kernel, where each trip to the L2 cache is idle time on the whole card.
__device__ __forceinline__ Top merge_chunks(const float* pbest, const float* psecond, const int* pidx, int n,
                                            int n_chunks, int row, int first, int step) {
  Top t = {kBig, -1, kBig};
#pragma unroll 4
  for (int c = first; c < n_chunks; c += step) {
    const size_t o = static_cast<size_t>(c) * n + row;
    const Top part = {__ldcg(pbest + o), __ldcg(pidx + o), __ldcg(psecond + o)};
    t = merge(t, part);
  }
  return t;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
gated_match_kernel(const __grid_constant__ CUtensorMap map_frame, const __grid_constant__ CUtensorMap map_store,
                   const float2* __restrict__ fuv, const unsigned char* __restrict__ fvalid,
                   const float2* __restrict__ suv, const unsigned char* __restrict__ svalid,
                   const float* __restrict__ r_dev, float r_host, float max_dist, float ratio, int use_ratio,
                   int n, int p, int chunk_tiles, int n_chunks, float* __restrict__ pbest,
                   float* __restrict__ psecond, int* __restrict__ pidx, unsigned int* __restrict__ tickets,
                   int* __restrict__ idx, float* __restrict__ best, float* __restrict__ second,
                   unsigned char* __restrict__ ok) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on that boundary
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t s_frame = smem_u32(smem);
  const uint32_t s_stage = s_frame + kFrameBytes;
  float2* s_uv = reinterpret_cast<float2*>(smem + kFrameBytes + kStages * kStageBytes);
  // barriers: [0] frame tile landed, [1 + s] store stage s landed, [1 + kStages + s] stage s read by every consumer warp
  const uint32_t s_bar = smem_u32(smem + kFrameBytes + kStages * kStageBytes + kUvBytes);
  int* s_last = reinterpret_cast<int*>(smem + kFrameBytes + kStages * kStageBytes + kUvBytes + 120);

  const int tid = threadIdx.x;
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32, quad = lane % 4;
  const int row0 = blockIdx.x * kBlockRows;
  const int c0 = blockIdx.y * chunk_tiles * kTile;
  const int n_tiles = min(chunk_tiles, (p - c0 + kTile - 1) / kTile);
  if (tid == kConsumers) {  // the producer: one lane of the last warp
    mbar_init(s_bar, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(s_bar + 8 * (1 + s), 1);
      mbar_init(s_bar + 8 * (1 + kStages + s), 4 * kWarpgroups);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    load_tile(s_frame, &map_frame, row0, kBlockRows, s_bar);
    for (int t = 0; t < min(kStages, n_tiles); ++t)
      load_tile(s_stage + t * kStageBytes, &map_store, c0 + t * kTile, kTile, s_bar + 8 * (1 + t));
  }
  // This thread's two frame rows (accumulator rows lane/4 and lane/4 + 8 of its warp's 16; the
  // producer warp's values are not used) and the radius, asked for before anything waits.
  const int row_a = row0 + wg * 64 + warp * 16 + lane / 4, row_b = row_a + 8;
  float2 uv_a = fuv[min(row_a, n - 1)], uv_b = fuv[min(row_b, n - 1)];
  const bool ok_a = row_a < n && fvalid[min(row_a, n - 1)] != 0, ok_b = row_b < n && fvalid[min(row_b, n - 1)] != 0;
  const float r = r_dev != nullptr ? *r_dev : r_host;
  // The chunk's store coordinates, NaN where the row is invalid or past P. The
  // flag and the coordinates are loaded side by side (the row clamped), not
  // one after the other.
  const float nan = __int_as_float(0x7fc00000);
  for (int i = tid; i < n_tiles * kTile; i += kThreads) {
    const int j = min(c0 + i, p - 1);
    const float2 v = suv[j];
    s_uv[i] = (c0 + i < p && svalid[j] != 0) ? v : make_float2(nan, nan);
  }
  __syncthreads();  // the barriers are initialised and s_uv is filled

  if (tid == kConsumers) {
    // refill each stage once every consumer warp has read the tile before
    for (int t = kStages; t < n_tiles; ++t) {
      const int stage = t % kStages;
      mbar_wait(s_bar + 8 * (1 + kStages + stage), (t / kStages - 1) & 1);
      load_tile(s_stage + stage * kStageBytes, &map_store, c0 + t * kTile, kTile, s_bar + 8 * (1 + stage));
    }
  } else if (tid < kConsumers) {
    if (!ok_a) uv_a = make_float2(nan, nan);
    if (!ok_b) uv_b = make_float2(nan, nan);
    const float r2 = __fmul_rn(r, r);
    // A cheap test that never rejects what the gate accepts: beyond r_far in u or
    // in v the rounded squares already exceed r2 (1e-18 keeps the square out of
    // the underflow range; an overflowed r2 accepts everything that is not NaN).
    const float inf = __int_as_float(0x7f800000);
    const float r_far = r2 < inf ? fmaxf(fabsf(r) * 1.0009765625f, 1e-18f) : inf;
    Top top_a = {kBig, -1, kBig}, top_b = {kBig, -1, kBig};

    mbar_wait(s_bar, 0);
    const uint64_t desc_a = smem_desc(s_frame + wg * 64 * kAtom);
    int acc[64];
    for (int t = 0; t < n_tiles; ++t) {
      const int stage = t % kStages;
      mbar_wait(s_bar + 8 * (1 + stage), (t / kStages) & 1);
      const uint64_t desc_b = smem_desc(s_stage + stage * kStageBytes);
      asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < kK / 32; ++ks) {
        // 32 bytes of K per step: 2 descriptor units inside an atom, then the next atom's tile
        const uint64_t step_a = (ks / 4) * ((kBlockRows * kAtom) >> 4) + (ks % 4) * 2;
        const uint64_t step_b = (ks / 4) * ((kTile * kAtom) >> 4) + (ks % 4) * 2;
        wgmma_m64n128k32_s8(acc, desc_a + step_a, desc_b + step_b, ks != 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(acc[i])::"memory");
      if (lane == 0) mbar_arrive(s_bar + 8 * (1 + kStages + stage));  // this warp is done with the stage

      // acc[4j + e]: row_a, column 8j + 2*quad + e; acc[4j + 2 + e]: row_b, same column
      const float2* uv_tile = s_uv + t * kTile + 2 * quad;
      const int col0 = c0 + t * kTile + 2 * quad;
#ifdef GM_NO_EPILOGUE
      top_a.idx += acc[0] + acc[63];  // keeps the product alive
#else
#pragma unroll
      for (int j = 0; j < kTile / 8; ++j) {
        const float4 s = *reinterpret_cast<const float4*>(uv_tile + 8 * j);  // two columns' (u, v)
        const int col = col0 + 8 * j;
        const float du_a0 = __fsub_rn(uv_a.x, s.x), dv_a0 = __fsub_rn(uv_a.y, s.y);
        const float du_a1 = __fsub_rn(uv_a.x, s.z), dv_a1 = __fsub_rn(uv_a.y, s.w);
        const float du_b0 = __fsub_rn(uv_b.x, s.x), dv_b0 = __fsub_rn(uv_b.y, s.y);
        const float du_b1 = __fsub_rn(uv_b.x, s.z), dv_b1 = __fsub_rn(uv_b.y, s.w);
        // The larger of |du| and |dv| of the nearest of the four pairs against r_far: one compare
        // and one branch for four pairs. (fmaxf and fminf drop a NaN operand, so an invalid row
        // may pass here; the gate below still rejects it.) It passes rarely, since most columns
        // are far from most rows; then all four pairs go through the gate side by side with no
        // further branch, which is quicker than picking out the near ones.
        const float far_a = fminf(fmaxf(fabsf(du_a0), fabsf(dv_a0)), fmaxf(fabsf(du_a1), fabsf(dv_a1)));
        const float far_b = fminf(fmaxf(fabsf(du_b0), fabsf(dv_b0)), fmaxf(fabsf(du_b1), fabsf(dv_b1)));
        if (fminf(far_a, far_b) <= r_far) {
          gate_and_fold(top_a, du_a0, dv_a0, r2, acc[4 * j], col);
          gate_and_fold(top_a, du_a1, dv_a1, r2, acc[4 * j + 1], col + 1);
          gate_and_fold(top_b, du_b0, dv_b0, r2, acc[4 * j + 2], col);
          gate_and_fold(top_b, du_b1, dv_b1, r2, acc[4 * j + 3], col + 1);
        }
      }
#endif
    }

    // the four lanes of a quad hold the same two rows
#pragma unroll
    for (int m = 1; m <= 2; m <<= 1) {
      Top o_a, o_b;
      o_a.best = __shfl_xor_sync(0xffffffffu, top_a.best, m);
      o_a.idx = __shfl_xor_sync(0xffffffffu, top_a.idx, m);
      o_a.second = __shfl_xor_sync(0xffffffffu, top_a.second, m);
      o_b.best = __shfl_xor_sync(0xffffffffu, top_b.best, m);
      o_b.idx = __shfl_xor_sync(0xffffffffu, top_b.idx, m);
      o_b.second = __shfl_xor_sync(0xffffffffu, top_b.second, m);
      top_a = merge(top_a, o_a);
      top_b = merge(top_b, o_b);
    }
    if (quad == 0) {
      if (row_a < n) {
        const size_t o = static_cast<size_t>(blockIdx.y) * n + row_a;
        pbest[o] = top_a.best, pidx[o] = top_a.idx, psecond[o] = top_a.second;
      }
      if (row_b < n) {
        const size_t o = static_cast<size_t>(blockIdx.y) * n + row_b;
        pbest[o] = top_b.best, pidx[o] = top_b.idx, psecond[o] = top_b.second;
      }
    }
  }

#ifndef GM_TWO_PASS
  // The block that draws its row tile's last ticket merges the chunks.
  __threadfence();
  __syncthreads();
  if (tid == 0) *s_last = atomicAdd(&tickets[blockIdx.x], 1u) == static_cast<unsigned>(n_chunks - 1);
  __syncthreads();
  if (!*s_last) return;
  __threadfence();
  if (tid < kConsumers) {  // two neighbouring lanes per row, each merging every other chunk
    const int row = min(row0 + tid / 2, n - 1);
    Top t = merge_chunks(pbest, psecond, pidx, n, n_chunks, row, tid % 2, 2);
    Top o;
    o.best = __shfl_xor_sync(0xffffffffu, t.best, 1);
    o.idx = __shfl_xor_sync(0xffffffffu, t.idx, 1);
    o.second = __shfl_xor_sync(0xffffffffu, t.second, 1);
    if (tid % 2 == 0 && row0 + tid / 2 < n)
      write_row(merge(t, o), row, fvalid, max_dist, ratio, use_ratio, idx, best, second, ok);
  }
  if (tid == 0) tickets[blockIdx.x] = 0;
#endif
}

// The chunks' merge as a kernel of its own: the whole answer for an empty
// store (no chunks: every row unmatched), and the second pass of a build
// with -DGM_TWO_PASS, which exists to time the ticket against it.
__global__ void gated_match_merge(const float* __restrict__ pbest, const float* __restrict__ psecond,
                                  const int* __restrict__ pidx, const unsigned char* __restrict__ fvalid,
                                  float max_dist, float ratio, int use_ratio, int n, int n_chunks,
                                  int* __restrict__ idx, float* __restrict__ best, float* __restrict__ second,
                                  unsigned char* __restrict__ ok) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n)
    write_row(merge_chunks(pbest, psecond, pidx, n, n_chunks, row, 0, 1), row, fvalid, max_dist, ratio, use_ratio,
              idx, best, second, ok);
}

PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static const PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      f = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(f);
  }();
  return fn;
}

// Tensor map of a [rows, 256] int8 matrix, read in boxes of `box_rows` rows by
// 128 bytes of K under the 128-byte swizzle; rows past the end read as zeros.
int encode_map(CUtensorMap* map, const void* base, int rows, int box_rows) {
  const cuuint64_t dims[2] = {kK, static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {kK};
  const cuuint32_t box[2] = {kAtom, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return static_cast<int>(encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims,
                                         strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                         CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// Store tiles per block for this shape on a card of `sms` SMs: one wave of
// blocks, two to an SM.
int plan_chunk_tiles(int n, int p, int sms) {
#ifdef GM_CHUNK_TILES
  return GM_CHUNK_TILES;
#else
  const long total = static_cast<long>((n + kBlockRows - 1) / kBlockRows) * ((p + kTile - 1) / kTile);
  const long tiles = (total + 2 * sms - 1) / (2 * sms);
  return static_cast<int>(tiles < 1 ? 1 : tiles > kMaxChunkTiles ? kMaxChunkTiles : tiles);
#endif
}

int sm_count() {
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return sms > 0 ? sms : 1;
}

}  // namespace

// Chunks of the store (blocks along grid.y, rows of partials in `scratch`) for this shape on the current device.
extern "C" int gated_match_chunks(int n, int p) {
  if (n <= 0 || p <= 0) return 0;
  const int rows = plan_chunk_tiles(n, p, sm_count()) * kTile;
  return (p + rows - 1) / rows;
}
extern "C" int gated_match_block_rows() { return kBlockRows; }

// All pointers are device pointers; `stream` is a cudaStream_t. The radius is
// `*r_dev` when r_dev is not null, else r_host. `scratch` holds
// 3 * gated_match_chunks(n, p) * n 4-byte words; `tickets` holds
// ceil(n / block_rows) zeros and is left zeroed. `best_second_idx` is [3, n]
// 4-byte words (best, second: float32; idx: int32), `ok` is n bytes.
// Returns 0, a cudaError from the launch, or 100000 + CUresult when a tensor
// map could not be encoded.
extern "C" int gated_match_launch(const void* fdesc, const void* fuv, const void* fvalid, const void* sdesc,
                                  const void* suv, const void* svalid, const void* r_dev, float r_host,
                                  float max_dist, float ratio, int use_ratio, int n, int p, void* scratch,
                                  void* tickets, void* best_second_idx, void* ok, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0) return 0;
  float* best = static_cast<float*>(best_second_idx);
  float* second = best + n;
  int* idx = reinterpret_cast<int*>(second + n);
  const unsigned char* fv = static_cast<const unsigned char*>(fvalid);
  unsigned char* okp = static_cast<unsigned char*>(ok);
  const int chunk_tiles = p > 0 ? plan_chunk_tiles(n, p, sm_count()) : 1;
  const int n_chunks = p > 0 ? (p + chunk_tiles * kTile - 1) / (chunk_tiles * kTile) : 0;
  const size_t part = static_cast<size_t>(n_chunks) * n;
  float* pbest = static_cast<float*>(scratch);
  float* psecond = pbest + part;
  int* pidx = reinterpret_cast<int*>(psecond + part);
  if (p <= 0) {
    gated_match_merge<<<(n + 127) / 128, 128, 0, st>>>(pbest, psecond, pidx, fv, max_dist, ratio, use_ratio, n, 0,
                                                        idx, best, second, okp);
    return static_cast<int>(cudaGetLastError());
  }
  static bool configured[64] = {};
  int device = 0;
  cudaGetDevice(&device);
  if (device < 0 || device >= 64 || !configured[device]) {
    if (encode_tiled() == nullptr) return 100000 + static_cast<int>(CUDA_ERROR_NOT_FOUND);
    const cudaError_t e =
        cudaFuncSetAttribute(gated_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (device >= 0 && device < 64) configured[device] = true;
  }
  CUtensorMap map_frame, map_store;
  int e = encode_map(&map_frame, fdesc, n, kBlockRows);
  if (e == 0) e = encode_map(&map_store, sdesc, p, kTile);
  if (e != 0) return 100000 + e;

  const dim3 grid((n + kBlockRows - 1) / kBlockRows, n_chunks);
  gated_match_kernel<<<grid, kThreads, kSmemBytes, st>>>(
      map_frame, map_store, static_cast<const float2*>(fuv), fv, static_cast<const float2*>(suv),
      static_cast<const unsigned char*>(svalid), static_cast<const float*>(r_dev), r_host, max_dist, ratio,
      use_ratio, n, p, chunk_tiles, n_chunks, pbest, psecond, pidx, static_cast<unsigned int*>(tickets), idx, best,
      second, okp);
#ifdef GM_TWO_PASS
  gated_match_merge<<<(n + 127) / 128, 128, 0, st>>>(pbest, psecond, pidx, fv, max_dist, ratio, use_ratio, n,
                                                      n_chunks, idx, best, second, okp);
#endif
  return static_cast<int>(cudaGetLastError());
}
