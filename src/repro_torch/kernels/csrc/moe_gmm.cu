// Ragged grouped matrix product over expert-sorted rows (MoE expert FFN)
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_gmm_kernel` of the JAX package
// (src/repro/kernels/moe_gmm.py:23, reached through `grouped_matmul` and the
// wrapper `ops.moe_gmm_ffn`).
//
// What it computes: xs [M, K] holds the routed rows sorted by expert, and
// group_sizes [E] (int32, on the device) says how many rows each expert
// has, in order; row r of expert e is multiplied by that expert's weight:
//   out[r, :] = xs[r, :] @ w[e, :, :]        (w [E, K, N], out [M, N])
// with f32 accumulation, written in xs's dtype.  group_sizes must sum to M.
//
// What it does not do: the reference copies the rows into a zero-padded
// [E, Cap, K] block so that the TPU's matrix unit sees fixed 128-row tiles,
// and its wrapper drops every row past Cap.  Here each BM-row tile lies
// inside one expert's group, found from the group sizes on the device, so
// nothing is padded, copied or dropped, and the host never reads the group
// sizes.  Row tiles number at most ceil(M / BM) + E (every group adds at
// most one partial tile): the float32 body launches that many blocks
// (block x finds its tile, those past the last exit at once); the bf16
// body's persistent blocks walk that many work items per column tile and
// stop at the real count.
//
// What bounds it on an H100: at granite-moe-1b-a400m's prefill (M = 65536
// routed rows, K 1024, N 512, bf16) it does 68.7 GFLOP and moves ~235 MB:
// 0.069 ms at the 989 TFLOP/s bf16 tensor-core peak against 0.070 ms at
// 3.35 TB/s, so both about equally.  In a decode step (64 rows over ~28
// experts) only the active experts' weights move: bytes, ~9 us.  The body
// it replaces (mma.sync + ldmatrix, 32-deep K slices in a two-stage
// cp.async ring) reached 20 % of that bound: one slice in flight could not
// hide the loads' latency.
//
// Design:
// - bfloat16 (`gmm_bf16`): warp-specialised, wgmma + TMA, persistent.  At
//   most one block per SM walks the work items (row tile, column tile) of
//   an output cut into BM x BN tiles, the row tiles looked up in a map of
//   the group sizes each block builds once (a prefix scan, then a binary
//   search per item).  Warpgroup 0 is the producer (one thread issues the
//   loads), BM / 64 consumer warpgroups own 64 rows each.  K slices are 64
//   deep (128 bytes, the swizzle span) in a four-stage ring paced by "full"
//   and "empty" mbarriers that runs on across items, so the next item's
//   first slices load while the consumers store the current one: A (xs,
//   K-major) by a 2-D tensor map, box {64, BM}; B (w[e], N-contiguous) by a
//   3-D map over [E, K, N], BN / 64 boxes of {64, 64, 1}, used as wgmma's
//   transposed B operand.  Each slice is four wgmma m64nBNk16 per consumer,
//   the next slice's products issued before the previous slice's stage is
//   released.  Two forms, chosen by the wrapper from M and E alone:
//     prefill (BM 128, BN 256): two consumers; 4 x 48 KB of stages.  A
//       128 x 128 tile reads 512 KB of A and B from L2 per 33.5 MFLOP at
//       K 1024; 128 x 256 halves the A traffic per product and cuts all
//       reads by a quarter.
//     decode (BM 64, BN 128, where rows per expert are few: 64 rows over
//       ~27 experts): one consumer, and twice the blocks to read weights.
//   TMA fills rows past M and columns past K or N with zeros; rows of the
//   tile past its group's end (the next expert's) are computed but not
//   stored, so the epilogue stores from registers with a row mask, not by
//   a TMA store.  -Xptxas -v on the H100 (nvcc 12.9): 168 registers at
//   BM 128 (384 threads; setmaxnreg 40 / 232), 90 at BM 64, no spills.
//   At granite's prefill gate/up launch on an H100, 128 x 256 tiles ran
//   faster than 128 x 128, and persistent blocks faster again (PERF.md).
// - bfloat16 gradient (`gmm_dx_bf16`, `gmm_dw_bf16`, entry points
//   moe_gmm_bwd_dx / moe_gmm_bwd_dw): no TPU kernel behind them (the JAX
//   package lets XLA differentiate its plain ragged_dot); they replace the
//   plain version's autograd, ~700 launches and a host read of the group
//   sizes a call.  At granite-moe's training shapes (32 768 routed rows,
//   1024 <-> 512) each does 34.4 GFLOP and moves ~100-130 MB, ~0.035-0.04
//   ms at either bound.  Design in the backward section below.
// - float32 (`gmm_f32`): scalar FMAs (TF32 would not keep float32's
//   digits), 64 x 64 tile, each of 256 threads owning 4 x 4 outputs,
//   16-deep K slices in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int MAX_EXPERTS = 1024;   // kernels/moe_gmm.py MAX_EXPERTS
constexpr int THREADS = 256;

// The block's tile: rows [row0, row1) of one expert `e`; row0 < 0 when the
// block lies past the last tile.  Every thread reads the result.
struct Tile {
    int e, row0, row1;
};

__device__ Tile find_tile(const int* __restrict__ group_sizes, int E, int M,
                          int bt, int* s_gs) {
    __shared__ Tile s_tile;
    for (int e = threadIdx.x; e < E; e += blockDim.x) s_gs[e] = group_sizes[e];
    __syncthreads();
    if (threadIdx.x == 0) {
        Tile t{-1, -1, -1};
        int start = 0, tiles = 0;
        const int want = blockIdx.x;
        for (int e = 0; e < E; ++e) {
            const int gs = s_gs[e];
            const int nt = (gs + bt - 1) / bt;
            if (want < tiles + nt) {
                t.e = e;
                t.row0 = start + (want - tiles) * bt;
                t.row1 = min(min(start + gs, t.row0 + bt), M);
                if (t.row0 >= M) t.row0 = -1;
                break;
            }
            tiles += nt;
            start += gs;
        }
        s_tile = t;
    }
    __syncthreads();
    return s_tile;
}

// ---------------------------------------------------------------- bfloat16

constexpr int TILE_ROWS_SMALL = 64;    // kernels/moe_gmm.py TILE_ROWS
constexpr int TILE_ROWS_LARGE = 128;
constexpr int BKS = 64;                // K slice per stage (128 bytes)
constexpr int STAGES = 4;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;     // 128 x 40 + 256 x 232 = 384 x 168

// Output columns per tile: 256 beside 128-row tiles (each slice's A and B
// serve twice the products a 128 x 128 tile gets from them), 128 beside
// 64-row ones, where the weights are what moves and more blocks read them.
template <int BM>
constexpr int TILE_COLS = BM == TILE_ROWS_LARGE ? 256 : 128;

template <int BM>
struct GmmSmem {
    bf16 a[STAGES][BM * BKS];                  // BM rows x 64 k
    bf16 b[STAGES][TILE_COLS<BM> / 64][BKS * 64];   // 64 k x 64 n boxes
    uint64_t full[STAGES], empty[STAGES];
};

// The row tiles of one launch, for a persistent block to look up: expert e
// owns tiles first_tile[e] .. first_tile[e + 1] - 1, whose rows start at
// first_row[e].  Built once per block (the sizes loaded by every thread,
// then scanned by warp 0, 32 experts a lane), read by every thread.
struct TileMap {
    int sizes[MAX_EXPERTS];
    int first_row[MAX_EXPERTS];
    int first_tile[MAX_EXPERTS];
    int total;     // row tiles in all
};

template <int BM>
__device__ void build_tile_map(TileMap& map, const int* __restrict__ gs,
                               int E) {
    for (int e = threadIdx.x; e < E; e += blockDim.x) map.sizes[e] = gs[e];
    __syncthreads();
    const int lane = threadIdx.x % 32;
    if (threadIdx.x < 32) {
        constexpr int PER = MAX_EXPERTS / 32;
        int rows = 0, tiles = 0;
        for (int i = 0; i < PER; ++i) {
            const int e = lane * PER + i;
            const int g = e < E ? map.sizes[e] : 0;
            rows += g;
            tiles += (g + BM - 1) / BM;
        }
        int rows_in = rows, tiles_in = tiles;   // inclusive scan over lanes
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
            const int r = __shfl_up_sync(0xffffffffu, rows_in, off);
            const int t = __shfl_up_sync(0xffffffffu, tiles_in, off);
            if (lane >= off) {
                rows_in += r;
                tiles_in += t;
            }
        }
        rows = rows_in - rows;
        tiles = tiles_in - tiles;
        for (int i = 0; i < PER; ++i) {
            const int e = lane * PER + i;
            if (e >= E) break;
            map.first_row[e] = rows;
            map.first_tile[e] = tiles;
            rows += map.sizes[e];
            tiles += (map.sizes[e] + BM - 1) / BM;
        }
        if (lane == 31) map.total = tiles_in;
    }
    __syncthreads();
}

// Row tile x (< map.total): the last expert whose first tile is <= x owns
// it (an empty expert shares its first tile with the next one).
template <int BM>
__device__ __forceinline__ Tile lookup_tile(const TileMap& map, int x, int E,
                                            int M) {
    int lo = 0, hi = E - 1;
    while (lo < hi) {
        const int mid = (lo + hi + 1) / 2;
        if (map.first_tile[mid] <= x) lo = mid; else hi = mid - 1;
    }
    Tile t;
    t.e = lo;
    t.row0 = map.first_row[lo] + (x - map.first_tile[lo]) * BM;
    t.row1 = min(min(map.first_row[lo] + map.sizes[lo], t.row0 + BM), M);
    return t;
}

// Persistent: gridDim.x blocks (at most one per SM) walk the work items
// (row tile, column tile) blockIdx.x, blockIdx.x + gridDim.x, ...; the
// ring runs on across items, so the producer loads the next item's first
// slices while the consumers store the current one.
template <int BM>
__global__ void __launch_bounds__(128 * (1 + BM / 64), 1)
gmm_bf16(const __grid_constant__ CUtensorMap tm_a,
         const __grid_constant__ CUtensorMap tm_b,
         const int* __restrict__ group_sizes, bf16* __restrict__ out,
         int M, int K, int N, int E) {
    using namespace hopper;
    constexpr int BN = TILE_COLS<BM>;
    constexpr int CONSUMERS = BM / 64;
    constexpr uint32_t STAGE_BYTES = (BM + BN) * BKS * 2;
    __shared__ TileMap map;
    extern __shared__ unsigned char smem_raw[];
    GmmSmem<BM>& sm = *reinterpret_cast<GmmSmem<BM>*>(align1024(smem_raw));

    if (threadIdx.x == 32) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&sm.full[s], 1);
            mbar_init(&sm.empty[s], 4 * CONSUMERS);
        }
        fence_barrier_init();
    }
    build_tile_map<BM>(map, group_sizes, E);   // ends in __syncthreads
    const int n_cols = (N + BN - 1) / BN;
    const int items = map.total * n_cols;
    const int nk = (K + BKS - 1) / BKS;

    if (threadIdx.x < 128) {
        // ------------------------------------------------------ producer
        if constexpr (CONSUMERS == 2) setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            int slice = 0;
            for (int item = blockIdx.x; item < items; item += gridDim.x) {
                const Tile tile = lookup_tile<BM>(map, item / n_cols, E, M);
                if (tile.row0 >= M) continue;
                const int n0 = (item % n_cols) * BN;
                for (int kt = 0; kt < nk; ++kt, ++slice) {
                    const int s = slice % STAGES;
                    mbar_wait(&sm.empty[s], ((slice / STAGES) & 1) ^ 1);
                    mbar_arrive_expect_tx(&sm.full[s], STAGE_BYTES);
                    tma_load_2d(sm.a[s], &tm_a, &sm.full[s], kt * BKS,
                                tile.row0);
#pragma unroll
                    for (int c = 0; c < BN / 64; ++c)
                        tma_load_3d(sm.b[s][c], &tm_b, &sm.full[s],
                                    n0 + 64 * c, kt * BKS, tile.e);
                }
            }
        }
    } else {
        // ----------------------------------------------------- consumers
        if constexpr (CONSUMERS == 2) setmaxnreg_inc<CONSUMER_REGS>();
        const int cw = threadIdx.x / 128 - 1;    // rows 64 cw .. 64 cw + 63
        const int warp = (threadIdx.x / 32) % 4;
        const int lane = threadIdx.x % 32;
        int slice = 0;
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
            const Tile tile = lookup_tile<BM>(map, item / n_cols, E, M);
            if (tile.row0 >= M) continue;
            const int n0 = (item % n_cols) * BN;
            float acc[BN / 2];
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

            fence_operand(acc);
            for (int kt = 0; kt < nk; ++kt, ++slice) {
                const int s = slice % STAGES;
                mbar_wait(&sm.full[s], (slice / STAGES) & 1);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BKS / 16; ++kk) {
                    const uint64_t da = sw128_desc(
                        smem_u32(sm.a[s]) + cw * 64 * 128 + kk * 32, 16, 1024);
                    const uint64_t db = sw128_desc(
                        smem_u32(sm.b[s][0]) + kk * 16 * 128, BKS * 128, 1024);
                    if constexpr (BN == 256)
                        wgmma_m64n256k16_ss<1>(acc, da, db, 1);
                    else
                        wgmma_m64n128k16_ss<1>(acc, da, db, 1);
                }
                wgmma_commit();
                // The previous slice's products are done: release its stage.
                wgmma_wait<1>();
                if (kt > 0) {
                    __syncwarp();
                    if (lane == 0)
                        mbar_arrive(&sm.empty[(slice - 1) % STAGES]);
                }
            }
            wgmma_wait<0>();
            fence_operand(acc);
            __syncwarp();
            if (lane == 0) mbar_arrive(&sm.empty[(slice - 1) % STAGES]);

            // acc[4j + e]: row 16 warp + lane / 4 (+ 8 for e >= 2), column
            // 8j + 2 (lane % 4) + e % 2.
            const int rows = tile.row1 - tile.row0;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int row = 64 * cw + 16 * warp + lane / 4 + 8 * hr;
                if (row >= rows) continue;
                bf16* orow = out + static_cast<long long>(tile.row0 + row) * N;
#pragma unroll
                for (int j = 0; j < BN / 8; ++j) {
                    const int col = n0 + 8 * j + 2 * (lane % 4);
                    if (col < N)
                        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                            __floats2bfloat162_rn(acc[4 * j + 2 * hr],
                                                  acc[4 * j + 2 * hr + 1]);
                }
            }
        }
    }
}

template <int BM>
int launch_bf16(const void* xs, const void* w, const int* group_sizes,
                void* out, int M, int K, int N, int E, cudaStream_t stream) {
    constexpr int BN = TILE_COLS<BM>;
    CUtensorMap tm_a, tm_b;
    const uint64_t a_sizes[2] = {static_cast<uint64_t>(K),
                                 static_cast<uint64_t>(M)};
    const uint64_t a_strides[1] = {static_cast<uint64_t>(K) * 2};
    const uint32_t a_box[2] = {BKS, BM};
    int rc = hopper::encode_tiled(&tm_a, xs, 2, a_sizes, a_strides, a_box);
    if (rc != 0) return rc;
    const uint64_t b_sizes[3] = {static_cast<uint64_t>(N),
                                 static_cast<uint64_t>(K),
                                 static_cast<uint64_t>(E)};
    const uint64_t b_strides[2] = {static_cast<uint64_t>(N) * 2,
                                   static_cast<uint64_t>(K) * N * 2};
    const uint32_t b_box[3] = {64, BKS, 1};
    rc = hopper::encode_tiled(&tm_b, w, 3, b_sizes, b_strides, b_box);
    if (rc != 0) return rc;
    constexpr int smem = sizeof(GmmSmem<BM>) + 1024;
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_bf16<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0, sms = 0;
    cudaError_t e2 = cudaGetDevice(&device);
    if (e2 == cudaSuccess)
        e2 = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device);
    if (e2 != cudaSuccess) return static_cast<int>(e2);
    // Work items: at most ceil(M / BM) + E row tiles (each group adds at
    // most one partial tile) times the column tiles.
    const long long items = static_cast<long long>((M + BM - 1) / BM + E)
        * ((N + BN - 1) / BN);
    const int grid = static_cast<int>(items < sms ? items : sms);
    gmm_bf16<BM><<<grid, 128 * (1 + BM / 64), smem, stream>>>(
        tm_a, tm_b, group_sizes, static_cast<bf16*>(out), M, K, N, E);
    return static_cast<int>(cudaGetLastError());
}

// The current device's SM count, for the persistent backward grids.
int sm_count(int* sms) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount,
                                     device);
    return static_cast<int>(err);
}

// ------------------------------------------------------- bfloat16 backward
//
// The gradient of the bf16 product, two kernels of their own (the forward's
// are not reworked to serve them): g [M, N] is the gradient of out.
//
// `gmm_dx_bf16`: dx [M, K] = g[rows of e] . w[e]^T, the forward's grouped
// product with K and N swapped: the same work items (row tiles from the
// tile map, column tiles now over K), ring, roles and epilogue, and the
// reduction over N.  A (g, N-contiguous) is loaded as the forward loads xs;
// B is w[e] read as wgmma's K-major operand: row k of w[e] is contiguous
// along n, the reduction, so one 3-D box {64 n, BN k, 1} is BN rows of 128
// bytes, the layout of a K-major A tile (TRANS_B = 0).

template <int BM>
struct DxSmem {
    bf16 a[STAGES][BM * BKS];                  // BM rows of g x 64 n
    bf16 b[STAGES][TILE_COLS<BM> * BKS];       // BN rows (k) of w[e] x 64 n
    uint64_t full[STAGES], empty[STAGES];
};

template <int BM>
__global__ void __launch_bounds__(128 * (1 + BM / 64), 1)
gmm_dx_bf16(const __grid_constant__ CUtensorMap tm_g,
            const __grid_constant__ CUtensorMap tm_w,
            const int* __restrict__ group_sizes, bf16* __restrict__ dx,
            int M, int K, int N, int E) {
    using namespace hopper;
    constexpr int BN = TILE_COLS<BM>;
    constexpr int CONSUMERS = BM / 64;
    constexpr uint32_t STAGE_BYTES = (BM + BN) * BKS * 2;
    __shared__ TileMap map;
    extern __shared__ unsigned char smem_raw[];
    DxSmem<BM>& sm = *reinterpret_cast<DxSmem<BM>*>(align1024(smem_raw));

    if (threadIdx.x == 32) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&sm.full[s], 1);
            mbar_init(&sm.empty[s], 4 * CONSUMERS);
        }
        fence_barrier_init();
    }
    build_tile_map<BM>(map, group_sizes, E);   // ends in __syncthreads
    const int n_cols = (K + BN - 1) / BN;
    const int items = map.total * n_cols;
    const int nk = (N + BKS - 1) / BKS;

    if (threadIdx.x < 128) {
        // ------------------------------------------------------ producer
        if constexpr (CONSUMERS == 2) setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            int slice = 0;
            for (int item = blockIdx.x; item < items; item += gridDim.x) {
                const Tile tile = lookup_tile<BM>(map, item / n_cols, E, M);
                if (tile.row0 >= M) continue;
                const int k0 = (item % n_cols) * BN;
                for (int kt = 0; kt < nk; ++kt, ++slice) {
                    const int s = slice % STAGES;
                    mbar_wait(&sm.empty[s], ((slice / STAGES) & 1) ^ 1);
                    mbar_arrive_expect_tx(&sm.full[s], STAGE_BYTES);
                    tma_load_2d(sm.a[s], &tm_g, &sm.full[s], kt * BKS,
                                tile.row0);
                    tma_load_3d(sm.b[s], &tm_w, &sm.full[s], kt * BKS, k0,
                                tile.e);
                }
            }
        }
    } else {
        // ----------------------------------------------------- consumers
        if constexpr (CONSUMERS == 2) setmaxnreg_inc<CONSUMER_REGS>();
        const int cw = threadIdx.x / 128 - 1;    // rows 64 cw .. 64 cw + 63
        const int warp = (threadIdx.x / 32) % 4;
        const int lane = threadIdx.x % 32;
        int slice = 0;
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
            const Tile tile = lookup_tile<BM>(map, item / n_cols, E, M);
            if (tile.row0 >= M) continue;
            const int k0 = (item % n_cols) * BN;
            float acc[BN / 2];
#pragma unroll
            for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

            fence_operand(acc);
            for (int kt = 0; kt < nk; ++kt, ++slice) {
                const int s = slice % STAGES;
                mbar_wait(&sm.full[s], (slice / STAGES) & 1);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BKS / 16; ++kk) {
                    const uint64_t da = sw128_desc(
                        smem_u32(sm.a[s]) + cw * 64 * 128 + kk * 32, 16, 1024);
                    const uint64_t db = sw128_desc(
                        smem_u32(sm.b[s]) + kk * 32, 16, 1024);
                    if constexpr (BN == 256)
                        wgmma_m64n256k16_ss<0>(acc, da, db, 1);
                    else
                        wgmma_m64n128k16_ss<0>(acc, da, db, 1);
                }
                wgmma_commit();
                wgmma_wait<1>();
                if (kt > 0) {
                    __syncwarp();
                    if (lane == 0)
                        mbar_arrive(&sm.empty[(slice - 1) % STAGES]);
                }
            }
            wgmma_wait<0>();
            fence_operand(acc);
            __syncwarp();
            if (lane == 0) mbar_arrive(&sm.empty[(slice - 1) % STAGES]);

            const int rows = tile.row1 - tile.row0;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int row = 64 * cw + 16 * warp + lane / 4 + 8 * hr;
                if (row >= rows) continue;
                bf16* orow = dx + static_cast<long long>(tile.row0 + row) * K;
#pragma unroll
                for (int j = 0; j < BN / 8; ++j) {
                    const int col = k0 + 8 * j + 2 * (lane % 4);
                    if (col < K)
                        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                            __floats2bfloat162_rn(acc[4 * j + 2 * hr],
                                                  acc[4 * j + 2 * hr + 1]);
                }
            }
        }
    }
}

template <int BM>
int launch_dx_bf16(const void* g, const void* w, const int* group_sizes,
                   void* dx, int M, int K, int N, int E,
                   cudaStream_t stream) {
    constexpr int BN = TILE_COLS<BM>;
    CUtensorMap tm_g, tm_w;
    const uint64_t g_sizes[2] = {static_cast<uint64_t>(N),
                                 static_cast<uint64_t>(M)};
    const uint64_t g_strides[1] = {static_cast<uint64_t>(N) * 2};
    const uint32_t g_box[2] = {BKS, BM};
    int rc = hopper::encode_tiled(&tm_g, g, 2, g_sizes, g_strides, g_box);
    if (rc != 0) return rc;
    const uint64_t w_sizes[3] = {static_cast<uint64_t>(N),
                                 static_cast<uint64_t>(K),
                                 static_cast<uint64_t>(E)};
    const uint64_t w_strides[2] = {static_cast<uint64_t>(N) * 2,
                                   static_cast<uint64_t>(K) * N * 2};
    const uint32_t w_box[3] = {BKS, BN, 1};
    rc = hopper::encode_tiled(&tm_w, w, 3, w_sizes, w_strides, w_box);
    if (rc != 0) return rc;
    constexpr int smem = sizeof(DxSmem<BM>) + 1024;
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_dx_bf16<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    rc = sm_count(&sms);
    if (rc != 0) return rc;
    const long long items = static_cast<long long>((M + BM - 1) / BM + E)
        * ((K + BN - 1) / BN);
    const int grid = static_cast<int>(items < sms ? items : sms);
    gmm_dx_bf16<BM><<<grid, 128 * (1 + BM / 64), smem, stream>>>(
        tm_g, tm_w, group_sizes, static_cast<bf16*>(dx), M, K, N, E);
    return static_cast<int>(cudaGetLastError());
}

// `gmm_dw_bf16`: dw[e] [K, N] = xs[rows of e]^T . g[rows of e] for every
// expert, the reduction over the group's own rows in slices of 64.  Work
// item: (expert, DW_ROWS x DW_COLS tile of dw[e]), the whole reduction in
// one block, so each output is summed in float32 in one order and rounded
// to bf16 once (deterministic; no partials, no atomics).  Both operands are
// read M/N-major: the xs slice, rows r x 64 k, is A with TRANS_A = 1 (k,
// the output row, contiguous), and the g slice, rows r x 64 n, is B with
// TRANS_B = 1, as the forward reads w[e]; a k16 step advances 16 rows
// (2048 bytes).  A group's last slice reaches into the next expert's rows
// (TMA zero-fills only past M): the consumers zero those rows of both
// operands in shared memory before the products.  An expert with no rows
// has no slices and stores zeros (dw comes from torch.empty).  Balance:
// every block orders the experts by rows, longest first, and the blocks
// take the items of that order in turn, so the long groups' items start
// first and spread over the SMs; a group holding more than about
// items / SMs times the mean rows still bounds the launch (no split).

constexpr int DW_ROWS = 128;   // dw rows (k) per tile: two consumers
constexpr int DW_COLS = 256;   // dw columns (n) per tile

struct DwSmem {
    bf16 a[STAGES][DW_ROWS / 64][BKS * 64];    // 64 routed rows x 64 k
    bf16 b[STAGES][DW_COLS / 64][BKS * 64];    // 64 routed rows x 64 n
    uint64_t full[STAGES], empty[STAGES];
};

__global__ void __launch_bounds__(384, 1)
gmm_dw_bf16(const __grid_constant__ CUtensorMap tm_x,
            const __grid_constant__ CUtensorMap tm_g,
            const int* __restrict__ group_sizes, bf16* __restrict__ dw,
            int M, int K, int N, int E) {
    using namespace hopper;
    constexpr int CONSUMERS = DW_ROWS / 64;
    constexpr int BOXES = (DW_ROWS + DW_COLS) / 64;
    constexpr uint32_t STAGE_BYTES = BOXES * BKS * 64 * 2;
    __shared__ TileMap map;
    __shared__ int order[MAX_EXPERTS];
    extern __shared__ unsigned char smem_raw[];
    DwSmem& sm = *reinterpret_cast<DwSmem*>(align1024(smem_raw));

    if (threadIdx.x == 32) {
        for (int s = 0; s < STAGES; ++s) {
            mbar_init(&sm.full[s], 1);
            mbar_init(&sm.empty[s], 4 * CONSUMERS);
        }
        fence_barrier_init();
    }
    build_tile_map<BKS>(map, group_sizes, E);  // sizes and first rows
    for (int e = threadIdx.x; e < E; e += blockDim.x) {
        const int n = map.sizes[e];
        int rank = 0;
        for (int j = 0; j < E; ++j) {
            const int m = map.sizes[j];
            rank += m > n || (m == n && j < e);
        }
        order[rank] = e;
    }
    __syncthreads();
    const int n_cols = (N + DW_COLS - 1) / DW_COLS;
    const int per_expert = (K + DW_ROWS - 1) / DW_ROWS * n_cols;
    const int items = E * per_expert;

    if (threadIdx.x < 128) {
        // ------------------------------------------------------ producer
        setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            int slice = 0;
            for (int item = blockIdx.x; item < items; item += gridDim.x) {
                const int e = order[item / per_expert];
                const int t = item % per_expert;
                const int k0 = t / n_cols * DW_ROWS;
                const int n0 = t % n_cols * DW_COLS;
                const int r0 = map.first_row[e];
                const int nk = (map.sizes[e] + BKS - 1) / BKS;
                for (int kt = 0; kt < nk; ++kt, ++slice) {
                    const int s = slice % STAGES;
                    mbar_wait(&sm.empty[s], ((slice / STAGES) & 1) ^ 1);
                    mbar_arrive_expect_tx(&sm.full[s], STAGE_BYTES);
#pragma unroll
                    for (int c = 0; c < DW_ROWS / 64; ++c)
                        tma_load_2d(sm.a[s][c], &tm_x, &sm.full[s],
                                    k0 + 64 * c, r0 + kt * BKS);
#pragma unroll
                    for (int c = 0; c < DW_COLS / 64; ++c)
                        tma_load_2d(sm.b[s][c], &tm_g, &sm.full[s],
                                    n0 + 64 * c, r0 + kt * BKS);
                }
            }
        }
    } else {
        // ----------------------------------------------------- consumers
        setmaxnreg_inc<CONSUMER_REGS>();
        const int ct = threadIdx.x - 128;        // 0 .. 255
        const int cw = ct / 128;                 // dw rows k0 + 64 cw ..
        const int warp = (threadIdx.x / 32) % 4;
        const int lane = threadIdx.x % 32;
        int slice = 0;
        for (int item = blockIdx.x; item < items; item += gridDim.x) {
            const int e = order[item / per_expert];
            const int t = item % per_expert;
            const int k0 = t / n_cols * DW_ROWS;
            const int n0 = t % n_cols * DW_COLS;
            const int rows = map.sizes[e];
            const int nk = (rows + BKS - 1) / BKS;
            float acc[DW_COLS / 2];
#pragma unroll
            for (int i = 0; i < DW_COLS / 2; ++i) acc[i] = 0.f;

            fence_operand(acc);
            for (int kt = 0; kt < nk; ++kt, ++slice) {
                const int s = slice % STAGES;
                mbar_wait(&sm.full[s], (slice / STAGES) & 1);
                const int valid = rows - kt * BKS;
                if (valid < BKS) {
                    // Rows valid .. 63 of every box are the next expert's:
                    // each row is 128 contiguous bytes (the swizzle permutes
                    // 16-byte chunks within a row), so zero that range.
                    constexpr int CHUNKS = BKS * 128 / 16;   // per box
                    const int first = valid * 128 / 16;
                    for (int i = ct; i < BOXES * (CHUNKS - first); i += 256) {
                        const int box = i / (CHUNKS - first);
                        const int chunk = first + i % (CHUNKS - first);
                        bf16* base = box < DW_ROWS / 64
                            ? sm.a[s][box] : sm.b[s][box - DW_ROWS / 64];
                        reinterpret_cast<uint4*>(base)[chunk] =
                            make_uint4(0, 0, 0, 0);
                    }
                    fence_proxy_async();
                    named_barrier_sync<128 * CONSUMERS>(1);
                }
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < BKS / 16; ++kk) {
                    const uint64_t da = sw128_desc(
                        smem_u32(sm.a[s][cw]) + kk * 16 * 128, BKS * 128,
                        1024);
                    const uint64_t db = sw128_desc(
                        smem_u32(sm.b[s][0]) + kk * 16 * 128, BKS * 128,
                        1024);
                    wgmma_m64n256k16_ss<1, 1>(acc, da, db, 1);
                }
                wgmma_commit();
                wgmma_wait<1>();
                if (kt > 0) {
                    __syncwarp();
                    if (lane == 0)
                        mbar_arrive(&sm.empty[(slice - 1) % STAGES]);
                }
            }
            wgmma_wait<0>();
            fence_operand(acc);
            if (nk > 0) {
                __syncwarp();
                if (lane == 0) mbar_arrive(&sm.empty[(slice - 1) % STAGES]);
            }

            // acc[4j + i]: dw row k0 + 64 cw + 16 warp + lane / 4 (+ 8 for
            // i >= 2), column n0 + 8j + 2 (lane % 4) + i % 2.
            bf16* out = dw + static_cast<long long>(e) * K * N;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int row = k0 + 64 * cw + 16 * warp + lane / 4 + 8 * hr;
                if (row >= K) continue;
                bf16* orow = out + static_cast<long long>(row) * N;
#pragma unroll
                for (int j = 0; j < DW_COLS / 8; ++j) {
                    const int col = n0 + 8 * j + 2 * (lane % 4);
                    if (col < N)
                        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                            __floats2bfloat162_rn(acc[4 * j + 2 * hr],
                                                  acc[4 * j + 2 * hr + 1]);
                }
            }
        }
    }
}

int launch_dw_bf16(const void* xs, const void* g, const int* group_sizes,
                   void* dw, int M, int K, int N, int E,
                   cudaStream_t stream) {
    CUtensorMap tm_x, tm_g;
    const uint32_t box[2] = {BKS, BKS};
    const uint64_t x_sizes[2] = {static_cast<uint64_t>(K),
                                 static_cast<uint64_t>(M)};
    const uint64_t x_strides[1] = {static_cast<uint64_t>(K) * 2};
    int rc = hopper::encode_tiled(&tm_x, xs, 2, x_sizes, x_strides, box);
    if (rc != 0) return rc;
    const uint64_t g_sizes[2] = {static_cast<uint64_t>(N),
                                 static_cast<uint64_t>(M)};
    const uint64_t g_strides[1] = {static_cast<uint64_t>(N) * 2};
    rc = hopper::encode_tiled(&tm_g, g, 2, g_sizes, g_strides, box);
    if (rc != 0) return rc;
    constexpr int smem = sizeof(DwSmem) + 1024;
    const cudaError_t err = cudaFuncSetAttribute(
        gmm_dw_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int sms = 0;
    rc = sm_count(&sms);
    if (rc != 0) return rc;
    const long long items = static_cast<long long>(E)
        * ((K + DW_ROWS - 1) / DW_ROWS) * ((N + DW_COLS - 1) / DW_COLS);
    const int grid = static_cast<int>(items < sms ? items : sms);
    gmm_dw_bf16<<<grid, 384, smem, stream>>>(
        tm_x, tm_g, group_sizes, static_cast<bf16*>(dw), M, K, N, E);
    return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- float32

constexpr int FT = 64;    // rows per tile
constexpr int FN = 64;    // columns per tile
constexpr int FK = 16;    // K slice

__global__ void __launch_bounds__(THREADS)
gmm_f32(const float* __restrict__ xs, const float* __restrict__ w,
        const int* __restrict__ group_sizes, float* __restrict__ out,
        int M, int K, int N, int E) {
    __shared__ int s_gs[MAX_EXPERTS];
    __shared__ __align__(16) float As[FK][FT + 4];   // As[k][row]
    __shared__ __align__(16) float Bs[FK][FN + 4];   // Bs[k][col]

    const Tile tile = find_tile(group_sizes, E, M, FT, s_gs);
    if (tile.row0 < 0) return;
    const int rows = tile.row1 - tile.row0;
    const int n0 = blockIdx.y * FN;
    const float* xa = xs + static_cast<long long>(tile.row0) * K;
    const float* wb = w + static_cast<long long>(tile.e) * K * N;

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += FK) {
        __syncthreads();   // the previous slice's readers are done
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const int i = tid + q * THREADS;
            const int r = i / FK, c = i % FK;
            As[c][r] = (r < rows && k0 + c < K)
                ? xa[static_cast<long long>(r) * K + k0 + c] : 0.f;
            const int br = i / FN, bc = i % FN;
            Bs[br][bc] = (k0 + br < K && n0 + bc < N)
                ? wb[static_cast<long long>(k0 + br) * N + n0 + bc] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < FK; ++k) {
            const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
            const float4 b = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = ty * 4 + i;
        if (row >= rows) continue;
        float* orow = out + static_cast<long long>(tile.row0 + row) * N;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int col = n0 + tx * 4 + j;
            if (col < N) orow[col] = acc[i][j];
        }
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  xs [M, K], w [E, K, N] and out [M, N]
// are contiguous; group_sizes is E int32 values on the device that sum to
// M.  For bfloat16, K and N are multiples of 8, the pointers 16-byte
// aligned, and tile_rows (rows per output tile) is 64 or 128; float32
// ignores it.  Returns the CUDA error of the launch (0 on success), or
// hopper::TMAP_ERROR + the driver's CUresult if a tensor map cannot be
// encoded; the wrapper checks everything else.
extern "C" int moe_gmm_fwd(const void* xs, const void* w,
                           const void* group_sizes, void* out, int M, int K,
                           int N, int E, int dtype, int tile_rows,
                           void* stream) {
    if (E < 1 || E > MAX_EXPERTS || M < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* gs = static_cast<const int*>(group_sizes);
    if (dtype == 1 && tile_rows == TILE_ROWS_LARGE)
        return launch_bf16<TILE_ROWS_LARGE>(xs, w, gs, out, M, K, N, E, s);
    if (dtype == 1 && tile_rows == TILE_ROWS_SMALL)
        return launch_bf16<TILE_ROWS_SMALL>(xs, w, gs, out, M, K, N, E, s);
    if (dtype != 0) return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid((M + FT - 1) / FT + E, (N + FN - 1) / FN);
    gmm_f32<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(xs), static_cast<const float*>(w), gs,
        static_cast<float*>(out), M, K, N, E);
    return static_cast<int>(cudaGetLastError());
}

// The gradient of the bfloat16 product, for g [M, N] (the gradient of
// out), with xs [M, K], w [E, K, N] and group_sizes as moe_gmm_fwd takes
// them (contiguous bf16, K and N multiples of 8, pointers on 16 bytes, M
// >= 1): moe_gmm_bwd_dx writes dx [M, K] (tile_rows 64 or 128, as the
// forward's), moe_gmm_bwd_dw writes dw [E, K, N], every element, zeros for
// an expert with no rows.  Return codes as moe_gmm_fwd's.
extern "C" int moe_gmm_bwd_dx(const void* g, const void* w,
                              const void* group_sizes, void* dx, int M,
                              int K, int N, int E, int tile_rows,
                              void* stream) {
    if (E < 1 || E > MAX_EXPERTS || M < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* gs = static_cast<const int*>(group_sizes);
    if (tile_rows == TILE_ROWS_LARGE)
        return launch_dx_bf16<TILE_ROWS_LARGE>(g, w, gs, dx, M, K, N, E, s);
    if (tile_rows == TILE_ROWS_SMALL)
        return launch_dx_bf16<TILE_ROWS_SMALL>(g, w, gs, dx, M, K, N, E, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int moe_gmm_bwd_dw(const void* xs, const void* g,
                              const void* group_sizes, void* dw, int M,
                              int K, int N, int E, void* stream) {
    if (E < 1 || E > MAX_EXPERTS || M < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    return launch_dw_bf16(xs, g, static_cast<const int*>(group_sizes), dw,
                          M, K, N, E, static_cast<cudaStream_t>(stream));
}
