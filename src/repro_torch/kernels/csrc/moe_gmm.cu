// Ragged grouped matrix product over expert-sorted rows (MoE expert FFN)
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_gmm_kernel` of the JAX package
// (src/repro/kernels/moe_gmm.py, reached through `grouped_matmul` and the
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
// and its wrapper drops every row past Cap.  Here each 128-row tile lies
// inside one expert's group: block x finds its (expert, first row) from the
// group sizes itself, so nothing is padded, copied or dropped, and the host
// never reads the group sizes.  The grid is the upper bound
// ceil(M / BT) + E row tiles (every group adds at most one partial tile);
// the blocks past the last tile exit at once.
//
// What bounds it on an H100: at granite-moe-1b-a400m's prefill (M = 65536
// routed rows, K 1024, N 512, bf16) it does 68.7 GFLOP and moves ~235 MB:
// 0.069 ms at the 989 TFLOP/s bf16 tensor-core peak against 0.070 ms at
// 3.35 TB/s, so both about equally.  In a decode step (64 rows over ~28
// experts) only the active experts' weights move: bytes, ~9 us.
//
// Design, simple rather than fast (no TMA, no wgmma, no persistent blocks):
// - bfloat16 (`gmm_bf16`): 128 x 128 output tile per block, 8 warps of
//   32 x 64 each, `mma.sync.m16n8k16` (bf16 in, f32 accumulate); A and B
//   fragments come from shared memory through `ldmatrix` (B transposed on
//   load, since w is K-major); the 32-deep K slices are double-buffered
//   with 16-byte `cp.async` copies that zero-fill rows outside the tile's
//   group and columns past N; shared rows are padded by 8 elements so that
//   the eight row addresses of an `ldmatrix` fall in distinct banks.
// - float32 (`gmm_f32`): scalar FMAs (TF32 would not keep float32's
//   digits), 64 x 64 tile, each of 256 threads owning 4 x 4 outputs,
//   16-deep K slices in shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

constexpr int BT = 128;   // rows per tile
constexpr int BN = 128;   // output columns per tile
constexpr int BK = 32;    // K slice per pipeline stage
constexpr int LDA = BK + 8;
constexpr int LDB = BN + 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, zero-filled when !valid (nothing is read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
    asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_addr(p)));
}

// c += a (16 x 16, row-major) . b (16 x 8, column-major), bf16 in, f32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
gmm_bf16(const bf16* __restrict__ xs, const bf16* __restrict__ w,
         const int* __restrict__ group_sizes, bf16* __restrict__ out,
         int M, int K, int N, int E) {
    __shared__ int s_gs[MAX_EXPERTS];
    __shared__ __align__(16) bf16 As[2][BT * LDA];
    __shared__ __align__(16) bf16 Bs[2][BK * LDB];

    const Tile tile = find_tile(group_sizes, E, M, BT, s_gs);
    if (tile.row0 < 0) return;
    const int rows = tile.row1 - tile.row0;
    const int n0 = blockIdx.y * BN;
    const bf16* xa = xs + static_cast<long long>(tile.row0) * K;
    const bf16* wb = w + static_cast<long long>(tile.e) * K * N;

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int wm = warp % 4;   // rows 32 wm .. 32 wm + 31
    const int wn = warp / 4;   // columns 64 wn .. 64 wn + 63
    const int g = lane / 4, t = lane % 4;

    auto load_stage = [&](int s, int k0) {
        // A: 128 rows x 32 columns = 512 chunks of 8; B: 32 x 128 = 512.
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int i = tid + q * THREADS;
            const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
            const bool ok = r < rows && k0 + c < K;
            cp_async16(&As[s][r * LDA + c],
                       ok ? xa + static_cast<long long>(r) * K + k0 + c : xs,
                       ok);
        }
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int i = tid + q * THREADS;
            const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
            const bool ok = k0 + r < K && n0 + c < N;
            cp_async16(&Bs[s][r * LDB + c],
                       ok ? wb + static_cast<long long>(k0 + r) * N + n0 + c
                          : w,
                       ok);
        }
    };

    float acc[2][8][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

    const int nk = (K + BK - 1) / BK;
    load_stage(0, 0);
    cp_async_commit();
    for (int kt = 0; kt < nk; ++kt) {
        if (kt + 1 < nk) load_stage((kt + 1) & 1, (kt + 1) * BK);
        cp_async_commit();
        cp_async_wait_one();   // stage kt has landed
        __syncthreads();
        const bf16* as = As[kt & 1];
        const bf16* bs = Bs[kt & 1];
#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t a[2][4];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
                ldmatrix_x4(a[mi], as + (wm * 32 + mi * 16 + lane % 16) * LDA
                                       + kk + (lane / 16) * 8);
            // One x4.trans gives b0, b1 of two neighbouring n8 tiles:
            // matrices (k 0-7 | 8-15) x (n 0-7 | 8-15).
            const int m = lane / 8, r = lane % 8;
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t b[4];
                ldmatrix_x4_trans(b, bs + (kk + r + (m & 1) * 8) * LDB
                                         + wn * 64 + np * 16 + (m >> 1) * 8);
#pragma unroll
                for (int mi = 0; mi < 2; ++mi) {
                    mma_bf16(acc[mi][2 * np], a[mi], b[0], b[1]);
                    mma_bf16(acc[mi][2 * np + 1], a[mi], b[2], b[3]);
                }
            }
        }
        __syncthreads();   // readers of this stage are done before reuse
    }

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
            const int row = wm * 32 + mi * 16 + g + 8 * h;
            if (row >= rows) continue;
            bf16* orow = out + static_cast<long long>(tile.row0 + row) * N;
#pragma unroll
            for (int ni = 0; ni < 8; ++ni) {
                const int col = n0 + wn * 64 + ni * 8 + 2 * t;
                if (col < N)
                    *reinterpret_cast<__nv_bfloat162*>(orow + col) =
                        __floats2bfloat162_rn(acc[mi][ni][2 * h],
                                              acc[mi][ni][2 * h + 1]);
            }
        }
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
// M.  For bfloat16, K and N are multiples of 8 and the pointers 16-byte
// aligned.  Returns the CUDA error of the launch (0 on success); the
// wrapper checks everything else.
extern "C" int moe_gmm_fwd(const void* xs, const void* w,
                           const void* group_sizes, void* out, int M, int K,
                           int N, int E, int dtype, void* stream) {
    if (E < 1 || E > MAX_EXPERTS || M < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        const dim3 grid((M + BT - 1) / BT + E, (N + BN - 1) / BN);
        gmm_bf16<<<grid, THREADS, 0, s>>>(
            static_cast<const bf16*>(xs), static_cast<const bf16*>(w),
            static_cast<const int*>(group_sizes), static_cast<bf16*>(out),
            M, K, N, E);
    } else if (dtype == 0) {
        const dim3 grid((M + FT - 1) / FT + E, (N + FN - 1) / FN);
        gmm_f32<<<grid, THREADS, 0, s>>>(
            static_cast<const float*>(xs), static_cast<const float*>(w),
            static_cast<const int*>(group_sizes), static_cast<float*>(out),
            M, K, N, E);
    } else {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(cudaGetLastError());
}
