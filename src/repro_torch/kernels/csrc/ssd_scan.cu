// Mamba2 SSD intra-chunk dual form for Hopper (sm_90a).
//
// Replaces the TPU kernel `_ssd_kernel` of the JAX package
// (src/repro/kernels/ssd_scan.py, reached through `ssd_intra_chunk` and the
// wrapper `ops.ssd_chunked_pallas`).
//
// What it computes, for every batch b, SSD head h and chunk c of Q steps
// (i, j index the steps of the chunk, g = h / (H / G) the B/C group):
//   seg_i = sum_{j <= i} dt_j A_h                                (f32)
//   y_i   = sum_{j <= i} (C_i . B_j) exp(seg_i - seg_j) dt_j x_j
//   S     = sum_j B_j (x) (x_j dt_j exp(seg_{Q-1} - seg_j))     [N, P], f32
// from the model layout: x [B, S, H, P], dt [B, S, H] (f32, after the
// softplus), A [H] (f32, negative), B, C [B, S, G, N], all read through
// their strides (the last axis contiguous), so the reference's per-head
// repeat of B and C and its transposes to [B, H, Nc, Q, *] are not made.
// Writes y (the intra-chunk part, model layout, float32: the caller adds
// the inter-chunk part to it before it rounds), S [B, H, Nc, N, P] and
// seg [B, H, Nc, Q].
//
// What bounds it on an H100: at mamba2-130m's prefill (B 8, S 1024, H 24,
// P 64, G 1, N 128, Q 256, bf16 in) it moves ~106 MB (50 MB of it the f32
// y) and does ~12.9 GFLOP of causal products: 0.032 ms at 3.35 TB/s
// against 0.013 ms at the bf16 tensor-core peak, so bytes.
//
// Design: one block per (chunk, head, batch), 8 warps: the TPU kernel's
// grid cell, and nothing carries over between blocks.
// - bfloat16 (`ssd_bf16`): the chunk's B, C and x rows (bf16) go to shared
//   memory once with 16-byte `cp.async` copies (215 KB at the prefill's
//   shapes, with the two parts of xw below; the [Q, Q] score tile is never
//   stored whole: at Q = 256 it would be 256 KB in f32, more than a block
//   may have).  `seg` is a block scan in float64 (warp shuffles, then the
//   warp totals), for the decays' differences of neighbouring seg values.
//   Each warp owns 16-row tiles of i (in snake order, so the causal work evens out) and walks
//   the 16-column tiles of j up to the diagonal: C_i . B_j on the tensor
//   cores (`mma.sync.m16n8k16`, bf16 in, f32 accumulate: the products of
//   bf16 inputs are exact), then in registers the decay and dt_j, the
//   upper triangle SELECTED away (exp(seg_i - seg_j) overflows to inf for
//   i < j, and inf * 0 would be NaN), then the scores rounded to bf16 as
//   the A fragments of scores . x (x's B fragments through `ldmatrix`,
//   transposed on load).  Then xw = x dt exp(seg_last - seg) replaces x in
//   shared memory, and S = B^T xw runs on the tensor cores too.
//   Rounding: the reference keeps `scores` and `xw` in f32, but the tensor
//   cores take bf16 (8 bits).  Rounding each once would put a relative
//   error of up to 2^-9 on every term of sums of up to 256 terms, which
//   at the prefill's shapes reaches the 2e-2 tolerance on small outputs.
//   So each f32 operand is split into two bf16 parts, hi = bf16(v) and
//   lo = bf16(v - hi), and its product runs twice (hi, then lo, into the
//   same f32 accumulator): the operand keeps ~16 bits, a relative error of
//   ~2^-17, and the f32 accumulation sets the accuracy as in the
//   reference.  The split costs one more product for scores . x and for
//   B^T xw (C . B^T, half the work, needs none: B and C are bf16 already).
// - float32 (`ssd_f32`): scalar FMAs throughout (TF32 would not keep
//   float32's digits), over 32-step tiles of i and j staged in shared
//   memory; the scores tile goes through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_Q = 256;

struct Args {
    const void* x;
    const float* dt;
    const float* A;
    const void* Bm;
    const void* Cm;
    float* y;
    float* states;
    float* seg;
    int H, G, Q, Nc;
    long long x_b, x_s, x_h, dt_b, dt_s, dt_h, b_b, b_s, b_g, c_b, c_s, c_g,
        y_b, y_s, y_h;
};

// seg_s[j] = inclusive prefix sum of the f32 products dt_s[j] * A over
// j < Q (Q <= 256), summed in float64.  seg reaches a few hundred at the
// end of a chunk while the decays need seg_i - seg_j for neighbouring i, j
// to float32's relative precision: a float32 scan would lose ~1e-4 of it.
__device__ void block_scan(const float* dt_s, double* seg_s, float A, int Q) {
    __shared__ double warp_tot[WARPS];
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    double v = tid < Q ? static_cast<double>(dt_s[tid] * A) : 0.0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const double u = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += u;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    for (int w = 0; w < warp; ++w) v += warp_tot[w];
    if (tid < Q) seg_s[tid] = v;
    __syncthreads();
}

// Loads dt of the block's chunk, scans seg, writes seg out.
__device__ void chunk_seg(const Args& a, int b, int h, int c, float* dt_s,
                          double* seg_s) {
    const int Q = a.Q;
    const long long row0 = static_cast<long long>(c) * Q;
    for (int j = threadIdx.x; j < Q; j += THREADS)
        dt_s[j] = a.dt[b * a.dt_b + (row0 + j) * a.dt_s + h * a.dt_h];
    __syncthreads();
    block_scan(dt_s, seg_s, a.A[h], Q);
    float* seg_out = a.seg + ((static_cast<long long>(b) * a.H + h) * a.Nc + c) * Q;
    for (int j = threadIdx.x; j < Q; j += THREADS)
        seg_out[j] = static_cast<float>(seg_s[j]);
}

// ---------------------------------------------------------------- bfloat16

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(smem_addr(dst)), "l"(src));
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

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

template <int P, int N>
constexpr int smem_bytes_bf16(int Q) {
    return Q * (2 * (N + 8) + 2 * (P + 8)) * 2 + Q * 8 + Q * 4;
}

// v ~= hi + lo, both bf16 (hi in the low half of each pair).
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

template <int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_bf16(Args a) {
    constexpr int LDN = N + 8;   // padded shared rows, in elements
    constexpr int LDP = P + 8;
    constexpr int KN = N / 16;   // k-steps of C . B^T
    constexpr int NP = P / 8;    // n8 tiles of y
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int Q = a.Q;
    bf16* Bs = reinterpret_cast<bf16*>(smem_raw);
    bf16* Cs = Bs + Q * LDN;
    bf16* Xs = Cs + Q * LDN;     // x, then the hi part of xw
    bf16* Xl = Xs + Q * LDP;     // the lo part of xw
    double* seg_s = reinterpret_cast<double*>(Xl + Q * LDP);
    float* dt_s = reinterpret_cast<float*>(seg_s + Q);

    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int grp = h / (a.H / a.G);
    const long long row0 = static_cast<long long>(c) * Q;
    const bf16* xb = static_cast<const bf16*>(a.x) + b * a.x_b + row0 * a.x_s
                     + h * a.x_h;
    const bf16* bb = static_cast<const bf16*>(a.Bm) + b * a.b_b + row0 * a.b_s
                     + grp * a.b_g;
    const bf16* cb = static_cast<const bf16*>(a.Cm) + b * a.c_b + row0 * a.c_s
                     + grp * a.c_g;
    const int tid = threadIdx.x;
    for (int i = tid; i < Q * (N / 8); i += THREADS) {
        const int r = i / (N / 8), col = (i % (N / 8)) * 8;
        cp_async16(Bs + r * LDN + col, bb + r * a.b_s + col);
        cp_async16(Cs + r * LDN + col, cb + r * a.c_s + col);
    }
    for (int i = tid; i < Q * (P / 8); i += THREADS) {
        const int r = i / (P / 8), col = (i % (P / 8)) * 8;
        cp_async16(Xs + r * LDP + col, xb + r * a.x_s + col);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    chunk_seg(a, b, h, c, dt_s, seg_s);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();

    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int lm = lane / 8, lr = lane % 8;   // ldmatrix: matrix, row
    const int n_tiles = Q / 16;

    // ---- y_i over 16-row tiles of i, in snake order across the warps.
    for (int round = 0; round * WARPS < n_tiles; ++round) {
        const int it = round * WARPS + (round % 2 ? WARPS - 1 - warp : warp);
        if (it >= n_tiles) continue;
        const int i0 = it * 16;
        uint32_t cf[KN][4];
#pragma unroll
        for (int kk = 0; kk < KN; ++kk) {
            const bf16* base = Cs + (i0 + g) * LDN + kk * 16 + 2 * t;
            cf[kk][0] = ld32(base);
            cf[kk][1] = ld32(base + 8 * LDN);
            cf[kk][2] = ld32(base + 8);
            cf[kk][3] = ld32(base + 8 * LDN + 8);
        }
        const int irow[2] = {i0 + g, i0 + g + 8};
        const double segi[2] = {seg_s[irow[0]], seg_s[irow[1]]};
        float acc[NP][4];
#pragma unroll
        for (int nd = 0; nd < NP; ++nd)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

        for (int jt = 0; jt <= it; ++jt) {
            const int j0 = jt * 16;
            float s[2][4];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
                for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
                for (int kk = 0; kk < KN; ++kk) {
                    const bf16* kp = Bs + (j0 + 8 * nt + g) * LDN + kk * 16 + 2 * t;
                    mma_bf16(s[nt], cf[kk], ld32(kp), ld32(kp + 8));
                }
            }
            // s[nt][e]: row irow[e >> 1], column j0 + 8 nt + 2t + (e & 1).
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                    const int j = j0 + 8 * nt + 2 * t + (e & 1);
                    s[nt][e] = j <= irow[e >> 1]
                        ? s[nt][e] * expf(static_cast<float>(
                              segi[e >> 1] - seg_s[j])) * dt_s[j]
                        : 0.f;
                }
            uint32_t ahi[4], alo[4];
            split_bf16(s[0][0], s[0][1], ahi[0], alo[0]);
            split_bf16(s[0][2], s[0][3], ahi[1], alo[1]);
            split_bf16(s[1][0], s[1][1], ahi[2], alo[2]);
            split_bf16(s[1][2], s[1][3], ahi[3], alo[3]);
#pragma unroll
            for (int np = 0; np < P / 16; ++np) {
                uint32_t bf[4];
                ldmatrix_x4_trans(bf, Xs + (j0 + lr + (lm & 1) * 8) * LDP
                                          + np * 16 + (lm >> 1) * 8);
                mma_bf16(acc[2 * np], ahi, bf[0], bf[1]);
                mma_bf16(acc[2 * np], alo, bf[0], bf[1]);
                mma_bf16(acc[2 * np + 1], ahi, bf[2], bf[3]);
                mma_bf16(acc[2 * np + 1], alo, bf[2], bf[3]);
            }
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const long long off = b * a.y_b + (row0 + irow[r]) * a.y_s
                                  + h * a.y_h + 2 * t;
#pragma unroll
            for (int nd = 0; nd < NP; ++nd)
                *reinterpret_cast<float2*>(a.y + off + 8 * nd) =
                    make_float2(acc[nd][2 * r], acc[nd][2 * r + 1]);
        }
    }
    __syncthreads();   // every reader of x is done

    // ---- xw = x * (dt * exp(seg_last - seg)) as hi (in place of x) + lo.
    const double seg_last = seg_s[Q - 1];
    for (int i = tid; i < Q * P; i += THREADS) {
        const int j = i / P, p = i % P;
        const float v = __bfloat162float(Xs[j * LDP + p])
            * (dt_s[j] * expf(static_cast<float>(seg_last - seg_s[j])));
        const bf16 hi = __float2bfloat16_rn(v);
        Xs[j * LDP + p] = hi;
        Xl[j * LDP + p] = __float2bfloat16_rn(v - __bfloat162float(hi));
    }
    __syncthreads();

    // ---- S = B^T xw: units of (16 rows of n) x (16 columns of p).
    float* st = a.states + ((static_cast<long long>(b) * a.H + h) * a.Nc + c)
                           * N * P;
    constexpr int UNITS = (N / 16) * (P / 16);
    for (int u = warp; u < UNITS; u += WARPS) {
        const int n0 = (u / (P / 16)) * 16, p0 = (u % (P / 16)) * 16;
        float acc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        for (int j0 = 0; j0 < Q; j0 += 16) {
            uint32_t af[4], bh[4], bl[4];
            // A = B^T: rows n, depth j, from Bs[j][n] transposed on load.
            ldmatrix_x4_trans(af, Bs + (j0 + lr + (lm >> 1) * 8) * LDN + n0
                                      + (lm & 1) * 8);
            const int xo = (j0 + lr + (lm & 1) * 8) * LDP + p0 + (lm >> 1) * 8;
            ldmatrix_x4_trans(bh, Xs + xo);
            ldmatrix_x4_trans(bl, Xl + xo);
            mma_bf16(acc[0], af, bh[0], bh[1]);
            mma_bf16(acc[0], af, bl[0], bl[1]);
            mma_bf16(acc[1], af, bh[2], bh[3]);
            mma_bf16(acc[1], af, bl[2], bl[3]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int r = 0; r < 2; ++r)
                *reinterpret_cast<float2*>(st + (n0 + g + 8 * r) * P + p0
                                           + 8 * nt + 2 * t) =
                    make_float2(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
}

// ---------------------------------------------------------------- float32

constexpr int TQ = 32;   // steps per i / j tile

template <int P, int N>
__global__ void __launch_bounds__(THREADS) ssd_f32(Args a) {
    __shared__ double seg_s[MAX_Q];
    __shared__ float dt_s[MAX_Q];
    __shared__ float Ct[TQ][N + 1], Bt[TQ][N + 1];
    __shared__ float Xt[TQ][P + 1], St[TQ][TQ + 1];
    constexpr int PC = P / 16;   // output columns per thread
    const int Q = a.Q;
    const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
    const int grp = h / (a.H / a.G);
    const long long row0 = static_cast<long long>(c) * Q;
    const float* xb = static_cast<const float*>(a.x) + b * a.x_b + row0 * a.x_s
                      + h * a.x_h;
    const float* bb = static_cast<const float*>(a.Bm) + b * a.b_b
                      + row0 * a.b_s + grp * a.b_g;
    const float* cb = static_cast<const float*>(a.Cm) + b * a.c_b
                      + row0 * a.c_s + grp * a.c_g;
    chunk_seg(a, b, h, c, dt_s, seg_s);

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    auto load_rows = [&](float (*dst)[N + 1], const float* src, long long ss,
                         int first) {
        for (int i = tid; i < TQ * N; i += THREADS) {
            const int r = i / N, n = i % N;
            dst[r][n] = first + r < Q ? src[(first + r) * ss + n] : 0.f;
        }
    };

    // ---- y: 32-row tiles of i against 32-column tiles of j <= i.
    for (int i0 = 0; i0 < Q; i0 += TQ) {
        __syncthreads();
        load_rows(Ct, cb, a.c_s, i0);
        float acc[2][PC];
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int q = 0; q < PC; ++q) acc[r][q] = 0.f;
        for (int j0 = 0; j0 <= i0; j0 += TQ) {
            __syncthreads();
            load_rows(Bt, bb, a.b_s, j0);
            for (int i = tid; i < TQ * P; i += THREADS) {
                const int r = i / P, p = i % P;
                Xt[r][p] = j0 + r < Q ? xb[(j0 + r) * a.x_s + p] : 0.f;
            }
            __syncthreads();
            const int si = tid / 8;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const int sj = (tid % 8) * 4 + q;
                const int i = i0 + si, j = j0 + sj;
                float v = 0.f;
                if (j <= i && i < Q) {
                    for (int n = 0; n < N; ++n) v = fmaf(Ct[si][n], Bt[sj][n], v);
                    v = v * expf(static_cast<float>(seg_s[i] - seg_s[j]))
                        * dt_s[j];
                }
                St[si][sj] = v;
            }
            __syncthreads();
            for (int jj = 0; jj < TQ; ++jj)
#pragma unroll
                for (int r = 0; r < 2; ++r)
#pragma unroll
                    for (int q = 0; q < PC; ++q)
                        acc[r][q] = fmaf(St[ty * 2 + r][jj], Xt[jj][tx + 16 * q],
                                         acc[r][q]);
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            const int i = i0 + ty * 2 + r;
            if (i >= Q) continue;
            float* yp = a.y + b * a.y_b + (row0 + i) * a.y_s + h * a.y_h;
#pragma unroll
            for (int q = 0; q < PC; ++q) yp[tx + 16 * q] = acc[r][q];
        }
    }

    // ---- S = B^T xw, xw = x * (dt * exp(seg_last - seg)).
    const double seg_last = seg_s[Q - 1];
    float sacc[N / 16][PC];
#pragma unroll
    for (int r = 0; r < N / 16; ++r)
#pragma unroll
        for (int q = 0; q < PC; ++q) sacc[r][q] = 0.f;
    for (int j0 = 0; j0 < Q; j0 += TQ) {
        __syncthreads();
        load_rows(Bt, bb, a.b_s, j0);
        for (int i = tid; i < TQ * P; i += THREADS) {
            const int r = i / P, p = i % P, j = j0 + r;
            Xt[r][p] = j < Q
                ? xb[j * a.x_s + p]
                      * (dt_s[j] * expf(static_cast<float>(seg_last - seg_s[j])))
                : 0.f;
        }
        __syncthreads();
        for (int jj = 0; jj < TQ; ++jj)
#pragma unroll
            for (int r = 0; r < N / 16; ++r)
#pragma unroll
                for (int q = 0; q < PC; ++q)
                    sacc[r][q] = fmaf(Bt[jj][ty + 16 * r], Xt[jj][tx + 16 * q],
                                      sacc[r][q]);
    }
    float* st = a.states + ((static_cast<long long>(b) * a.H + h) * a.Nc + c)
                           * N * P;
#pragma unroll
    for (int r = 0; r < N / 16; ++r)
#pragma unroll
        for (int q = 0; q < PC; ++q)
            st[(ty + 16 * r) * P + tx + 16 * q] = sacc[r][q];
}

template <int P, int N>
cudaError_t launch(const Args& a, int Bsz, int dtype, cudaStream_t s) {
    const dim3 grid(a.Nc, a.H, Bsz);
    if (dtype == 0) {
        ssd_f32<P, N><<<grid, THREADS, 0, s>>>(a);
        return cudaGetLastError();
    }
    const int smem = smem_bytes_bf16<P, N>(a.Q);
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bf16<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ssd_bf16<P, N><<<grid, THREADS, smem, s>>>(a);
    return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B and C; dt and A are float32).
// Q divides S, is a multiple of 16 and at most 256; H is a multiple of G;
// P is 64 and N one of 16, 32, 64, 128.  Strides are in elements: batch,
// sequence, head (or group) axes of x, dt, B, C and y in that order; the
// last axis of x, B, C and y is contiguous, and for bfloat16 every row
// starts on 16 bytes.  y is float32 (its last axis contiguous); states
// [B, H, Nc, N, P] and seg [B, H, Nc, Q] are contiguous float32.  Returns
// the CUDA error of the launch (0 on success); the wrapper checks the rest.
extern "C" int ssd_intra_chunk_fwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* y, void* states, void* seg, int Bsz, int S, int H,
    int G, int Q, int N, int P, int dtype, long long x_b,
    long long x_s, long long x_h, long long dt_b, long long dt_s,
    long long dt_h, long long b_b, long long b_s, long long b_g,
    long long c_b, long long c_s, long long c_g, long long y_b,
    long long y_s, long long y_h, void* stream) {
    if (Q < 16 || Q > MAX_Q || Q % 16 || S % Q || G < 1 || H % G || P != 64)
        return static_cast<int>(cudaErrorInvalidValue);
    Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           Bm, Cm, static_cast<float*>(y), static_cast<float*>(states),
           static_cast<float*>(seg), H, G, Q, S / Q, x_b, x_s, x_h, dt_b,
           dt_s, dt_h, b_b, b_s, b_g, c_b, c_s, c_g, y_b, y_s, y_h};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (N) {
        case 16: err = launch<64, 16>(a, Bsz, dtype, s); break;
        case 32: err = launch<64, 32>(a, Bsz, dtype, s); break;
        case 64: err = launch<64, 64>(a, Bsz, dtype, s); break;
        case 128: err = launch<64, 128>(a, Bsz, dtype, s); break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
