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
// Design, bfloat16 (`ssd_bf16`): one block of 8 warps per (chunk, batch,
// group of HB heads that read the same B/C group).  HB (1 .. 3, dividing
// H / G) is the wrapper's plan (`head_group_plan`): the HB that makes the
// grid's waves times a block's work least, so at mamba2-130m's prefill
// (G 1, all 24 heads on one B/C) HB 3: 256 blocks of 175 KB, two waves of
// one block per SM, where one block per (chunk, head) ran 768 blocks in
// 5.8 waves.
// - The chunk's B rows and the HB heads' x rows go to shared memory once,
//   with 16-byte `cp.async` copies into rows whose 16-byte chunks are
//   XOR-swizzled by the row (no padding, ldmatrix free of bank
//   conflicts), while `seg` of every head is scanned in float64 (warp
//   shuffles, then the warp totals: the decays need seg_i - seg_j of
//   neighbouring steps to float32's relative precision, which a float32
//   scan of a few hundred would lose).  C is read straight into the A
//   fragments of the warp's rows.
// - y: each warp owns 16-row tiles of i (in snake order, so the causal
//   work evens out) and walks the 16-column tiles of j up to the diagonal.
//   C_i . B_j^T runs once per (i, j) tile for all HB heads, on the tensor
//   cores (`mma.sync.m16n8k16`, bf16 in, f32 accumulate: the products of
//   bf16 inputs are exact); then per head, in registers, the decay
//   exp(seg_i - seg_j) and dt_j, and the scores as A fragments of
//   scores . x_h (x's B fragments by ldmatrix .trans), into HB sets of f32
//   accumulators.  Below the diagonal tile the decay is factored as
//   exp(seg_i - seg_r) f_j, r the last step of j's tile and f_j =
//   dt_j exp(seg_r - seg_j) computed once per head (two exponentials a
//   thread and tile, not eight; both factors at most 1); on the diagonal
//   tile it is taken whole, the upper triangle SELECTED away
//   (exp(seg_i - seg_j) overflows to inf for i < j, and inf * 0 would be
//   NaN).  y leaves in 16-byte stores (lane pairs swap halves of their
//   fragments).
// - S = (B w)^T x per head, w = dt exp(seg_last - seg): A = B^T by
//   ldmatrix .trans, scaled by w_j in registers; x is the B operand as it
//   lies in shared memory.
// Rounding: the reference keeps `scores` and `B w` (its `xw`) in f32, but
// the tensor cores take bf16 (8 bits).  Rounding each once would put a
// relative error of up to 2^-9 on every term of sums of up to 256 terms,
// which at the prefill's shapes reaches the 2e-2 tolerance on small
// outputs.  So each f32 operand is split into two bf16 parts, hi = bf16(v)
// and lo = bf16(v - hi), and its product runs twice (hi, then lo, into the
// same f32 accumulator): the operand keeps ~16 bits, a relative error of
// ~2^-17, and the f32 accumulation sets the accuracy as in the reference.
// C . B^T needs none: B and C are bf16 already.
// float32 (`ssd_f32`): one block per (chunk, head, batch), the TPU kernel's
// grid cell; scalar FMAs throughout (TF32 would not keep float32's
// digits), over 32-step tiles of i and j staged in shared memory; the
// scores tile goes through shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

using namespace warp_mma;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_Q = 256;
// bfloat16: heads per block at most (each adds 32 f32 accumulators of y a
// thread: three take ~226 of the 255 registers at N 128, a fourth
// spilled), and the shared memory a block may have on an H100.
constexpr int MAX_HEADS_PER_BLOCK = 3;
constexpr int SMEM_MAX = 232448;

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

// B of the chunk (swizzled rows of N), then per head of the block: x
// (swizzled rows of P), seg (float64), dt, the column factors f of the
// decay and w = dt exp(seg_last - seg) (float32).
template <int P, int N>
constexpr int smem_bytes_bf16(int Q, int hb) {
    return Q * N * 2 + hb * Q * (P * 2 + 20);
}

// 4 consecutive f32 of one row per thread from an m16n8 C fragment: lanes
// t and t ^ 1 swap halves, the even lane stores row g, columns 2t .. 2t+3,
// the odd lane row g + 8, columns 2t-2 .. 2t+1: 16-byte stores.
__device__ __forceinline__ void store_c16(float* row_g, float* row_g8,
                                          const float (&c)[4], int t) {
    const bool odd = t & 1;
    const float s0 = odd ? c[0] : c[2];
    const float s1 = odd ? c[1] : c[3];
    const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
    const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
    if (odd)
        *reinterpret_cast<float4*>(row_g8 + 2 * t - 2) =
            make_float4(r0, r1, c[2], c[3]);
    else
        *reinterpret_cast<float4*>(row_g + 2 * t) =
            make_float4(c[0], c[1], r0, r1);
}

// Grid (Nc, H / HB, B): the block's HB heads h0 .. h0 + HB - 1 read the
// same B/C group.
template <int P, int N, int HB>
__global__ void __launch_bounds__(THREADS, 1) ssd_bf16(Args a) {
    constexpr int NCH = N / 8;   // 16-byte chunks of a B row
    constexpr int PCH = P / 8;   // of an x row
    constexpr int KN = N / 16;   // k-steps of C . B^T
    constexpr int NP = P / 8;    // n8 tiles over P
    extern __shared__ __align__(128) unsigned char smem_raw[];
    const int Q = a.Q;
    bf16* Bs = reinterpret_cast<bf16*>(smem_raw);     // [Q][N]
    bf16* Xs = Bs + Q * N;                            // [HB][Q][P]
    double* seg_s = reinterpret_cast<double*>(Xs + HB * Q * P);   // [HB][Q]
    float* dt_s = reinterpret_cast<float*>(seg_s + HB * Q);       // [HB][Q]
    float* w_s = dt_s + HB * Q;                                   // [HB][Q]
    float* f_s = w_s + HB * Q;                                    // [HB][Q]

    const int c = blockIdx.x, b = blockIdx.z;
    const int h0 = blockIdx.y * HB;
    const int grp = h0 / (a.H / a.G);
    const long long row0 = static_cast<long long>(c) * Q;
    const bf16* bb = static_cast<const bf16*>(a.Bm) + b * a.b_b + row0 * a.b_s
                     + grp * a.b_g;
    const bf16* cb = static_cast<const bf16*>(a.Cm) + b * a.c_b + row0 * a.c_s
                     + grp * a.c_g;
    const int tid = threadIdx.x;
    for (int i = tid; i < Q * NCH; i += THREADS) {
        const int r = i / NCH, ch = i % NCH;
        cp_async16(Bs + swz(r, ch, NCH), bb + r * a.b_s + ch * 8);
    }
    for (int i = tid; i < HB * Q * PCH; i += THREADS) {
        const int hh = i / (Q * PCH), r = (i / PCH) % Q, ch = i % PCH;
        const bf16* xb = static_cast<const bf16*>(a.x) + b * a.x_b
                         + (row0 + r) * a.x_s + (h0 + hh) * a.x_h;
        cp_async16(Xs + hh * Q * P + swz(r, ch, PCH), xb + ch * 8);
    }
    cp_async_commit();
    // seg of every head while the copies land, then w.
    for (int hh = 0; hh < HB; ++hh)
        chunk_seg(a, b, h0 + hh, c, dt_s + hh * Q, seg_s + hh * Q);
    // f_j = dt_j exp(seg_r - seg_j), r the last step of j's 16-step tile:
    // for i past that tile, exp(seg_i - seg_j) dt_j = exp(seg_i - seg_r) f_j,
    // both factors at most 1 (seg falls), so neither overflows.
    for (int i = tid; i < HB * Q; i += THREADS) {
        const double* segh = seg_s + (i / Q) * Q;
        const int j = i % Q;
        w_s[i] = dt_s[i] * expf(static_cast<float>(segh[Q - 1] - segh[j]));
        f_s[i] = dt_s[i] * expf(static_cast<float>(segh[j | 15] - segh[j]));
    }
    cp_async_wait<0>();
    __syncthreads();

    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int lm = lane / 8, lr = lane % 8;   // ldmatrix: matrix, row
    const int n_tiles = Q / 16;

    // ---- y_i over 16-row tiles of i, in snake order across the warps:
    // C_i . B_j^T once per (i, j) tile, then for each head its decay, dt_j
    // and the product with x_j.
    for (int round = 0; round * WARPS < n_tiles; ++round) {
        const int it = round * WARPS + (round % 2 ? WARPS - 1 - warp : warp);
        if (it >= n_tiles) continue;
        const int i0 = it * 16;
        uint32_t cf[KN][4];
        {
            const bf16* c0 = cb + (i0 + g) * a.c_s + 2 * t;
            const bf16* c1 = c0 + 8 * a.c_s;
#pragma unroll
            for (int kk = 0; kk < KN; ++kk) {
                cf[kk][0] = ld_global32(c0 + kk * 16);
                cf[kk][1] = ld_global32(c1 + kk * 16);
                cf[kk][2] = ld_global32(c0 + kk * 16 + 8);
                cf[kk][3] = ld_global32(c1 + kk * 16 + 8);
            }
        }
        const int irow[2] = {i0 + g, i0 + g + 8};
        double segi[HB][2];
#pragma unroll
        for (int hh = 0; hh < HB; ++hh) {
            segi[hh][0] = seg_s[hh * Q + irow[0]];
            segi[hh][1] = seg_s[hh * Q + irow[1]];
        }
        float acc[HB][NP][4];
#pragma unroll
        for (int hh = 0; hh < HB; ++hh)
#pragma unroll
            for (int nd = 0; nd < NP; ++nd)
#pragma unroll
                for (int e = 0; e < 4; ++e) acc[hh][nd][e] = 0.f;

        for (int jt = 0; jt <= it; ++jt) {
            const int j0 = jt * 16;
            // cbt[nt][e]: row irow[e >> 1], column j0 + 8 nt + 2t + (e & 1),
            // summed in two chains (even and odd k-steps) for latency.
            float cbt[2][4], cbu[2][4];
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) cbt[nt][e] = cbu[nt][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KN; ++kk) {
                uint32_t bf[4];
                ldmatrix_x4(bf, Bs + swz(j0 + (lm >> 1) * 8 + lr,
                                         2 * kk + (lm & 1), NCH));
                if (kk % 2) {
                    mma_bf16(cbu[0], cf[kk], bf[0], bf[1]);
                    mma_bf16(cbu[1], cf[kk], bf[2], bf[3]);
                } else {
                    mma_bf16(cbt[0], cf[kk], bf[0], bf[1]);
                    mma_bf16(cbt[1], cf[kk], bf[2], bf[3]);
                }
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                for (int e = 0; e < 4; ++e) cbt[nt][e] += cbu[nt][e];
            const bool diag = jt == it;
#pragma unroll
            for (int hh = 0; hh < HB; ++hh) {
                const double* segh = seg_s + hh * Q;
                float s[2][4];
                if (diag) {
                    const float* dth = dt_s + hh * Q;
#pragma unroll
                    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int j = j0 + 8 * nt + 2 * t + (e & 1);
                            // Selected, not multiplied: above the diagonal
                            // the decay overflows to inf, and inf * 0 is NaN.
                            s[nt][e] = j <= irow[e >> 1]
                                ? cbt[nt][e] * __expf(static_cast<float>(
                                      segi[hh][e >> 1] - segh[j])) * dth[j]
                                : 0.f;
                        }
                } else {
                    // exp(seg_i - seg_j) dt_j = exp(seg_i - seg_r) f_j with r
                    // = j0 + 15 < i: two exponentials a thread, not eight.
                    const double segr = segh[j0 + 15];
                    const float row[2] = {
                        __expf(static_cast<float>(segi[hh][0] - segr)),
                        __expf(static_cast<float>(segi[hh][1] - segr))};
                    const float* fh = f_s + hh * Q;
#pragma unroll
                    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
                        for (int e = 0; e < 4; ++e)
                            s[nt][e] = cbt[nt][e] * row[e >> 1]
                                * fh[j0 + 8 * nt + 2 * t + (e & 1)];
                }
                uint32_t ahi[4], alo[4];
                split_bf16(s[0][0], s[0][1], ahi[0], alo[0]);
                split_bf16(s[0][2], s[0][3], ahi[1], alo[1]);
                split_bf16(s[1][0], s[1][1], ahi[2], alo[2]);
                split_bf16(s[1][2], s[1][3], ahi[3], alo[3]);
                const bf16* xh = Xs + hh * Q * P;
#pragma unroll
                for (int np = 0; np < P / 16; ++np) {
                    uint32_t xf[4];
                    ldmatrix_x4_trans(xf, xh + swz(j0 + (lm & 1) * 8 + lr,
                                                   2 * np + (lm >> 1), PCH));
                    mma_bf16(acc[hh][2 * np], ahi, xf[0], xf[1]);
                    mma_bf16(acc[hh][2 * np], alo, xf[0], xf[1]);
                    mma_bf16(acc[hh][2 * np + 1], ahi, xf[2], xf[3]);
                    mma_bf16(acc[hh][2 * np + 1], alo, xf[2], xf[3]);
                }
            }
        }
#pragma unroll
        for (int hh = 0; hh < HB; ++hh) {
            float* y0 = a.y + b * a.y_b + (row0 + irow[0]) * a.y_s
                        + (h0 + hh) * a.y_h;
            float* y1 = y0 + 8 * a.y_s;
#pragma unroll
            for (int nd = 0; nd < NP; ++nd)
                store_c16(y0 + 8 * nd, y1 + 8 * nd, acc[hh][nd], t);
        }
    }

    // ---- S = (B w)^T x per head: units of (head, 16 rows of n), all P
    // columns.  A = B^T comes from B by ldmatrix .trans, scaled by w_j in
    // registers and split into hi + lo; x is the B operand as it is.
    constexpr int UNITS = HB * (N / 16);
    for (int u = warp; u < UNITS; u += WARPS) {
        const int hh = u / (N / 16), n0 = (u % (N / 16)) * 16;
        const bf16* xh = Xs + hh * Q * P;
        const float* wh = w_s + hh * Q;
        float acc[NP][4];
#pragma unroll
        for (int nd = 0; nd < NP; ++nd)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;
        for (int j0 = 0; j0 < Q; j0 += 16) {
            uint32_t af[4];
            ldmatrix_x4_trans(af, Bs + swz(j0 + (lm >> 1) * 8 + lr,
                                           n0 / 8 + (lm & 1), NCH));
            // af[0], af[1]: columns j0 + 2t, +1; af[2], af[3]: + 8.
            const float w0 = wh[j0 + 2 * t], w1 = wh[j0 + 2 * t + 1];
            const float w8 = wh[j0 + 2 * t + 8], w9 = wh[j0 + 2 * t + 9];
            uint32_t ahi[4], alo[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                const __nv_bfloat162 v =
                    *reinterpret_cast<const __nv_bfloat162*>(&af[q]);
                const float lo_w = q < 2 ? w0 : w8, hi_w = q < 2 ? w1 : w9;
                split_bf16(__low2float(v) * lo_w, __high2float(v) * hi_w,
                           ahi[q], alo[q]);
            }
#pragma unroll
            for (int np = 0; np < P / 16; ++np) {
                uint32_t xf[4];
                ldmatrix_x4_trans(xf, xh + swz(j0 + (lm & 1) * 8 + lr,
                                               2 * np + (lm >> 1), PCH));
                mma_bf16(acc[2 * np], ahi, xf[0], xf[1]);
                mma_bf16(acc[2 * np], alo, xf[0], xf[1]);
                mma_bf16(acc[2 * np + 1], ahi, xf[2], xf[3]);
                mma_bf16(acc[2 * np + 1], alo, xf[2], xf[3]);
            }
        }
        float* st = a.states
            + ((static_cast<long long>(b) * a.H + h0 + hh) * a.Nc + c) * N * P;
#pragma unroll
        for (int nd = 0; nd < NP; ++nd)
            store_c16(st + (n0 + g) * P + 8 * nd, st + (n0 + g + 8) * P + 8 * nd,
                      acc[nd], t);
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

template <int P, int N, int HB>
cudaError_t launch_bf16(const Args& a, int Bsz, cudaStream_t s) {
    const int smem = smem_bytes_bf16<P, N>(a.Q, HB);
    if (smem > SMEM_MAX) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        ssd_bf16<P, N, HB>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    ssd_bf16<P, N, HB><<<dim3(a.Nc, a.H / HB, Bsz), THREADS, smem, s>>>(a);
    return cudaGetLastError();
}

template <int P, int N>
cudaError_t launch(const Args& a, int Bsz, int dtype, int hb, cudaStream_t s) {
    if (dtype == 0) {
        ssd_f32<P, N><<<dim3(a.Nc, a.H, Bsz), THREADS, 0, s>>>(a);
        return cudaGetLastError();
    }
    switch (hb) {
        case 1: return launch_bf16<P, N, 1>(a, Bsz, s);
        case 2: return launch_bf16<P, N, 2>(a, Bsz, s);
        case 3: return launch_bf16<P, N, 3>(a, Bsz, s);
        default: return cudaErrorInvalidValue;
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B and C; dt and A are float32).
// Q divides S, is a multiple of 16 and at most 256; H is a multiple of G;
// P is 64 and N one of 16, 32, 64, 128.  Strides are in elements: batch,
// sequence, head (or group) axes of x, dt, B, C and y in that order; the
// last axis of x, B, C and y is contiguous, and for bfloat16 every row
// starts on 16 bytes.  y is float32 (its last axis contiguous); states
// [B, H, Nc, N, P] and seg [B, H, Nc, Q] are contiguous float32.  For
// bfloat16, heads_per_block (1 .. MAX_HEADS_PER_BLOCK, dividing H / G) is
// the wrapper's plan, and the y strides are multiples of 4 (16-byte
// stores); float32 does not read it.  Returns
// the CUDA error of the launch (0 on success); the wrapper checks the rest.
extern "C" int ssd_intra_chunk_fwd(
    const void* x, const void* dt, const void* A, const void* Bm,
    const void* Cm, void* y, void* states, void* seg, int Bsz, int S, int H,
    int G, int Q, int N, int P, int dtype, long long x_b,
    long long x_s, long long x_h, long long dt_b, long long dt_s,
    long long dt_h, long long b_b, long long b_s, long long b_g,
    long long c_b, long long c_s, long long c_g, long long y_b,
    long long y_s, long long y_h, int heads_per_block, void* stream) {
    if (Q < 16 || Q > MAX_Q || Q % 16 || S % Q || G < 1 || H % G || P != 64
            || (dtype == 1 && (heads_per_block < 1
                               || heads_per_block > MAX_HEADS_PER_BLOCK
                               || (H / G) % heads_per_block)))
        return static_cast<int>(cudaErrorInvalidValue);
    Args a{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           Bm, Cm, static_cast<float*>(y), static_cast<float*>(states),
           static_cast<float*>(seg), H, G, Q, S / Q, x_b, x_s, x_h, dt_b,
           dt_s, dt_h, b_b, b_s, b_g, c_b, c_s, c_g, y_b, y_s, y_h};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (N) {
        case 16: err = launch<64, 16>(a, Bsz, dtype, heads_per_block, s); break;
        case 32: err = launch<64, 32>(a, Bsz, dtype, heads_per_block, s); break;
        case 64: err = launch<64, 64>(a, Bsz, dtype, heads_per_block, s); break;
        case 128: err = launch<64, 128>(a, Bsz, dtype, heads_per_block, s); break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}
