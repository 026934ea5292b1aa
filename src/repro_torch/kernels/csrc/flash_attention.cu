// Causal / full GQA attention forward (flash attention) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` of the JAX package
// (src/repro/kernels/flash_attention.py:27, reached through `flash_attention`
// and the model-layout wrapper `ops.mha_flash`).
//
// What it computes, for every batch b, query head h and query row i:
//   out[b,i,h,:] = softmax_j(q[b,i,h,:] . k[b,j,h/n_rep,:] * D^-1/2) @ v[b,:,h/n_rep,:]
// over the keys j (j <= i when causal), with the reference kernel's numerics:
// f32 logits, masked logits -1e30, running max / denominator / accumulator
// in f32, p rounded to the value dtype before the P.V product, and
// out = acc / max(l, 1e-30) cast to q's dtype.
//
// What bounds it on an H100: operations.  At glm4-9b's prefill (B=8,
// S=1024, H=32, KV=2, D=128, bf16, causal) it does 68.7 GFLOP and moves
// 142.6 MB: 0.069 ms at the 989 TFLOP/s bf16 tensor-core peak against
// 0.043 ms at 3.35 TB/s; granite-moe's (H=16, KV=8, D=64) likewise.  The
// body it replaces (mma.sync, synchronous 64-key tile loads between two
// barriers, scalar shared loads for the V fragments) reached 6 % of that
// bound: its loads never overlapped the tensor cores.
//
// Design.  Two bodies, one per dtype.
//
// - bfloat16 (`flash_fwd_bf16`, the serving path): warp-specialised,
//   wgmma + TMA, persistent.  A work item is a (128-query tile, query head,
//   batch); at most one block per SM walks the items in strides of the
//   grid, heaviest causal tiles first.  Warpgroup 0 is the producer: one
//   thread loads each item's Q tile (once the consumers have released the
//   last one) and its 128-key K and V tiles into a two-stage ring, by TMA,
//   each stage with a "full" mbarrier for K, one for V, and an "empty" one
//   the consumers release it on (the producer keeps 40 registers); the
//   ring runs on across items, so the next item's loads overlap the
//   current one's last tiles and stores.  Warpgroups 1 and 2 are
//   consumers of 64 query rows each: S = Q K^T as wgmma m64n128k16 from
//   128-byte-swizzled shared tiles; the online softmax on the
//   accumulator's registers, in the log2 domain (scale * log2(e) folded
//   into the FMA before each ex2.approx, so a score costs one FMA, one
//   ex2, a max and an add);
//   p rounded to bf16 in registers, where it is already the A fragment of
//   O += P V, a wgmma with A from registers and V (D-contiguous) as the
//   transposed shared B operand.  TMA's 4-D maps over [B, S, heads, D]
//   (inner box 64 values: D 128 is two boxes) read any strides with a
//   contiguous head dimension, so the reference's [BH, S, D] layout is the
//   special case B = 1 of a permuted view.  Rows past Sq are loaded as
//   zeros and not stored; keys past Sk are loaded as zeros and masked.
//   Shared memory at D 128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB, one
//   block per SM.  -Xptxas -v on the H100 (nvcc 12.9): 168 registers at D
//   64 and 128 (384 threads; setmaxnreg 40 / 232), no spills.  ptxas keeps
//   the consumer branch within the launch's 168 whatever setmaxnreg asks,
//   so a form that overlapped each tile's softmax with the previous tile's
//   P V (FA3's intra-warpgroup pipelining, ~190 registers) spilled and ran
//   slower on the H100: the two consumers only overlap each other.
// - float32 (`flash_fwd_f32`): scalar FMAs (the tensor cores' TF32 would
//   not keep float32's digits).  256 threads, each owning a 4 x 4 piece of
//   the 64 x 64 score tile (rows ty + 16i, keys tx + 16j) and the same four
//   rows of the output; shared rows padded by 4 floats so that the 16-byte
//   shared loads of neighbouring rows fall in distinct banks; row reductions
//   over the 16 threads of a half-warp.
//
// Query head h reads kv head h / n_rep by index (no repeated K/V).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- float32

constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per K/V tile
constexpr int THREADS = 256;

template <int D>
constexpr int smem_bytes_f32() {
    return (BQ * (D + 4) + 2 * BK * (D + 4) + BQ * (BK + 4)) * 4;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ out,
          int Sq, int Sk, int n_rep, int causal, float scale,
          long long q_sb, long long q_ss, long long q_sh,
          long long k_sb, long long k_ss, long long k_sh,
          long long v_sb, long long v_ss, long long v_sh,
          long long o_sb, long long o_ss, long long o_sh) {
    constexpr int LD = D + 4;   // padded row of Qs / Ks / Vs, in floats
    constexpr int PLD = BK + 4;
    constexpr int NC = D / 64;  // 4-wide output column groups per thread
    extern __shared__ __align__(16) float smem[];
    float* Qs = smem;
    float* Ks = Qs + BQ * LD;
    float* Vs = Ks + BK * LD;
    float* Ps = Vs + BK * LD;

    const int tid = threadIdx.x;
    const int tx = tid % 16;
    const int ty = tid / 16;
    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / n_rep;
    const float* qb = q + b * q_sb + h * q_sh;
    const float* kb = k + b * k_sb + kvh * k_sh;
    const float* vb = v + b * v_sb + kvh * v_sh;

    for (int i = tid; i < BQ * D; i += THREADS) {
        const int r = i / D, c = i % D;
        const int qi = q0 + r;
        Qs[r * LD + c] = qi < Sq ? qb[qi * q_ss + c] : 0.f;
    }

    float m[4], l[4], acc[4][4 * NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < 4 * NC; ++c) acc[i][c] = 0.f;
    }

    int n_tiles = (Sk + BK - 1) / BK;
    if (causal) {
        const int last_q = min(q0 + BQ, Sq) - 1;
        n_tiles = min(n_tiles, last_q / BK + 1);
    }

    for (int t = 0; t < n_tiles; ++t) {
        const int k0 = t * BK;
        __syncthreads();  // the previous tile's readers of Ks / Vs / Ps are done
        for (int i = tid; i < BK * D; i += THREADS) {
            const int r = i / D, c = i % D;
            const int kj = k0 + r;
            const bool ok = kj < Sk;
            Ks[r * LD + c] = ok ? kb[kj * k_ss + c] : 0.f;
            Vs[r * LD + c] = ok ? vb[kj * v_ss + c] : 0.f;
        }
        __syncthreads();

        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
        for (int d = 0; d < D; d += 4) {
            float4 qv[4], kv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * LD + d]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                kv[j] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * j) * LD + d]);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    float a = s[i][j];
                    a = fmaf(qv[i].x, kv[j].x, a);
                    a = fmaf(qv[i].y, kv[j].y, a);
                    a = fmaf(qv[i].z, kv[j].z, a);
                    a = fmaf(qv[i].w, kv[j].w, a);
                    s[i][j] = a;
                }
        }

#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qi = q0 + ty + 16 * i;
            float mx = NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kj = k0 + tx + 16 * j;
                float x = s[i][j] * scale;
                if (kj >= Sk || (causal && kj > qi)) x = NEG_INF;
                s[i][j] = x;
                mx = fmaxf(mx, x);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
            const float m_new = fmaxf(m[i], mx);
            const float corr = expf(m[i] - m_new);
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float p = expf(s[i][j] - m_new);
                ps += p;
                Ps[(ty + 16 * i) * PLD + tx + 16 * j] = p;
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                ps += __shfl_xor_sync(0xffffffffu, ps, off);
            l[i] = l[i] * corr + ps;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < 4 * NC; ++c) acc[i][c] *= corr;
        }
        __syncthreads();  // Ps is complete

#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
            float p[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * PLD + kk];
#pragma unroll
            for (int cc = 0; cc < NC; ++cc) {
                const float4 vv =
                    *reinterpret_cast<const float4*>(&Vs[kk * LD + tx * 4 + 64 * cc]);
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                    acc[i][4 * cc + 0] = fmaf(p[i], vv.x, acc[i][4 * cc + 0]);
                    acc[i][4 * cc + 1] = fmaf(p[i], vv.y, acc[i][4 * cc + 1]);
                    acc[i][4 * cc + 2] = fmaf(p[i], vv.z, acc[i][4 * cc + 2]);
                    acc[i][4 * cc + 3] = fmaf(p[i], vv.w, acc[i][4 * cc + 3]);
                }
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int qi = q0 + ty + 16 * i;
        if (qi >= Sq) continue;
        const float den = fmaxf(l[i], 1e-30f);
        float* ob = out + b * o_sb + qi * o_ss + h * o_sh;
#pragma unroll
        for (int cc = 0; cc < NC; ++cc)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                ob[tx * 4 + 64 * cc + e] = acc[i][4 * cc + e] / den;
    }
}

// --------------------------------------------------------------- bfloat16

constexpr int BF16_BQ = 128;        // queries per block: 2 consumers x 64
constexpr int BF16_BK = 128;        // keys per K/V tile
constexpr int BF16_STAGES = 2;      // K/V ring depth
constexpr int BF16_THREADS = 384;   // producer + 2 consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;  // 128 x 40 + 256 x 232 = 384 x 168
constexpr float LOG2E = 1.4426950408889634f;
// One TMA box: 128 rows of 64 bf16 values (128 bytes).
constexpr uint32_t BOX_BYTES = 128 * 64 * 2;

template <int D>
struct FlashSmem {
    bf16 q[D / 64][BF16_BQ * 64];
    bf16 k[BF16_STAGES][D / 64][BF16_BK * 64];
    bf16 v[BF16_STAGES][D / 64][BF16_BK * 64];
    uint64_t q_full, q_empty;
    uint64_t k_full[BF16_STAGES], v_full[BF16_STAGES], empty[BF16_STAGES];
};

__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Two floats rounded to bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
}

// One work item: a 128-query tile of one (query head, batch).  Items are
// numbered heaviest first (the last query tiles of a causal mask see the
// most keys), heads fastest, so blocks that walk them in strides of the
// grid get even shares and neighbouring items share a kv head in L2.
struct FlashItem {
    int q0, h, b, n_tiles;
};

__device__ __forceinline__ FlashItem flash_item(int item, int H, int B,
                                                int n_qt, int Sq, int Sk,
                                                int causal) {
    FlashItem it;
    it.h = item % H;
    it.b = (item / H) % B;
    it.q0 = (n_qt - 1 - item / (H * B)) * BF16_BQ;
    it.n_tiles = (Sk + BF16_BK - 1) / BF16_BK;
    if (causal)
        it.n_tiles = min(it.n_tiles,
                         (min(it.q0 + BF16_BQ, Sq) - 1) / BF16_BK + 1);
    return it;
}

// Persistent: gridDim.x blocks (at most one per SM) walk the items
// blockIdx.x, blockIdx.x + gridDim.x, ...; the K/V ring and the Q buffer
// carry on from one item to the next, so the producer loads the next
// item's Q and first tiles while the consumers finish the current one.
template <int D>
__global__ void __launch_bounds__(BF16_THREADS, 1)
flash_fwd_bf16(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               bf16* __restrict__ out, int B, int H, int Sq, int Sk,
               int n_rep, int causal, float scale_log2, long long o_sb,
               long long o_ss, long long o_sh) {
    using namespace hopper;
    constexpr int NB = D / 64;        // 64-wide boxes per row
    extern __shared__ unsigned char smem_raw[];
    FlashSmem<D>& sm = *reinterpret_cast<FlashSmem<D>*>(align1024(smem_raw));
    const int n_qt = (Sq + BF16_BQ - 1) / BF16_BQ;
    const int n_items = n_qt * H * B;

    if (threadIdx.x == 0) {
        mbar_init(&sm.q_full, 1);
        mbar_init(&sm.q_empty, CONSUMER_WARPS);
        for (int s = 0; s < BF16_STAGES; ++s) {
            mbar_init(&sm.k_full[s], 1);
            mbar_init(&sm.v_full[s], 1);
            mbar_init(&sm.empty[s], CONSUMER_WARPS);
        }
        fence_barrier_init();
    }
    __syncthreads();

    if (threadIdx.x < 128) {
        // ------------------------------------------------------ producer
        setmaxnreg_dec<PRODUCER_REGS>();
        if (threadIdx.x == 0) {
            int tile = 0, round = 0;    // ring position, items so far
            for (int item = blockIdx.x; item < n_items;
                 item += gridDim.x, ++round) {
                const FlashItem it = flash_item(item, H, B, n_qt, Sq, Sk,
                                                causal);
                const int kvh = it.h / n_rep;
                mbar_wait(&sm.q_empty, (round & 1) ^ 1);
                mbar_arrive_expect_tx(&sm.q_full, NB * BOX_BYTES);
#pragma unroll
                for (int c = 0; c < NB; ++c)
                    tma_load_4d(sm.q[c], &tm_q, &sm.q_full, 64 * c, it.h,
                                it.q0, it.b);
                for (int t = 0; t < it.n_tiles; ++t, ++tile) {
                    const int s = tile % BF16_STAGES;
                    const uint32_t phase = (tile / BF16_STAGES) & 1;
                    mbar_wait(&sm.empty[s], phase ^ 1);
                    mbar_arrive_expect_tx(&sm.k_full[s], NB * BOX_BYTES);
#pragma unroll
                    for (int c = 0; c < NB; ++c)
                        tma_load_4d(sm.k[s][c], &tm_k, &sm.k_full[s], 64 * c,
                                    kvh, t * BF16_BK, it.b);
                    mbar_arrive_expect_tx(&sm.v_full[s], NB * BOX_BYTES);
#pragma unroll
                    for (int c = 0; c < NB; ++c)
                        tma_load_4d(sm.v[s][c], &tm_v, &sm.v_full[s], 64 * c,
                                    kvh, t * BF16_BK, it.b);
                }
            }
        }
    } else {
        // ----------------------------------------------------- consumers
        setmaxnreg_inc<CONSUMER_REGS>();
        const int cw = threadIdx.x / 128 - 1;    // rows 64 cw .. 64 cw + 63
        const int warp = (threadIdx.x / 32) % 4;
        const int lane = threadIdx.x % 32;
        const int g = lane / 4, tq = lane % 4;   // accumulator row, column pair
        int tile = 0, round = 0;
        for (int item = blockIdx.x; item < n_items;
             item += gridDim.x, ++round) {
            const FlashItem it = flash_item(item, H, B, n_qt, Sq, Sk, causal);
            const int first_row = it.q0 + 64 * cw;
            const int rows[2] = {first_row + 16 * warp + g,
                                 first_row + 16 * warp + g + 8};

            float o[D / 2];      // O accumulator, m64nD layout
            float s[64];         // S tile, m64n128 layout
#pragma unroll
            for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
            for (int i = 0; i < 64; ++i) s[i] = 0.f;
            float m_run[2] = {NEG_INF, NEG_INF};
            float l_run[2] = {0.f, 0.f};  // own columns; quad-summed last

            mbar_wait(&sm.q_full, round & 1);
            for (int t = 0; t < it.n_tiles; ++t, ++tile) {
                const int st = tile % BF16_STAGES;
                const uint32_t phase = (tile / BF16_STAGES) & 1;
                const int k0 = t * BF16_BK;

                // S = Q K^T: D/16 k-steps, 32 bytes apart inside a 64-wide
                // box.  After the last tile's, Q may be replaced.
                mbar_wait(&sm.k_full[st], phase);
                fence_operand(s);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < D / 16; ++kk) {
                    const uint32_t off = (kk % 4) * 32;
                    const uint64_t da = sw128_desc(
                        smem_u32(sm.q[kk / 4]) + cw * 64 * 128 + off, 16, 1024);
                    const uint64_t db = sw128_desc(
                        smem_u32(sm.k[st][kk / 4]) + off, 16, 1024);
                    wgmma_m64n128k16_ss<0>(s, da, db, kk > 0);
                }
                wgmma_commit();
                wgmma_wait<0>();
                fence_operand(s);
                if (t + 1 == it.n_tiles) {
                    __syncwarp();
                    if (lane == 0) mbar_arrive(&sm.q_empty);
                }

                // Online softmax in the log2 domain.  s[4j + e] is row
                // rows[e / 2], key k0 + 8j + 2tq + e % 2.  The scale
                // c = D^-1/2 log2(e) > 0 is folded in: max(c s) = c max(s),
                // and p = 2^(c s - m) is one FMA and one ex2.
                const bool edge = k0 + BF16_BK > Sk
                    || (causal && k0 + BF16_BK - 1 > first_row);
                float mx[2] = {NEG_INF, NEG_INF};
                if (edge) {
#pragma unroll
                    for (int j = 0; j < 16; ++j)
#pragma unroll
                        for (int e = 0; e < 4; ++e) {
                            const int key = k0 + 8 * j + 2 * tq + (e & 1);
                            if (key >= Sk || (causal && key > rows[e >> 1]))
                                s[4 * j + e] = NEG_INF;
                        }
                }
#pragma unroll
                for (int i = 0; i < 64; ++i)
                    mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
                float corr[2];
#pragma unroll
                for (int r = 0; r < 2; ++r) {
                    mx[r] = fmaxf(mx[r],
                                  __shfl_xor_sync(0xffffffffu, mx[r], 1));
                    mx[r] = fmaxf(mx[r],
                                  __shfl_xor_sync(0xffffffffu, mx[r], 2));
                    const float m_new = fmaxf(m_run[r], mx[r] * scale_log2);
                    corr[r] = ex2(m_run[r] - m_new);
                    m_run[r] = m_new;
                    l_run[r] *= corr[r];
                }
                // p, rounded to bf16: the n8 blocks 2kt, 2kt + 1 of the
                // score accumulator are the A fragment of k-step kt of P V.
                uint32_t pf[8][4];
#pragma unroll
                for (int kt = 0; kt < 8; ++kt) {
                    float p[8];
#pragma unroll
                    for (int e = 0; e < 8; ++e) {
                        p[e] = ex2(fmaf(s[8 * kt + e], scale_log2,
                                        -m_run[(e >> 1) & 1]));
                        l_run[(e >> 1) & 1] += p[e];
                    }
                    pf[kt][0] = pack_bf16(p[0], p[1]);
                    pf[kt][1] = pack_bf16(p[2], p[3]);
                    pf[kt][2] = pack_bf16(p[4], p[5]);
                    pf[kt][3] = pack_bf16(p[6], p[7]);
                }
#pragma unroll
                for (int i = 0; i < D / 8; ++i) {
                    o[4 * i + 0] *= corr[0];
                    o[4 * i + 1] *= corr[0];
                    o[4 * i + 2] *= corr[1];
                    o[4 * i + 3] *= corr[1];
                }

                // O += P V: V is [keys][D], D-contiguous, so the transposed
                // (N-major) B operand; a k16 step is 16 rows = 2048 bytes,
                // and the second 64-wide box of D 128 lies one box further.
                mbar_wait(&sm.v_full[st], phase);
                fence_operand(o);
                wgmma_fence();
#pragma unroll
                for (int kt = 0; kt < 8; ++kt) {
                    const uint64_t db = sw128_desc(
                        smem_u32(sm.v[st][0]) + kt * 2048, BOX_BYTES, 1024);
                    if constexpr (D == 128)
                        wgmma_m64n128k16_rs<1>(o, pf[kt], db, 1);
                    else
                        wgmma_m64n64k16_rs<1>(o, pf[kt], db, 1);
                }
                wgmma_commit();
                wgmma_wait<0>();
                fence_operand(o);
                __syncwarp();
                if (lane == 0) mbar_arrive(&sm.empty[st]);
            }

#pragma unroll
            for (int r = 0; r < 2; ++r) {
                l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
                l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
                if (rows[r] >= Sq) continue;
                const float den = fmaxf(l_run[r], 1e-30f);
                bf16* ob = out + it.b * o_sb + rows[r] * o_ss + it.h * o_sh
                    + 2 * tq;
#pragma unroll
                for (int i = 0; i < D / 8; ++i)
                    *reinterpret_cast<__nv_bfloat162*>(ob + 8 * i) =
                        __floats2bfloat162_rn(o[4 * i + 2 * r] / den,
                                              o[4 * i + 2 * r + 1] / den);
            }
        }
    }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
                       int B, int Sq, int Sk, int H, int KV, int causal,
                       float scale, const long long* st, cudaStream_t stream) {
    constexpr int smem = smem_bytes_f32<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    flash_fwd_f32<D><<<dim3((Sq + BQ - 1) / BQ, H, B), THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk,
        H / KV, causal, scale, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11]);
    return static_cast<int>(cudaGetLastError());
}

// One 4-D tensor map over a bf16 [B, S, heads, D] tensor (element strides
// st[0..2] of the batch, sequence and head axes), box {64, 1, 128, 1}.
inline int flash_map(CUtensorMap* map, const void* base, int B, int S,
                     int heads, int D, const long long* st) {
    const uint64_t sizes[4] = {static_cast<uint64_t>(D),
                               static_cast<uint64_t>(heads),
                               static_cast<uint64_t>(S),
                               static_cast<uint64_t>(B)};
    const uint64_t strides[3] = {static_cast<uint64_t>(st[2]) * 2,
                                 static_cast<uint64_t>(st[1]) * 2,
                                 static_cast<uint64_t>(st[0]) * 2};
    const uint32_t box[4] = {64, 1, 128, 1};
    return hopper::encode_tiled(map, base, 4, sizes, strides, box);
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int Sq, int Sk, int H, int KV, int causal,
                float scale, const long long* st, cudaStream_t stream) {
    CUtensorMap tm_q, tm_k, tm_v;
    int rc = flash_map(&tm_q, q, B, Sq, H, D, st);
    if (rc == 0) rc = flash_map(&tm_k, k, B, Sk, KV, D, st + 3);
    if (rc == 0) rc = flash_map(&tm_v, v, B, Sk, KV, D, st + 6);
    if (rc != 0) return rc;
    constexpr int smem = sizeof(FlashSmem<D>) + 1024;
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                     device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const long long items =
        static_cast<long long>((Sq + BF16_BQ - 1) / BF16_BQ) * H * B;
    const int grid = static_cast<int>(items < sms ? items : sms);
    flash_fwd_bf16<D><<<grid, BF16_THREADS, smem, stream>>>(
        tm_q, tm_k, tm_v, static_cast<bf16*>(out), B, H, Sq, Sk, H / KV,
        causal, scale * LOG2E, st[9], st[10], st[11]);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; scale is the caller's 1/sqrt(D) rounded
// to float, as the reference multiplies its f32 logits by it.  Strides are
// in elements, for the batch, sequence and head axes of q, k, v and out in
// that order; the head dimension D (64 or 128) is contiguous, and for
// bfloat16 the base addresses and strides are multiples of 16 bytes (TMA).
// Returns the CUDA error of the launch (0 on success), or
// hopper::TMAP_ERROR + the driver's CUresult if a tensor map cannot be
// encoded; the wrapper checks everything else.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int B, int Sq,
    int Sk, int H, int KV, int D, int causal, int dtype, float scale,
    long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    long long o_sb, long long o_ss, long long o_sh, void* stream) {
    const long long st[12] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                              v_sb, v_ss, v_sh, o_sb, o_ss, o_sh};
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && D == 64)
        return launch_f32<64>(q, k, v, out, B, Sq, Sk, H, KV, causal, scale, st, s);
    if (dtype == 0 && D == 128)
        return launch_f32<128>(q, k, v, out, B, Sq, Sk, H, KV, causal, scale, st, s);
    if (dtype == 1 && D == 64)
        return launch_bf16<64>(q, k, v, out, B, Sq, Sk, H, KV, causal, scale, st, s);
    if (dtype == 1 && D == 128)
        return launch_bf16<128>(q, k, v, out, B, Sq, Sk, H, KV, causal, scale, st, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
