// One-token GQA attention against a KV cache (split-K flash decode) for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_decode_kernel` of the JAX package and the
// cross-split combine of its wrapper (src/repro/kernels/decode_attention.py,
// reached through `decode_attention` and the model-layout wrapper
// `ops.mha_decode`).
//
// What it computes, for every batch b and query head h:
//   out[b,h,:] = softmax_j(q[b,h,:] . k[b,j,h/n_rep,:] * D^-1/2) @ v[b,:,h/n_rep,:]
// over the cache positions j <= cache_len (inclusive: the new token sits at
// index cache_len), with the reference's numerics: f32 logits; partials
// m = max logit, l = sum exp(logit - m) and acc = sum round(p) * v (p
// rounded to the value dtype); the combine takes w = exp(m - max m),
// out = sum(acc * w) / max(sum(l * w), 1e-30).
//
// What bounds it on an H100: bytes.  At the serving path's decode (cache
// [8, 1064, 2, 128] bf16, about 1056 valid positions, 32 query heads) it
// reads about 8.7 MB of K and V and does about 138 MFLOP: about 2.6 us at
// 3.35 TB/s against 0.14 us at the bf16 tensor-core rate.  A launch that
// reads 8.7 MB is short next to its own ramp-up, so what the design cuts
// is latency: one launch, one wave, loads overlapped with the products.
//
// bfloat16 (`decode_bf16`): one launch.  The cache of one (batch, kv head,
// group of up to 16 query heads) is cut into `n_splits` splits of
// `split_len` positions (the plan of the wrapper's `split_plan`: splits
// of a multiple of 16 positions, as many as make B * KV * groups * splits
// about one wave of the card's SMs, at most MAX_SPLITS); one block of four
// warps per split, and the splits of one (b, kv head, group) form one
// thread-block cluster.  A block carries all the query heads of its group
// as the 16 rows of mma.sync m16n8k16 tiles (rows past n_rep are zero), so
// each K/V byte is read once for every head that shares it.  K and V go
// through a three-stage ring of 64-position tiles in shared memory, loaded
// with 16-byte cp.async (zero-filled past the split, the cache or
// cache_len) in a chunk-XOR-swizzled layout, so the next tiles load while
// the current one is multiplied.  Each warp takes 16 positions of a tile:
// Q.K^T on the tensor cores (Q's A fragments held in registers, K's B
// fragments by ldmatrix), the scale, the mask `pos <= cache_len` SELECTED
// (a masked logit is -1e30, its p exactly 0), an online softmax across
// the split's tiles in f32, then p rounded to bf16 as the A fragment of
// P.V (the reference's rounding of p to the value dtype; V's B fragments
// by ldmatrix .trans).  Each warp leaves (m, l, acc) of its positions in
// shared memory, and the block merges its warps' into one partial (the
// combine's own form); after a cluster barrier every block combines a
// slice of the group's [heads, D] outputs over the cluster's blocks
// through distributed shared memory, and a second barrier keeps every
// block alive until its partial is read.  No block returns early:
// one whose split starts past cache_len loads and multiplies nothing, and
// its partials (m = -1e30, l = 0, acc = 0) weigh exp(-1e30 - m*) = 0 in the
// combine, so every block reaches both barriers and none can be waited
// for in vain.  cache_len is read through a device pointer (no host read),
// and the split plan depends on the shapes only.  The wrapper allocates
// the output and nothing else.
//
// float32 (`decode_partial` + `decode_combine`, two launches): one block of
// 256 threads per (64-position split, kv head, group of up to 16 query
// heads, batch), K and V converted to f32 in shared memory, scalar FMAs
// (the tensor cores would round float32 to TF32), the partials through
// global scratch the wrapper allocates, then a combine kernel.
//
// The statistics form (`decode_attention_stats_fwd`), for a caller that
// holds one block of a cache whose other blocks lie elsewhere (the
// fully-seq cache layout: the sequence split over the data axes): the same
// launches, whose combine also writes its m* = max m and sum(l * w) per
// (batch, head), with the output in float32, not rounded.  A caller's
// combine of such blocks (w_b = l_b * exp(m_b - max m)) is the combine of
// the splits of all of them.  A block past the current token has a
// cache_len of -1: it loads nothing and writes m = -1e30, l = 0, out = 0.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "warp_mma.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace warp_mma;

constexpr int SPLIT = 64;    // float32: cache positions per split
constexpr int HG = 16;       // query heads per block at most
constexpr int THREADS = 256; // float32 block
constexpr float NEG_INF = -1e30f;

// bfloat16 plan: 64-position tiles, four warps of 16 positions each, a
// three-stage ring, splits of a multiple of 16 positions, at most 8 blocks
// (the portable cluster size) per (batch, kv head, head group).
constexpr int TILE = 64;
constexpr int BF16_WARPS = 4;
constexpr int STAGES = 3;
constexpr int SPLIT_MULTIPLE = 16;
constexpr int MAX_SPLITS = 8;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }

// ---------------------------------------------------------------- float32

template <int D>
constexpr int smem_bytes() {
    return (HG * D + SPLIT * (D + 1) + SPLIT * D + HG * SPLIT) * 4;
}

// m, l: [B, H, n_s]; acc: [B, H, n_s, D], all f32 and contiguous.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
decode_partial(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const int* __restrict__ cache_len,
               float* __restrict__ m_out, float* __restrict__ l_out,
               float* __restrict__ acc_out, int S, int H, int n_rep,
               int n_groups, int n_s, float scale, long long q_sb,
               long long q_sh, long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh) {
    const int split = blockIdx.x;
    const int len = *cache_len;
    const int s0 = split * SPLIT;
    if (s0 > len) return;

    extern __shared__ __align__(16) float smem[];
    float* qs = smem;                  // [HG][D]
    float* ks = qs + HG * D;           // [SPLIT][D + 1]
    float* vs = ks + SPLIT * (D + 1);  // [SPLIT][D]
    float* ps = vs + SPLIT * D;        // [HG][SPLIT]

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int kvh = blockIdx.y / n_groups;
    const int g = blockIdx.y % n_groups;
    const int b = blockIdx.z;
    const int h0 = kvh * n_rep + g * HG;
    const int hg = min(HG, n_rep - g * HG);
    const int n_keys = min(SPLIT, S - s0);
    const T* kb = k + b * k_sb + kvh * k_sh + s0 * k_ss;
    const T* vb = v + b * v_sb + kvh * v_sh + s0 * v_ss;

    for (int i = tid; i < hg * D; i += THREADS) {
        const int hh = i / D, d = i % D;
        qs[hh * D + d] = to_f<T>(q[b * q_sb + (h0 + hh) * q_sh + d]);
    }
    for (int i = tid; i < n_keys * D; i += THREADS) {
        const int r = i / D, d = i % D;
        ks[r * (D + 1) + d] = to_f<T>(kb[r * k_ss + d]);
        vs[r * D + d] = to_f<T>(vb[r * v_ss + d]);
    }
    __syncthreads();

    // Scores, one (head, position) pair per thread and iteration.
    for (int i = tid; i < hg * SPLIT; i += THREADS) {
        const int hh = i / SPLIT, r = i % SPLIT;
        float x = NEG_INF;
        if (r < n_keys && s0 + r <= len) {
            float a = 0.f;
#pragma unroll 8
            for (int d = 0; d < D; ++d) a = fmaf(qs[hh * D + d], ks[r * (D + 1) + d], a);
            x = a * scale;
        }
        ps[hh * SPLIT + r] = x;
    }
    __syncthreads();

    // The split's softmax, one warp per head (SPLIT = 2 x 32 positions).
    for (int hh = warp; hh < hg; hh += THREADS / 32) {
        const float a = ps[hh * SPLIT + lane];
        const float c = ps[hh * SPLIT + lane + 32];
        float mx = fmaxf(a, c);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const bool va = lane < n_keys && s0 + lane <= len;
        const bool vc = lane + 32 < n_keys && s0 + lane + 32 <= len;
        const float pa = va ? expf(a - mx) : 0.f;
        const float pc = vc ? expf(c - mx) : 0.f;
        float sum = pa + pc;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
        ps[hh * SPLIT + lane] = to_f<T>(from_f<T>(pa));
        ps[hh * SPLIT + lane + 32] = to_f<T>(from_f<T>(pc));
        if (lane == 0) {
            const long long o = (static_cast<long long>(b) * H + h0 + hh) * n_s + split;
            m_out[o] = mx;
            l_out[o] = sum;
        }
    }
    __syncthreads();

    // acc = P.V, one (head, dim) output per thread and iteration.
    for (int i = tid; i < hg * D; i += THREADS) {
        const int hh = i / D, d = i % D;
        float a = 0.f;
        for (int r = 0; r < n_keys; ++r) a = fmaf(ps[hh * SPLIT + r], vs[r * D + d], a);
        const long long o = (static_cast<long long>(b) * H + h0 + hh) * n_s + split;
        acc_out[o * D + d] = a;
    }
}

// STATS: also the combine's m* (m_out) and sum(l * w) (l_out), [B, H].
template <typename T, int D, bool STATS>
__global__ void decode_combine(const float* __restrict__ m,
                               const float* __restrict__ l,
                               const float* __restrict__ acc,
                               const int* __restrict__ cache_len,
                               T* __restrict__ out, float* __restrict__ m_out,
                               float* __restrict__ l_out, int H, int n_s,
                               long long o_sb, long long o_sh) {
    const int h = blockIdx.x, b = blockIdx.y, d = threadIdx.x;
    const int len = *cache_len;
    const int n_valid = len < 0 ? 0 : min(n_s, len / SPLIT + 1);
    const long long base = (static_cast<long long>(b) * H + h) * n_s;
    float m_star = NEG_INF;
    for (int s = 0; s < n_valid; ++s) m_star = fmaxf(m_star, m[base + s]);
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_valid; ++s) {
        const float w = expf(m[base + s] - m_star);
        num = fmaf(acc[(base + s) * D + d], w, num);
        den = fmaf(l[base + s], w, den);
    }
    out[b * o_sb + h * o_sh + d] = from_f<T>(num / fmaxf(den, 1e-30f));
    if (STATS && d == 0) {
        m_out[static_cast<long long>(b) * H + h] = m_star;
        l_out[static_cast<long long>(b) * H + h] = den;
    }
}


// -------------------------------------------------------------- bfloat16

// The ring of K/V tiles; the warps' partials, the block's merged partial
// and the warps' weights in it reuse it after the last tile.
template <int D>
constexpr int bf16_smem_bytes() {
    constexpr int ring = STAGES * 2 * TILE * D * 2;
    constexpr int parts = (BF16_WARPS + 1) * HG * (D + 2) * 4
                          + BF16_WARPS * HG * 4;
    return ring > parts ? ring : parts;
}

// Grid (n_splits, KV * n_groups, B), clusters of (n_splits, 1, 1): block x
// is split x of its (batch, kv head, head group) and rank x of its cluster.
// STATS: the output is float32, not rounded to bf16, and the combine's m*
// (m_out) and sum(l * w) (l_out), [B, H], are written beside it.
template <int D, bool STATS>
__global__ void __launch_bounds__(BF16_WARPS * 32)
decode_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const int* __restrict__ cache_len,
            void* __restrict__ out, float* __restrict__ m_out,
            float* __restrict__ l_out, int S, int n_rep, int n_groups,
            int split_len, float scale, long long q_sb, long long q_sh,
            long long k_sb, long long k_ss, long long k_sh, long long v_sb,
            long long v_ss, long long v_sh, long long o_sb, long long o_sh) {
    constexpr int NCH = D / 8;       // 16-byte chunks per K/V row
    constexpr int KD = D / 16;       // k-steps of Q.K^T
    constexpr int ND = D / 8;        // n8 tiles of P.V
    constexpr int TILE_ELTS = TILE * D;
    extern __shared__ __align__(128) unsigned char smem_raw[];
    bf16* ring = reinterpret_cast<bf16*>(smem_raw);   // [STAGES][K | V][TILE][D]
    float* m_s = reinterpret_cast<float*>(smem_raw);  // [BF16_WARPS][HG]
    float* l_s = m_s + BF16_WARPS * HG;               // [BF16_WARPS][HG]
    float* acc_s = l_s + BF16_WARPS * HG;             // [BF16_WARPS][HG][D]
    float* bm_s = acc_s + BF16_WARPS * HG * D;        // [HG]: the block's m,
    float* bl_s = bm_s + HG;                          // [HG]: l
    float* bacc_s = bl_s + HG;                        // [HG][D]: and acc
    float* wt_s = bacc_s + HG * D;                    // [BF16_WARPS][HG]

    cg::cluster_group cluster = cg::this_cluster();
    const int split = blockIdx.x;
    const int n_s = gridDim.x;
    const int kvh = blockIdx.y / n_groups, grp = blockIdx.y % n_groups;
    const int b = blockIdx.z;
    const int h0 = kvh * n_rep + grp * HG;
    const int hg = min(HG, n_rep - grp * HG);
    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int lm = lane / 8, lr = lane % 8;   // ldmatrix: matrix, row
    const int len = *cache_len;
    const int s0 = split * split_len;
    const int end = min(min(s0 + split_len, S), len + 1);
    const int n_tiles = end > s0 ? (end - s0 + TILE - 1) / TILE : 0;

    const bf16* kb = k + b * k_sb + kvh * k_sh;
    const bf16* vb = v + b * v_sb + kvh * v_sh;
    // Tile `tile` of the split into its ring stage; rows at or past `end`
    // are zero-filled (their logits are masked, and a zero V row keeps
    // 0 * v finite whatever the cache holds there).
    auto load_tile = [&](int tile) {
        bf16* ks = ring + (tile % STAGES) * 2 * TILE_ELTS;
        bf16* vs = ks + TILE_ELTS;
        const int p0 = s0 + tile * TILE;
        for (int i = tid; i < TILE * NCH; i += BF16_WARPS * 32) {
            const int r = i / NCH, c = i % NCH;
            const bool ok = p0 + r < end;
            const long long pos = ok ? p0 + r : s0;
            cp_async16(ks + swz(r, c, NCH), kb + pos * k_ss + c * 8, ok);
            cp_async16(vs + swz(r, c, NCH), vb + pos * v_ss + c * 8, ok);
        }
    };
#pragma unroll
    for (int st = 0; st < STAGES - 1; ++st) {
        if (st < n_tiles) load_tile(st);
        cp_async_commit();
    }

    // The group's queries as A fragments, rows past n_rep zero.
    uint32_t qa[KD][4];
    {
        const bf16* q0 = q + b * q_sb + (h0 + g) * q_sh;
        const bf16* q1 = q0 + 8 * q_sh;
        const bool v0 = g < hg, v1 = g + 8 < hg;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            const int c = kk * 16 + 2 * t;
            qa[kk][0] = v0 ? ld_global32(q0 + c) : 0u;
            qa[kk][1] = v1 ? ld_global32(q1 + c) : 0u;
            qa[kk][2] = v0 ? ld_global32(q0 + c + 8) : 0u;
            qa[kk][3] = v1 ? ld_global32(q1 + c + 8) : 0u;
        }
    }

    // Rows g and g + 8 (query heads) of this warp's online softmax.
    float m_run[2] = {NEG_INF, NEG_INF};
    float l_run[2] = {0.f, 0.f};
    float acc[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nd][e] = 0.f;

    const int r0 = warp * 16;   // this warp's rows of every tile
    for (int tile = 0; tile < n_tiles; ++tile) {
        cp_async_wait<STAGES - 2>();
        __syncthreads();   // tile landed; every warp is done with tile - 1
        if (tile + STAGES - 1 < n_tiles) load_tile(tile + STAGES - 1);
        cp_async_commit();
        const bf16* ks = ring + (tile % STAGES) * 2 * TILE_ELTS;
        const bf16* vs = ks + TILE_ELTS;

        // s[nt][e]: head row g + 8 (e >> 1), position p0 + 8 nt + 2t + (e & 1).
        float s[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
            uint32_t kf[4];
            ldmatrix_x4(kf, ks + swz(r0 + (lm >> 1) * 8 + lr, 2 * kk + (lm & 1),
                                     NCH));
            mma_bf16(s[0], qa[kk], kf[0], kf[1]);
            mma_bf16(s[1], qa[kk], kf[2], kf[3]);
        }
        const int p0 = s0 + tile * TILE + r0;
        float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool ok = p0 + 8 * nt + 2 * t + (e & 1) < end;
                s[nt][e] = ok ? s[nt][e] * scale : NEG_INF;
                mx[e >> 1] = fmaxf(mx[e >> 1], s[nt][e]);
            }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            corr[r] = expf(m_run[r] - mx[r]);
            m_run[r] = mx[r];
            l_run[r] *= corr[r];
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const bool ok = p0 + 8 * nt + 2 * t + (e & 1) < end;
                s[nt][e] = ok ? expf(s[nt][e] - mx[e >> 1]) : 0.f;
                l_run[e >> 1] += s[nt][e];
            }
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[nd][e] *= corr[e >> 1];
        // p rounded to bf16: the A fragment of P.V over the warp's 16
        // positions.
        const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]),
                                pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]),
                                pack_bf16(s[1][2], s[1][3])};
#pragma unroll
        for (int nd = 0; nd < ND; nd += 2) {
            uint32_t vf[4];
            ldmatrix_x4_trans(vf, vs + swz(r0 + (lm & 1) * 8 + lr,
                                           nd + (lm >> 1), NCH));
            mma_bf16(acc[nd], pa, vf[0], vf[1]);
            mma_bf16(acc[nd + 1], pa, vf[2], vf[3]);
        }
    }

    // The warp's partials, in the ring's place.
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
        float l = l_run[r];
        l += __shfl_xor_sync(0xffffffffu, l, 1);
        l += __shfl_xor_sync(0xffffffffu, l, 2);
        const int row = warp * HG + g + 8 * r;
        if (t == 0) {
            m_s[row] = m_run[r];
            l_s[row] = l;
        }
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
            *reinterpret_cast<float2*>(acc_s + row * D + nd * 8 + 2 * t) =
                make_float2(acc[nd][2 * r], acc[nd][2 * r + 1]);
    }
    __syncthreads();

    // The block's partial: the warps' merged, w = exp(m_w - max_w m_w).
    if (tid < HG) {
        float m = NEG_INF;
#pragma unroll
        for (int w = 0; w < BF16_WARPS; ++w) m = fmaxf(m, m_s[w * HG + tid]);
        float l = 0.f;
#pragma unroll
        for (int w = 0; w < BF16_WARPS; ++w) {
            const float wt = expf(m_s[w * HG + tid] - m);
            wt_s[w * HG + tid] = wt;
            l = fmaf(l_s[w * HG + tid], wt, l);
        }
        bm_s[tid] = m;
        bl_s[tid] = l;
    }
    __syncthreads();
    for (int i = tid; i < hg * D; i += BF16_WARPS * 32) {
        const int hh = i / D;
        float a = 0.f;
#pragma unroll
        for (int w = 0; w < BF16_WARPS; ++w)
            a = fmaf(acc_s[w * HG * D + i], wt_s[w * HG + hh], a);
        bacc_s[i] = a;
    }
    cluster.sync();   // every block's partial is in its shared memory

    // This block's slice of the group's [hg, D] outputs, combined over the
    // cluster's blocks through distributed shared memory (all of a
    // thread's remote loads issued together).
    const int total = hg * D;
    const int per = (total + n_s - 1) / n_s;
    const int stop = min(total, (split + 1) * per);
    for (int i = split * per + tid; i < stop; i += BF16_WARPS * 32) {
        const int hh = i / D;
        float m[MAX_SPLITS], l[MAX_SPLITS], a[MAX_SPLITS];
        float m_star = NEG_INF;
#pragma unroll
        for (int sp = 0; sp < MAX_SPLITS; ++sp) {
            if (sp < n_s) {
                m[sp] = *cluster.map_shared_rank(bm_s + hh, sp);
                l[sp] = *cluster.map_shared_rank(bl_s + hh, sp);
                a[sp] = *cluster.map_shared_rank(bacc_s + i, sp);
                m_star = fmaxf(m_star, m[sp]);
            }
        }
        float num = 0.f, den = 0.f;
#pragma unroll
        for (int sp = 0; sp < MAX_SPLITS; ++sp) {
            if (sp < n_s) {
                const float wt = expf(m[sp] - m_star);
                num = fmaf(a[sp], wt, num);
                den = fmaf(l[sp], wt, den);
            }
        }
        const float o = num / fmaxf(den, 1e-30f);
        const long long at = b * o_sb + (h0 + hh) * o_sh + i % D;
        if constexpr (STATS) {
            static_cast<float*>(out)[at] = o;
            if (i % D == 0) {
                const long long row = static_cast<long long>(b)
                                      * (gridDim.y / n_groups) * n_rep
                                      + h0 + hh;
                m_out[row] = m_star;
                l_out[row] = den;
            }
        } else {
            static_cast<bf16*>(out)[at] = __float2bfloat16_rn(o);
        }
    }
    cluster.sync();   // no block leaves while another still reads it
}

template <int D, bool STATS>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const int* cache_len, void* out, float* m_out,
                        float* l_out, int B, int S, int H, int KV,
                        int split_len, int n_splits, float scale,
                        const long long* st, cudaStream_t stream) {
    constexpr int smem = bf16_smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        decode_bf16<D, STATS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const int n_rep = H / KV;
    const int n_groups = (n_rep + HG - 1) / HG;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(n_splits, KV * n_groups, B);
    cfg.blockDim = dim3(BF16_WARPS * 32);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = n_splits;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cudaLaunchKernelEx(
        &cfg, decode_bf16<D, STATS>, static_cast<const bf16*>(q),
        static_cast<const bf16*>(k), static_cast<const bf16*>(v), cache_len,
        out, m_out, l_out, S, n_rep, n_groups, split_len, scale, st[0],
        st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9]);
}

template <int D, bool STATS>
cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int* cache_len, float* m, float* l, float* acc,
                       void* out, float* m_out, float* l_out, int B, int S,
                       int H, int KV, float scale, const long long* st,
                       cudaStream_t stream) {
    constexpr int smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        decode_partial<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (err != cudaSuccess) return err;
    const int n_rep = H / KV;
    const int n_groups = (n_rep + HG - 1) / HG;
    const int n_s = (S + SPLIT - 1) / SPLIT;
    decode_partial<float, D><<<dim3(n_s, KV * n_groups, B), THREADS, smem,
                               stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), cache_len, m, l, acc, S, H, n_rep,
        n_groups, n_s, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6],
        st[7]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_combine<float, D, STATS><<<dim3(H, B), D, 0, stream>>>(
        m, l, acc, cache_len, static_cast<float*>(out), m_out, l_out, H, n_s,
        st[8], st[9]);
    return cudaGetLastError();
}

// The launches of both entry points; STATS as in decode_bf16.
template <bool STATS>
int dispatch(const void* q, const void* k, const void* v,
             const void* cache_len, void* m, void* l, void* acc, void* out,
             float* m_out, float* l_out, int B, int S, int H, int KV, int D,
             int dtype, float scale, const long long* st, int split_len,
             int n_splits, void* stream) {
    const int* len = static_cast<const int*>(cache_len);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 1) {
        if (n_splits < 1 || n_splits > MAX_SPLITS || split_len < 1
                || split_len % SPLIT_MULTIPLE
                || static_cast<long long>(n_splits - 1) * split_len >= S
                || static_cast<long long>(n_splits) * split_len < S)
            return static_cast<int>(cudaErrorInvalidValue);
        if (D == 64)
            return launch_bf16<64, STATS>(q, k, v, len, out, m_out, l_out, B,
                                          S, H, KV, split_len, n_splits,
                                          scale, st, s);
        if (D == 128)
            return launch_bf16<128, STATS>(q, k, v, len, out, m_out, l_out,
                                           B, S, H, KV, split_len, n_splits,
                                           scale, st, s);
    }
    float* mf = static_cast<float*>(m);
    float* lf = static_cast<float*>(l);
    float* af = static_cast<float*>(acc);
    if (dtype == 0 && D == 64)
        return launch_f32<64, STATS>(q, k, v, len, mf, lf, af, out, m_out,
                                     l_out, B, S, H, KV, scale, st, s);
    if (dtype == 0 && D == 128)
        return launch_f32<128, STATS>(q, k, v, len, mf, lf, af, out, m_out,
                                      l_out, B, S, H, KV, scale, st, s);
    return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// The float32 kernels' split (the bfloat16 kernel takes the caller's plan).
extern "C" int decode_attention_split() { return SPLIT; }

// dtype: 0 = float32, 1 = bfloat16; scale is the caller's 1/sqrt(D) rounded
// to float.  q and out are [B, H, D], the caches [B, S, KV, D]; strides are
// in elements (q: batch, head; k, v: batch, position, head; out: batch,
// head), D (64 or 128) is contiguous.  cache_len is a device int32 (a
// negative one selects no position).
// float32: m, l ([B, H, n_s]) and acc ([B, H, n_s, D]) are contiguous f32
// scratch with n_s = ceil(S / decode_attention_split()); split_len and
// n_splits are not read.  bfloat16: m, l and acc are not read; the cache is
// cut into n_splits (1 .. MAX_SPLITS) splits of split_len positions (a
// multiple of SPLIT_MULTIPLE, n_splits = ceil(S / split_len)), and every
// base address and stride is a multiple of 16 bytes.  Returns the CUDA
// error of the launches (0 on success); the wrapper checks everything else.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* m, void* l, void* acc, void* out, int B, int S, int H, int KV, int D,
    int dtype, float scale, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_sh, int split_len,
    int n_splits, void* stream) {
    const long long st[10] = {q_sb, q_sh, k_sb, k_ss, k_sh,
                              v_sb, v_ss, v_sh, o_sb, o_sh};
    return dispatch<false>(q, k, v, cache_len, m, l, acc, out, nullptr,
                           nullptr, B, S, H, KV, D, dtype, scale, st,
                           split_len, n_splits, stream);
}

// The statistics form: decode_attention_fwd's arguments, with out a float32
// [B, H, D] (the block's normalised output, not rounded) and m_out, l_out
// contiguous float32 [B, H]: the max logit over the valid positions (-1e30
// where there is none) and sum exp(logit - m) over them (0 where none).
extern "C" int decode_attention_stats_fwd(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* m, void* l, void* acc, void* out, void* m_out, void* l_out, int B,
    int S, int H, int KV, int D, int dtype, float scale, long long q_sb,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long o_sb,
    long long o_sh, int split_len, int n_splits, void* stream) {
    const long long st[10] = {q_sb, q_sh, k_sb, k_ss, k_sh,
                              v_sb, v_ss, v_sh, o_sb, o_sh};
    return dispatch<true>(q, k, v, cache_len, m, l, acc, out,
                          static_cast<float*>(m_out),
                          static_cast<float*>(l_out), B, S, H, KV, D, dtype,
                          scale, st, split_len, n_splits, stream);
}
