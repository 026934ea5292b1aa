// Causal / full GQA attention forward (flash attention) for Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_kernel` of the JAX package
// (src/repro/kernels/flash_attention.py, reached through `flash_attention`
// and the model-layout wrapper `ops.mha_flash`).
//
// What it computes, for every batch b, query head h and query row i:
//   out[b,i,h,:] = softmax_j(q[b,i,h,:] . k[b,j,h/n_rep,:] * D^-1/2) @ v[b,:,h/n_rep,:]
// over the keys j (j <= i when causal), with the reference kernel's numerics:
// f32 logits, masked logits -1e30, running max / denominator / accumulator
// in f32, p rounded to the value dtype before the P.V product, and
// out = acc / max(l, 1e-30) cast to q's dtype.
//
// What bounds it on an H100: operations.  At the serving path's prefill
// (B=8, S=1024, H=32, KV=2, D=128, bf16, causal) it does 68.7 GFLOP and
// moves 142.6 MB: 0.069 ms at the 989 TFLOP/s bf16 tensor-core peak against
// 0.043 ms at 3.35 TB/s.
//
// Design.  Two bodies, one per dtype, both simple rather than fast (no TMA,
// no wgmma, no pipelining of the tile loads), with the same structure: one
// block per (64-query tile, query head, batch); the Q tile and one 64-key
// K/V tile at a time sit in shared memory; a loop inside the block over the
// K/V tiles takes the place of the TPU's sequential grid axis, and on the
// causal path it stops at the diagonal tile instead of masking the tiles
// past it; each thread keeps the running max / denominator / output of its
// rows in registers.
//
// - bfloat16 (`flash_fwd_bf16`, the serving path): tensor cores through
//   `mma.sync.m16n8k16` (bf16 in, f32 accumulate).  4 warps, 16 query rows
//   each; Q's fragments stay in registers for the whole K/V loop; the score
//   fragment of S = Q K^T is turned into the A fragment of P.V in registers
//   (p rounded to bf16 on the way, as the reference rounds it); tiles are
//   loaded with 16-byte loads into rows padded by 8 elements so that the
//   fragment loads of neighbouring rows fall in distinct banks.  Row
//   reductions run over the 4 threads of a quad with shuffles.
// - float32 (`flash_fwd_f32`): scalar FMAs (the tensor cores' TF32 would
//   not keep float32's digits).  256 threads, each owning a 4 x 4 piece of
//   the 64 x 64 score tile (rows ty + 16i, keys tx + 16j) and the same four
//   rows of the output; shared rows padded by 4 floats so that the 16-byte
//   shared loads of neighbouring rows fall in distinct banks; row reductions
//   over the 16 threads of a half-warp.
//
// Query head h reads kv head h / n_rep by index (no repeated K/V), and the
// kernels read [B, S, heads, D] tensors through their strides (the last
// axis must be contiguous; the bf16 body also needs 16-byte aligned rows),
// so the reference's [BH, S, D] layout is the special case B = 1.  Ragged
// tails (S not a multiple of 64) are masked: rows past Sq are computed on
// zeros and not stored, keys past Sk are zero and get logit -1e30.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // queries per block
constexpr int BK = 64;       // keys per K/V tile
static_assert(BQ == BK, "load_tile moves 64-row tiles of Q, K and V alike");
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------- float32

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

constexpr int MMA_THREADS = 128;  // 4 warps x 16 query rows

template <int D>
constexpr int smem_bytes_bf16() {
    return 3 * BQ * (D + 8) * 2;
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

__device__ __forceinline__ uint32_t pack_bf16(bf16 lo, bf16 hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(lo))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

// rows x D tile from a [S, D]-strided source into shared rows of LDS
// elements, 16 bytes at a time; rows at or past `limit` are zero.
template <int D, int LDS>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long stride, int first,
                                          int limit, int tid) {
    constexpr int CH = D / 8;
    for (int i = tid; i < BQ * CH; i += MMA_THREADS) {
        const int r = i / CH, c = (i % CH) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (first + r < limit)
            val = *reinterpret_cast<const uint4*>(src + (first + r) * stride + c);
        *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
    }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_fwd_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, bf16* __restrict__ out,
               int Sq, int Sk, int n_rep, int causal, float scale,
               long long q_sb, long long q_ss, long long q_sh,
               long long k_sb, long long k_ss, long long k_sh,
               long long v_sb, long long v_ss, long long v_sh,
               long long o_sb, long long o_ss, long long o_sh) {
    constexpr int LDS = D + 8;    // padded shared row, in elements
    constexpr int KD = D / 16;    // k-steps of Q K^T
    constexpr int NS = BK / 8;    // n-tiles of the score tile
    constexpr int ND = D / 8;     // n-tiles of the output
    extern __shared__ __align__(16) unsigned char smem_raw[];
    bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
    bf16* Ks = Qs + BQ * LDS;
    bf16* Vs = Ks + BK * LDS;

    const int tid = threadIdx.x;
    const int lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;  // fragment row group, column pair
    const int q0 = blockIdx.x * BQ;
    const int h = blockIdx.y;
    const int b = blockIdx.z;
    const int kvh = h / n_rep;
    const bf16* kb = k + b * k_sb + kvh * k_sh;
    const bf16* vb = v + b * v_sb + kvh * v_sh;

    load_tile<D, LDS>(Qs, q + b * q_sb + h * q_sh, q_ss, q0, Sq, tid);
    __syncthreads();
    const int r0 = warp * 16;
    uint32_t qf[KD][4];
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
        const bf16* base = Qs + (r0 + g) * LDS + kk * 16 + 2 * t;
        qf[kk][0] = ld32(base);
        qf[kk][1] = ld32(base + 8 * LDS);
        qf[kk][2] = ld32(base + 8);
        qf[kk][3] = ld32(base + 8 * LDS + 8);
    }
    const int qrow[2] = {q0 + r0 + g, q0 + r0 + g + 8};

    float o[ND][4];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[nd][e] = 0.f;
    float m_run[2] = {NEG_INF, NEG_INF};
    float l_run[2] = {0.f, 0.f};  // this thread's columns; quad-summed at the end

    int n_tiles = (Sk + BK - 1) / BK;
    if (causal) {
        const int last_q = min(q0 + BQ, Sq) - 1;
        n_tiles = min(n_tiles, last_q / BK + 1);
    }

    for (int tile = 0; tile < n_tiles; ++tile) {
        const int k0 = tile * BK;
        __syncthreads();  // the previous tile's readers of Ks / Vs are done
        load_tile<D, LDS>(Ks, kb, k_ss, k0, Sk, tid);
        load_tile<D, LDS>(Vs, vb, v_ss, k0, Sk, tid);
        __syncthreads();

        float s[NS][4];
#pragma unroll
        for (int j = 0; j < NS; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < KD; ++kk) {
                const bf16* kp = Ks + (8 * j + g) * LDS + kk * 16 + 2 * t;
                mma_bf16(s[j], qf[kk], ld32(kp), ld32(kp + 8));
            }
        }

        // c0, c1 of a fragment are row g, columns 2t and 2t + 1; c2, c3 row g + 8.
        float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const int key = k0 + 8 * j + 2 * t + (e & 1);
                float x = s[j][e] * scale;
                if (key >= Sk || (causal && key > qrow[e >> 1])) x = NEG_INF;
                s[j][e] = x;
                mx[e >> 1] = fmaxf(mx[e >> 1], x);
            }
        float corr[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
            mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
            const float m_new = fmaxf(m_run[r], mx[r]);
            corr[r] = expf(m_run[r] - m_new);
            m_run[r] = m_new;
            l_run[r] *= corr[r];
        }
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const float p = expf(s[j][e] - m_run[e >> 1]);
                s[j][e] = p;
                l_run[e >> 1] += p;
            }
#pragma unroll
        for (int nd = 0; nd < ND; ++nd) {
            o[nd][0] *= corr[0];
            o[nd][1] *= corr[0];
            o[nd][2] *= corr[1];
            o[nd][3] *= corr[1];
        }

        // O += P V: the score fragments of keys 16kt .. 16kt + 15 are the A
        // fragment (p rounded to bf16 here, as the reference rounds it).
#pragma unroll
        for (int kt = 0; kt < BK / 16; ++kt) {
            const uint32_t a[4] = {
                pack_bf16(s[2 * kt][0], s[2 * kt][1]),
                pack_bf16(s[2 * kt][2], s[2 * kt][3]),
                pack_bf16(s[2 * kt + 1][0], s[2 * kt + 1][1]),
                pack_bf16(s[2 * kt + 1][2], s[2 * kt + 1][3]),
            };
#pragma unroll
            for (int nd = 0; nd < ND; ++nd) {
                const bf16* vp = Vs + (kt * 16 + 2 * t) * LDS + 8 * nd + g;
                mma_bf16(o[nd], a, pack_bf16(vp[0], vp[LDS]),
                         pack_bf16(vp[8 * LDS], vp[9 * LDS]));
            }
        }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 1);
        l_run[r] += __shfl_xor_sync(0xffffffffu, l_run[r], 2);
        if (qrow[r] >= Sq) continue;
        const float den = fmaxf(l_run[r], 1e-30f);
        bf16* ob = out + b * o_sb + qrow[r] * o_ss + h * o_sh + 2 * t;
#pragma unroll
        for (int nd = 0; nd < ND; ++nd)
            *reinterpret_cast<__nv_bfloat162*>(ob + 8 * nd) = __floats2bfloat162_rn(
                o[nd][2 * r] / den, o[nd][2 * r + 1] / den);
    }
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* out,
                       int B, int Sq, int Sk, int H, int KV, int causal,
                       float scale, const long long* st, cudaStream_t stream) {
    constexpr int smem = smem_bytes_f32<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_f32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_f32<D><<<dim3((Sq + BQ - 1) / BQ, H, B), THREADS, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), Sq, Sk,
        H / KV, causal, scale, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11]);
    return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        void* out, int B, int Sq, int Sk, int H, int KV,
                        int causal, float scale, const long long* st,
                        cudaStream_t stream) {
    constexpr int smem = smem_bytes_bf16<D>();
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_bf16<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    flash_fwd_bf16<D><<<dim3((Sq + BQ - 1) / BQ, H, B), MMA_THREADS, smem,
                        stream>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), Sq, Sk,
        H / KV, causal, scale, st[0], st[1], st[2], st[3], st[4], st[5],
        st[6], st[7], st[8], st[9], st[10], st[11]);
    return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16; scale is the caller's 1/sqrt(D) rounded
// to float, as the reference multiplies its f32 logits by it.  Strides are
// in elements, for the batch, sequence and head axes of q, k, v and out in
// that order; the head dimension D (64 or 128) is contiguous, and for
// bfloat16 every row starts on 16 bytes.  Returns the CUDA error of the
// launch (0 on success); the wrapper checks everything else.
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
