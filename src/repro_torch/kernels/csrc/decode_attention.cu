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
// index cache_len), with the reference's numerics: each split of the cache
// gives f32 partials m = max logit, l = sum exp(logit - m) and
// acc = sum round(p) * v (p rounded to the value dtype); the combine takes
// w = exp(m - max m), out = sum(acc * w) / max(sum(l * w), 1e-30).
//
// What bounds it on an H100: bytes.  At the serving path's decode (cache
// [8, 1064, 2, 128] bf16, about 1056 valid positions, 32 query heads) it
// reads about 8.7 MB of K and V and does about 138 MFLOP: about 2.6 us at
// 3.35 TB/s against 0.14 us at the bf16 tensor-core rate.
//
// Design.  Two kernels on the caller's stream.  `decode_partial`: one block
// of 256 threads per (64-position split, kv head, group of up to 16 query
// heads, batch), so each K/V element is read from device memory once for
// all the query heads that share it; K and V of the split go to shared
// memory as f32 (K rows padded by one float so that neighbouring threads,
// one position each, read distinct banks), the scores of all heads x 64
// positions are dot products over shared memory, the split softmax runs one
// warp per head, and the P.V product one thread per (head, dim).  Splits
// that start past cache_len return at once: their positions are all masked,
// so they add nothing, and `decode_combine` (one block per (head, batch),
// one thread per dim) renormalises only the splits up to cache_len.
// cache_len is read through a device pointer, so the decode loop never
// brings it to the host.  The cache is read in the model layout
// [B, S_max, KV, D] through its strides (D contiguous) without a copy, and
// S_max needs no particular multiple: the last split is masked.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int SPLIT = 64;    // cache positions per split (the reference: 512)
constexpr int HG = 16;       // query heads per block at most
constexpr int THREADS = 256;
constexpr float NEG_INF = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
    return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
    return __float2bfloat16_rn(x);
}

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

template <typename T, int D>
__global__ void decode_combine(const float* __restrict__ m,
                               const float* __restrict__ l,
                               const float* __restrict__ acc,
                               const int* __restrict__ cache_len,
                               T* __restrict__ out, int H, int n_s,
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
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* cache_len, float* m, float* l, float* acc,
                   void* out, int B, int S, int H, int KV, float scale,
                   const long long* st, cudaStream_t stream) {
    constexpr int smem = smem_bytes<D>();
    cudaError_t err = cudaFuncSetAttribute(
        decode_partial<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    const int n_rep = H / KV;
    const int n_groups = (n_rep + HG - 1) / HG;
    const int n_s = (S + SPLIT - 1) / SPLIT;
    decode_partial<T, D><<<dim3(n_s, KV * n_groups, B), THREADS, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), cache_len, m, l, acc, S, H, n_rep, n_groups,
        n_s, scale, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7]);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    decode_combine<T, D><<<dim3(H, B), D, 0, stream>>>(
        m, l, acc, cache_len, static_cast<T*>(out), H, n_s, st[8], st[9]);
    return cudaGetLastError();
}

}  // namespace

extern "C" int decode_attention_split() { return SPLIT; }

// dtype: 0 = float32, 1 = bfloat16; scale is the caller's 1/sqrt(D) rounded
// to float.  q and out are [B, H, D], the caches [B, S, KV, D]; strides are
// in elements (q: batch, head; k, v: batch, position, head; out: batch,
// head), D (64 or 128) is contiguous.  cache_len is a device int32.  m, l
// ([B, H, n_s]) and acc ([B, H, n_s, D]) are contiguous f32 scratch with
// n_s = ceil(S / decode_attention_split()).  Returns the CUDA error of the
// launches (0 on success); the wrapper checks everything else.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, const void* cache_len,
    void* m, void* l, void* acc, void* out, int B, int S, int H, int KV, int D,
    int dtype, float scale, long long q_sb, long long q_sh, long long k_sb,
    long long k_ss, long long k_sh, long long v_sb, long long v_ss,
    long long v_sh, long long o_sb, long long o_sh, void* stream) {
    const long long st[10] = {q_sb, q_sh, k_sb, k_ss, k_sh,
                              v_sb, v_ss, v_sh, o_sb, o_sh};
    const int* len = static_cast<const int*>(cache_len);
    float* mf = static_cast<float*>(m);
    float* lf = static_cast<float*>(l);
    float* af = static_cast<float*>(acc);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dtype == 0 && D == 64)
        return launch<float, 64>(q, k, v, len, mf, lf, af, out, B, S, H, KV, scale, st, s);
    if (dtype == 0 && D == 128)
        return launch<float, 128>(q, k, v, len, mf, lf, af, out, B, S, H, KV, scale, st, s);
    if (dtype == 1 && D == 64)
        return launch<__nv_bfloat16, 64>(q, k, v, len, mf, lf, af, out, B, S, H, KV, scale, st, s);
    if (dtype == 1 && D == 128)
        return launch<__nv_bfloat16, 128>(q, k, v, len, mf, lf, af, out, B, S, H, KV, scale, st, s);
    return static_cast<int>(cudaErrorInvalidValue);
}
