// Warp-level tensor-core building blocks shared by the mma.sync kernels
// (decode_attention.cu, ssd_scan.cu), as inline PTX:
//
// - cp.async 16-byte copies into shared memory, with a zero-filling form
//   for rows past a tensor's end, and their commit / wait;
// - an XOR swizzle of 16-byte chunks, so that the eight rows an ldmatrix
//   reads at one column land in eight distinct bank groups without
//   padding the rows;
// - ldmatrix x4 (plain and transposed) and mma.sync m16n8k16 with bf16
//   operands and f32 accumulators;
// - packing two floats into a bf16 pair, and the hi/lo split of two
//   floats into two bf16 pairs.
//
// Fragment conventions are PTX's for m16n8k16 (g = lane / 4, t = lane % 4):
// A (16 x 16, row-major) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..), a2 = (g,
// 2t+8..), a3 = (g+8, 2t+8..); B (16 x 8, column-major) b0 = (2t..2t+1, g),
// b1 = (2t+8.., g); C (16 x 8) c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, 2t..).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace warp_mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously.  With
// `valid == false` nothing is read and the 16 bytes are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid = true) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
                 : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Element offset of 16-byte chunk `c` of row `r` in a tile whose rows hold
// `nch` chunks (a power of two).  The chunk index is XORed with bits of
// the row so that the eight rows of one ldmatrix (same logical chunk,
// consecutive rows) fall in eight distinct 16-byte bank groups: with rows
// of 128 bytes or more the row's low three bits, with shorter rows (two or
// four chunks, several rows in one 128-byte line) the row bits above those
// that select the line's slot.
__device__ __forceinline__ int swz(int r, int c, int nch) {
    const int per_line = nch >= 8 ? 1 : 8 / nch;   // rows in 128 bytes
    const int m = nch >= 8 ? 7 : nch - 1;
    return (r * nch + (c ^ ((r / per_line) & m))) * 8;
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const bf16* p) {
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p)));
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

// v ~= hi + lo, both bf16 pairs (v0 in the low half of each): the pair
// keeps ~16 bits of each float.
__device__ __forceinline__ void split_bf16(float v0, float v1, uint32_t& hi,
                                           uint32_t& lo) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    lo = pack_bf16(v0 - __low2float(h), v1 - __high2float(h));
}

__device__ __forceinline__ uint32_t ld_global32(const bf16* p) {
    return *reinterpret_cast<const uint32_t*>(p);
}

}  // namespace warp_mma
