// Batched BigRoots Eq. 5 gate pipeline for fleet sweeps, for Hopper (sm_90a).
//
// Replaces the TPU kernel `_gates_kernel` (src/repro/kernels/bigroots_gates.py,
// launched through `_gates_pallas` / `eval_gates`).  Same function: for every
// element of the packed [W, R, F] batch
//
//   inter = (vsum[w,f] - pv[w,r,f]) / icnt[w,r]
//   intra = (pv[w,r,f] - v[w,r,f])  / acnt[w,r]
//   gi    = v > inter * peer_mean  &&  icnt > 0
//   ga    = v > intra * peer_mean  &&  acnt > 0
//   fired = mask[w,r] > 0 && v > q[w,f] && (gi || ga)
//           && numok[w,f] > 0 && v > floor[f]
//   out   = fired ? gi + 2*ga : 0                      (int8)
//
// Bound: memory bandwidth.  Per output element the kernel reads 16 bytes
// (v and pv) and writes 1; the three [W,R,1] row scalars and the four
// [·,1,F] column vectors are tiny next to that and are served from L1/L2.
// There is no reuse to exploit, so the design is one fused pass with nothing
// kept in device memory between the nine inputs and the one output: a flat
// grid-stride loop with neighbouring threads on neighbouring addresses,
// offsets computed in the kernel (F = 14 is not a power of two and is not
// padded), and the ragged tail masked by the loop bound.  Nothing of the TPU
// kernel's (1, block_r, F) blocking is carried over.
//
// One element per thread and iteration, 8-byte loads, a 1-byte store.
// Indices are 32-bit: a batch of 2^31 elements or more is refused (the
// wrapper raises before it gets here).
//
// Exactness: the contract is bit-identity with the float64 numpy reference,
// so every rounding is named — __dsub_rn / __ddiv_rn / __dmul_rn are IEEE
// round-to-nearest and are never contracted into an FMA — and the operand
// order is the reference's.  A comparison with NaN is false, as in numpy;
// division by a zero count gives inf/NaN that the `cnt > 0` terms mask.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ signed char gate_bits(
    double x, double p, double ic, double ac, double m, double vs, double qq,
    double nok, double fl, double peer_mean) {
  const double inter = __ddiv_rn(__dsub_rn(vs, p), ic);
  const double intra = __ddiv_rn(__dsub_rn(p, x), ac);
  const bool gi = (x > __dmul_rn(inter, peer_mean)) && (ic > 0.0);
  const bool ga = (x > __dmul_rn(intra, peer_mean)) && (ac > 0.0);
  const bool fired = (m > 0.0) && (x > qq) && (gi || ga) && (nok > 0.0) &&
                     (x > fl);
  return fired ? (signed char)((gi ? 1 : 0) + (ga ? 2 : 0)) : (signed char)0;
}

__global__ void gates_kernel(
    const double* __restrict__ v, const double* __restrict__ pv,
    const double* __restrict__ icnt, const double* __restrict__ acnt,
    const double* __restrict__ mask, const double* __restrict__ vsum,
    const double* __restrict__ q, const double* __restrict__ numok,
    const double* __restrict__ floor_, signed char* __restrict__ out,
    unsigned total, unsigned R, unsigned F, double peer_mean) {
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const unsigned row = i / F;             // w * R + r
    const unsigned f = i - row * F;
    const unsigned wf = (row / R) * F + f;  // w * F + f
    out[i] = gate_bits(v[i], pv[i], icnt[row], acnt[row], mask[row], vsum[wf],
                       q[wf], numok[wf], floor_[f], peer_mean);
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Returns the
// cudaError_t of the launch (0 = success) so the caller can raise.
extern "C" int bigroots_gates_f64(
    const double* v, const double* pv, const double* icnt, const double* acnt,
    const double* mask, const double* vsum, const double* q,
    const double* numok, const double* floor_, signed char* out, int W, int R,
    int F, double peer_mean, void* stream) {
  const long long total = (long long)W * (long long)R * (long long)F;
  if (total <= 0) return (int)cudaSuccess;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const long long cap = (long long)sms * 16;  // grid-stride past this
  const int blocks = (int)(want < cap ? want : cap);
  gates_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      v, pv, icnt, acnt, mask, vsum, q, numok, floor_, out, (unsigned)total,
      (unsigned)R, (unsigned)F, peer_mean);
  return (int)cudaGetLastError();
}
