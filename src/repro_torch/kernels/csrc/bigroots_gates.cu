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
// Bound: memory bandwidth, once the divisions are out of the way.  There is
// no reuse, so the design moves as few bytes as the function needs, as wide
// as the card loads them, with no integer division per element, and divides
// only where a quotient decides the output:
//
// - Window-tiled grid.  A block takes one window w and a tile of its rows
//   (w, the tile and the column chunk come from the block index, once).  A
//   thread owns one column unit of the rows it visits: a column pair
//   (2u, 2u+1) on the vector path, one column on the scalar path.  It loads
//   its window's vsum, q, numok and floor for that unit into registers once,
//   then takes ROWS_PER_THREAD rows a rows_per_pass apart.  Consecutive
//   threads hold consecutive units of consecutive rows, so one pass over a
//   block's rows is one contiguous span of each array.
// - pv and the counts only where they decide.  A thread first loads the
//   rowmask and v of all its rows, together.  An element's output depends
//   on pv and the counts only where mask > 0, v > q, numok > 0 and v > floor
//   (`decides`; else `fired` is false and the output 0), so they are loaded
//   only for a unit where one of its elements decides.  On a fleet sweep the
//   λq gate fails for most elements: most pv sectors are never read, and a
//   padded row (mask not > 0, NaN included) reads none.
// - Divisions only where they decide (gate_bits).  A float64 __ddiv_rn is a
//   software sequence (reciprocal estimate, Newton steps, and a slow path for
//   a zero, subnormal or non-finite operand); computed for every element it
//   took longer than the loads.  It runs only for an element that decides
//   and whose count is > 0 (else its gate is false).
// - Two paths, chosen here from the shapes and pointers: the vector path
//   (F even, v and pv 16-byte aligned, out 2-byte aligned) reads v and pv
//   as double2 and stores the two gate bytes as one char2; the scalar path
//   (odd F, or an unaligned view) has the same tiling with 8-byte loads and
//   1-byte stores.  `gate_plan` in kernels/bigroots_gates.py mirrors this
//   choice and the tiling for the tests, and a CPU test reads the constants
//   below from this file.
// - Loads in flight: a thread's rows load together, up to ROWS_PER_THREAD
//   16-byte loads of v and then of pv, in eight blocks of at most 128
//   threads an SM (a 64-register cap).  More rows a thread, more or larger
//   blocks an SM, and a persistent grid that loaded a block's next rows
//   while it finished the current ones each timed slower.
//
// Indices are 32-bit: a batch of 2^31 elements or more is refused (the
// wrapper raises before it gets here).
//
// Exactness: the contract is bit-identity with the float64 numpy reference,
// so every rounding is named — __dsub_rn / __ddiv_rn / __dmul_rn are IEEE
// round-to-nearest and are never contracted into an FMA — and the operand
// order is the reference's.  A comparison with NaN is false, as in numpy;
// a count that is not > 0 (zero, -0.0, NaN) masks its gate, so its quotient
// is never needed and not computed.  No reciprocal of a count is taken: it
// would round differently.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// A block's threads at most: rows_per_pass * units.
constexpr int BLOCK_THREADS = 128;
// Column units a block spans at most; wider rows are cut into chunks.
constexpr int MAX_UNITS = 128;
// Rows a thread takes in a block, their loads in flight together.
constexpr int ROWS_PER_THREAD = 2;
// Blocks an SM holds at least: caps a thread at 64 registers.
constexpr int MIN_BLOCKS = 8;

// Whether an element's output depends on pv and the counts: where this is
// false, `fired` is false and the output 0 whatever they hold.
__device__ __forceinline__ bool decides(double m, double x, double qq,
                                        double nok, double fl) {
  return (m > 0.0) && (x > qq) && (nok > 0.0) && (x > fl);
}

// The gate bits of an element that decides.  A division runs only where its
// count is > 0 (else its gate is false); a warp whose lanes all have
// non-positive counts skips it.
__device__ __forceinline__ signed char gate_bits(double x, double p,
                                                 double ic, double ac,
                                                 double vs, double peer_mean) {
  const bool gi =
      (ic > 0.0) &&
      (x > __dmul_rn(__ddiv_rn(__dsub_rn(vs, p), ic), peer_mean));
  const bool ga =
      (ac > 0.0) &&
      (x > __dmul_rn(__ddiv_rn(__dsub_rn(p, x), ac), peer_mean));
  return (signed char)((gi ? 1 : 0) + (ga ? 2 : 0));  // 0 unless gi || ga
}

// One column unit: N = 2 adjacent columns on the vector path, 1 on the
// scalar path.
template <bool VEC> struct Unit;
template <> struct Unit<true> {
  static constexpr int N = 2;
  using Val = double2;
  static __device__ __forceinline__ Val load(const double* a, unsigned i) {
    return __ldcs(reinterpret_cast<const double2*>(a) + i);
  }
  static __device__ __forceinline__ Val col(const double* a, unsigned f) {
    return make_double2(a[f], a[f + 1]);
  }
  static __device__ __forceinline__ double at(Val a, int j) {
    return j ? a.y : a.x;
  }
  static __device__ __forceinline__ void store(signed char* out, unsigned i,
                                               const signed char* b) {
    reinterpret_cast<char2*>(out)[i] = make_char2(b[0], b[1]);
  }
};
template <> struct Unit<false> {
  static constexpr int N = 1;
  using Val = double;
  static __device__ __forceinline__ Val load(const double* a, unsigned i) {
    return __ldcs(a + i);
  }
  static __device__ __forceinline__ Val col(const double* a, unsigned f) {
    return a[f];
  }
  static __device__ __forceinline__ double at(Val a, int) { return a; }
  static __device__ __forceinline__ void store(signed char* out, unsigned i,
                                               const signed char* b) {
    out[i] = b[0];
  }
};

// Grid: W * tiles * chunks blocks of rows_per_pass * units threads.  Block b
// takes column chunk b % chunks, row tile (b / chunks) % tiles of window
// b / (chunks * tiles).  `per_row` is the units of a row (F / 2 or F).
template <bool VEC>
__global__ void __launch_bounds__(BLOCK_THREADS, MIN_BLOCKS) gates_kernel(
    const double* __restrict__ v, const double* __restrict__ pv,
    const double* __restrict__ icnt, const double* __restrict__ acnt,
    const double* __restrict__ mask, const double* __restrict__ vsum,
    const double* __restrict__ q, const double* __restrict__ numok,
    const double* __restrict__ floor_, signed char* __restrict__ out,
    int R, int F, int per_row, int units, int chunks, int tiles,
    int rows_per_pass, double peer_mean) {
  using U = Unit<VEC>;
  constexpr int K = ROWS_PER_THREAD, N = U::N;
  const int chunk = blockIdx.x % chunks;
  const int wt = blockIdx.x / chunks;  // w * tiles + tile
  const int w = wt / tiles;
  const int tile = wt - w * tiles;
  const int lane_row = threadIdx.x / units;
  const int u = chunk * units + (threadIdx.x - lane_row * units);
  if (u >= per_row) return;
  const unsigned f = VEC ? 2u * u : (unsigned)u;
  const unsigned wf = (unsigned)w * F + f;
  const typename U::Val vs = U::col(vsum, wf), qq = U::col(q, wf),
                        nok = U::col(numok, wf), fl = U::col(floor_, f);

  const int r0 = tile * rows_per_pass * K + lane_row;
  const unsigned row0 = (unsigned)w * R + r0;  // w * R + r of the first row
  double m[K];
  typename U::Val x[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    m[k] = 0.0;  // a row past R decides nothing
    x[k] = typename U::Val{};
    if (r0 + k * rows_per_pass < R) {
      const unsigned row = row0 + k * rows_per_pass;
      m[k] = mask[row];
      x[k] = U::load(v, row * per_row + u);
    }
  }

  bool d[K][N];
  typename U::Val p[K];
  double ic[K], ac[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    bool any = false;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      d[k][j] = decides(m[k], U::at(x[k], j), U::at(qq, j), U::at(nok, j),
                        U::at(fl, j));
      any = any || d[k][j];
    }
    p[k] = typename U::Val{};
    ic[k] = ac[k] = 0.0;
    if (any) {
      const unsigned row = row0 + k * rows_per_pass;
      p[k] = U::load(pv, row * per_row + u);
      ic[k] = icnt[row];
      ac[k] = acnt[row];
    }
  }

#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (r0 + k * rows_per_pass < R) {
      signed char b[N];
#pragma unroll
      for (int j = 0; j < N; ++j)
        b[j] = d[k][j] ? gate_bits(U::at(x[k], j), U::at(p[k], j), ic[k],
                                   ac[k], U::at(vs, j), peer_mean)
                       : 0;
      U::store(out, (row0 + k * rows_per_pass) * per_row + u, b);
    }
  }
}

}  // namespace

// Launches on `stream`, does not synchronise, allocates nothing.  Chooses
// the path (vector where F is even, v and pv are 16-byte aligned and out is
// 2-byte aligned; scalar else) and the tiling from its constants.  Returns
// the cudaError_t of the launch (0 = success) so the caller can raise;
// cudaErrorInvalidValue for a batch of 2^31 elements or more.
extern "C" int bigroots_gates_f64(
    const double* v, const double* pv, const double* icnt, const double* acnt,
    const double* mask, const double* vsum, const double* q,
    const double* numok, const double* floor_, signed char* out, int W, int R,
    int F, double peer_mean, void* stream) {
  const long long total = (long long)W * (long long)R * (long long)F;
  if (total <= 0) return (int)cudaSuccess;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const bool vector = !(F & 1) &&
                      !((((uintptr_t)v | (uintptr_t)pv) & 15) ||
                        ((uintptr_t)out & 1));
  const int per_row = vector ? F / 2 : F;
  const int units = per_row < MAX_UNITS ? per_row : MAX_UNITS;
  const int chunks = (per_row + units - 1) / units;
  const int rows_per_pass = BLOCK_THREADS / units;
  const int tile_rows = rows_per_pass * ROWS_PER_THREAD;
  const int tiles = (R + tile_rows - 1) / tile_rows;
  const int grid = W * tiles * chunks;  // at most one block per element
  const int threads = rows_per_pass * units;
  if (vector)
    gates_kernel<true><<<grid, threads, 0, (cudaStream_t)stream>>>(
        v, pv, icnt, acnt, mask, vsum, q, numok, floor_, out, R, F, per_row,
        units, chunks, tiles, rows_per_pass, peer_mean);
  else
    gates_kernel<false><<<grid, threads, 0, (cudaStream_t)stream>>>(
        v, pv, icnt, acnt, mask, vsum, q, numok, floor_, out, R, F, per_row,
        units, chunks, tiles, rows_per_pass, peer_mean);
  return (int)cudaGetLastError();
}
