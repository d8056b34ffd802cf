// Fused GDML inference contraction for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel sgdml_tpu/ops/pallas_predict.py:_kernel. For B
// query descriptors Xq (B, D) against T permuted training rows Xt, JA (T, D)
// it computes, per query b and table row t,
//
//   gram = xq.xt            u2 = max(|xq|^2 - 2 gram + |xt|^2, 0)
//   u5   = sqrt5 sqrt(u2)   e  = exp(-u5/sig)      b1 = 5/(3 sig^3) e
//   w2   = b1 (u5 + sig)    a  = xq.ja - <xt, ja>  w1 = a b1 5/sig
//   E_raw[b] = sum_t a w2  (+ sum_t k(u5) aE[t]    with the energy constraint)
//   F_d[b]   = sum_t (w1 + w3) xq - (w1 + w3) xt - w2 ja,   w3 = w2 aE[t]
//
// the body of sgdml_tpu/predict.py:_predict_from_tables_body between the
// centering and the Jacobian-transpose map. The caller centers Xq and Xt on
// the table mean and passes the table-side |xt|^2 and <xt, ja>, computed once
// per table build.
//
// What bounds it on this card: four B x T x D products, 8 B T D flop, against
// the (B, T) coefficient planes, which are 1/D of that work. Three routes,
// chosen by B and D in ops/fused_predict.py:route (measurements in PERF.md):
//
//  * Two passes, for every batch above split T's: bulk prediction, the
//    serving buckets, CG's matvecs (B = T). A block's (rows, D) force
//    accumulator does not fit on chip at wide descriptors (64 x 1770 f64 is
//    906 KB), while writing the planes to device memory costs ~1/D of the
//    products. So the contraction is two tiled matrix products with the
//    planes in between, the shape of attention with a head too wide to keep:
//      pass A (planes): grid (B tiles x T tiles); gram and xq.ja of a 64 x 64
//        tile through a cp.async ring over D, |xq|^2 on the way, then the
//        planes cx = w1 + w3 and cj = w2 to a (B, 2 Tp) scratch and the
//        tile's row sums of the energy term and of cx to (B, T tiles).
//      pass B (forces): F_d = (sum_t cx) xq - [cx | cj] [Xt ; JA], one product
//        with M = B, N = D, K = 2 Tp, on (B tiles x D tiles x K splits). The
//        K splits fill the card at small B; a reduction kernel adds them, and
//        the row sums, in a fixed order. No atomics: the same bits every run.
//    f64 runs on the FP64 tensor cores (warp-level mma.sync m16n8k4); f32 on
//    register-tiled FP32 FMAs (8 x 4 and 8 x 8 outputs a thread, so that each
//    shared-memory load feeds 8 FMAs), true f32, no TF32.
//    Copies are element-sized cp.async with zero fill, so rows of any width
//    (an f32 row of D = 1770 is not a multiple of 16 bytes) and ragged B, T
//    and D edges need no padding in device memory.
//
//  * Split T, for at most 16 queries: one geometry a call in MD and the ASE
//    calculator, or a few in a small predict bucket.
//
//  * Wide, for up to 4 queries, each too wide for split T (129 atoms and
//    more): split T's table runs, each row's columns also split across a
//    thread-block cluster (see its section below).
//
// Two passes spread the query axis over the card, so at B = 1 they run 16
// blocks of zero-filled 64-row tiles, then 64 and then one, in three launches.
// At B = 1 the work is 8 T D flop against 2 T D table elements: the bound is
// the table bytes (3.4 MB at the aspirin width, which stay in the 50 MB L2
// across MD steps) and, below a few microseconds, launch and tail latency. So
// split T spreads the table axis instead: block j of about one per SM owns a
// run of consecutive table rows, stages the B <= 16 queries in shared memory
// once, and a warp takes one row at a time: 16-byte loads of xt[t] and ja[t]
// (element loads on ragged edges), gram and xq.ja for every query by a warp
// reduction, the planes by plane_terms. A row's planes exist only once its
// whole dot is summed, so the block then reads the chunk's rows a second time,
// a thread a column, and adds cx xt + cj ja into its partial forces. That
// second read finds the rows on chip or in L2: at D = 210 an f64 chunk of 8
// row pairs is 27 KB and stays in the SM's L1; at D = 1770 it is 226 KB, over
// the L1, and comes from L2. HBM sees each row once a call. The block partials
// go to a scratch buffer and a second small kernel adds them in block order.
// No atomics, so the same bits every run; FP64 or FP32 FMAs.
//
// The MD step, split T's instance fused_predict_kernel<scalar_t, 1, NveStep>
// (ops/fused_predict.md_step), replaces the JAX package's compiled scan body
// of velocity Verlet (sgdml_tpu/md.py:_run_nve, whose force evaluation is the
// TPU kernel sgdml_tpu/ops/pallas_predict.py:_kernel): where PyTorch replays
// some 25 kernels a step around K1 (the drift, the descriptor and its
// Jacobian, centring, the Jacobian-transpose map, the kicks), each a graph
// node of 1-2 us on 63 numbers, the step is one launch. Its bound is split
// T's: the table bytes from L2 (3.4 MB at the aspirin width, 1 us), plus
// launch and tail latency. Everything but the table rows fits one block (21
// atoms, 210 pairs, 63 state values), so every block derives its own query
// from the state and one block, the last to finish, ends the step (NveStep).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

template <typename scalar_t>
struct Coeffs {
  scalar_t sig, b1, w1;  // sig, 5 / (3 sig^3), 5 / sig
};

template <typename scalar_t>
__device__ __forceinline__ Coeffs<scalar_t> coeffs(scalar_t sig) {
  return {sig, scalar_t(5) / (scalar_t(3) * sig * sig * sig), scalar_t(5) / sig};
}

// The planes of one (query, table row) pair from gram = xq.xt and q = xq.ja:
// the energy term ep, cx = w1 + w3 (the weight of -xt, and summed of +xq) and
// cj = w2 (the weight of -ja). A table row past T (t_ok false) gets zero
// weight everywhere: e is not zero there (the `valid` plane of the TPU kernel).
template <typename scalar_t>
__device__ __forceinline__ void plane_terms(scalar_t g, scalar_t q, scalar_t xq_sq, scalar_t xts,
                                            scalar_t tj, bool has_ae, scalar_t aet, bool t_ok,
                                            const Coeffs<scalar_t>& c, scalar_t& ep, scalar_t& cx,
                                            scalar_t& cj) {
  const scalar_t sqrt5 = scalar_t(2.23606797749978969640917366873127623544);
  scalar_t u2 = xq_sq - scalar_t(2) * g + xts;
  u2 = u2 > scalar_t(0) ? u2 : scalar_t(0);
  const scalar_t u5 = sqrt5 * dsqrt(u2);
  const scalar_t ex = t_ok ? dexp(-u5 / c.sig) : scalar_t(0);
  const scalar_t b1 = c.b1 * ex;
  const scalar_t w2 = b1 * (u5 + c.sig);
  const scalar_t a = q - tj;
  ep = a * w2;
  cx = a * b1 * c.w1;
  if (has_ae) {
    const scalar_t k_ee = (scalar_t(1) + (u5 / c.sig) * (scalar_t(1) + u5 / (scalar_t(3) * c.sig))) * ex;
    ep += k_ee * aet;
    cx += w2 * aet;
  }
  cj = w2;
}

template <typename scalar_t>
__device__ __forceinline__ scalar_t warp_sum(scalar_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// ===========================================================================
// Two passes (batches above split T's).
// ===========================================================================

constexpr int TILE = 64;    // rows and columns of a block tile (ops/fused_predict.py:TILE)
constexpr int BK = 16;      // K depth of one pipeline stage (ops/fused_predict.py:K_STEP)
constexpr int STAGES = 3;   // cp.async ring depth

// Each block computes a TILE x TILE tile of NP products: pass A's gram and
// xq.ja (NP = 2), pass B's forces (NP = 1). THREADS per block, ACC outputs of
// each product per thread.
//  f64: 8 warps as 2 x 4, each a 32 x 16 tile of mma.sync m16n8k4 fragments.
//       [row][k] tiles have a row stride LDK = 4 mod 16 8-byte words, so the
//       fragment reads of a half-warp hit 16 different banks.
//  f32: RS x CS threads; thread (ty, tx) owns the TM x TN outputs at rows
//       ty + RS i and columns tx + CS j, acc[i * TN + j]. Every value it reads
//       from shared memory feeds 8 FMAs (pass A: 8 x 4 outputs of two
//       products; pass B: 8 x 8). LDK is odd, so rows RS apart fall in
//       different banks.
template <typename scalar_t, int NP>
struct Cfg;
// MIN_BLOCKS blocks of THREADS fit an SM (at 128 registers a thread for 256
// and 128 threads; f32 pass B, 64 threads, may use 255 and spills at 128).
template <int NP>
struct Cfg<double, NP> {
  static constexpr int THREADS = 256, MIN_BLOCKS = 2, ACC = 16, LDK = BK + 4;
};
template <int NP>
struct Cfg<float, NP> {
  static constexpr int TM = 8, TN = NP == 2 ? 4 : 8, RS = TILE / TM, CS = TILE / TN;
  static constexpr int THREADS = RS * CS, MIN_BLOCKS = 4, ACC = TM * TN, LDK = BK + 1;
};

// Shared memory of each pass: a STAGES-deep ring of [row][k] tiles (Xq, Xt
// and JA in pass A; the planes in pass B) and [k][col] tiles (Xt or JA rows in
// pass B, row stride LDN). Pass A's epilogue reuses the ring to stage its ep
// and cx tiles, row stride LDE, for the row sums.
template <typename scalar_t>
struct Smem {
  static constexpr int LDN = TILE + 4, LDE = TILE + 1;
  static constexpr int planes_stage = 3 * TILE * Cfg<scalar_t, 2>::LDK;
  static constexpr int planes_elems = STAGES * planes_stage > 2 * TILE * LDE
                                          ? STAGES * planes_stage : 2 * TILE * LDE;
  static constexpr int forces_stage = TILE * Cfg<scalar_t, 1>::LDK + BK * LDN;
  static constexpr size_t planes = sizeof(scalar_t) * planes_elems;
  static constexpr size_t forces = sizeof(scalar_t) * STAGES * forces_stage;
};

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

// Asynchronous copy of one element; zero-filled (nothing read) when !ok.
template <typename scalar_t>
__device__ __forceinline__ void cp_async_elem(scalar_t* dst, const scalar_t* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(s), "l"(src),
               "n"(int(sizeof(scalar_t))), "r"(ok ? int(sizeof(scalar_t)) : 0)
               : "memory");
}

// Stage rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major matrix with
// n_rows x n_cols entries and row stride ld into dst[r * LDS + c], with zeros
// outside the matrix; NT threads, neighbouring threads on neighbouring columns.
template <int R, int C, int LDS, int NT, typename scalar_t>
__device__ __forceinline__ void stage_tile(scalar_t* dst, const scalar_t* __restrict__ src, int r0,
                                           int n_rows, int c0, int n_cols, size_t ld) {
  static_assert(R * C % NT == 0, "whole tile per pass");
#pragma unroll
  for (int j = 0; j < R * C / NT; ++j) {
    const int i = threadIdx.x + j * NT;
    const int r = i / C, c = i % C;
    const int row = r0 + r, col = c0 + c;
    const bool ok = row < n_rows && col < n_cols;
    cp_async_elem(dst + r * LDS + c, ok ? src + (size_t)row * ld + col : src, ok);
  }
}

// Row and column in the block tile of a thread's output e.
template <int NP>
__device__ __forceinline__ int acc_row(double, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp >> 2) * 32 + (e >> 3) * 16 + (lane >> 2) + ((e & 3) >> 1) * 8;
}

template <int NP>
__device__ __forceinline__ int acc_col(double, int e) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  return (warp & 3) * 16 + ((e >> 2) & 1) * 8 + (lane & 3) * 2 + (e & 1);
}

template <int NP>
__device__ __forceinline__ int acc_row(float, int e) {
  using C = Cfg<float, NP>;
  return threadIdx.x / C::CS + (e / C::TN) * C::RS;
}

template <int NP>
__device__ __forceinline__ int acc_col(float, int e) {
  using C = Cfg<float, NP>;
  return threadIdx.x % C::CS + (e % C::TN) * C::CS;
}

__device__ __forceinline__ void dmma_16x8x4(double* d, double a0, double a1, double b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// acc[p] += A B_p^T over one BK-deep stage. A is a [row][k] tile; B_p is a
// [col][k] tile, or with KN a [k][col] tile. f64: acc[(mi * 2 + ni) * 4 + c]
// in the m16n8k4 C layout, rows g and g + 8, columns 2 tig and 2 tig + 1.
template <bool KN, int NP>
__device__ __forceinline__ void tile_step(const double* As, const double* const (&Bs)[NP],
                                          double (&acc)[NP][Cfg<double, NP>::ACC]) {
  constexpr int LDK = Cfg<double, NP>::LDK, LDN = Smem<double>::LDN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int m0 = (warp >> 2) * 32, n0 = (warp & 3) * 16;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 4) {
    double a[2][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      a[mi][0] = As[(m0 + mi * 16 + g) * LDK + kk + tig];
      a[mi][1] = As[(m0 + mi * 16 + g + 8) * LDK + kk + tig];
    }
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int ni = 0; ni < 2; ++ni) {
        const int n = n0 + ni * 8 + g, k = kk + tig;
        const double b = KN ? Bs[p][k * LDN + n] : Bs[p][n * LDK + k];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) dmma_16x8x4(&acc[p][(mi * 2 + ni) * 4], a[mi][0], a[mi][1], b);
      }
  }
}

template <bool KN, int NP>
__device__ __forceinline__ void tile_step(const float* As, const float* const (&Bs)[NP],
                                          float (&acc)[NP][Cfg<float, NP>::ACC]) {
  using C = Cfg<float, NP>;
  constexpr int TM = C::TM, TN = C::TN, LDK = C::LDK, LDN = Smem<float>::LDN;
  const int ty = threadIdx.x / C::CS, tx = threadIdx.x % C::CS;
#pragma unroll
  for (int k = 0; k < BK; ++k) {
    float a[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = As[(ty + C::RS * i) * LDK + k];
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      float b[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        b[j] = KN ? Bs[p][k * LDN + tx + C::CS * j] : Bs[p][(tx + C::CS * j) * LDK + k];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[p][i * TN + j] = fmaf(a[i], b[j], acc[p][i * TN + j]);
    }
  }
}

// Pass A: the planes of one (TILE query rows) x (TILE table rows) tile.
// planes (B, 2 Tp): cx at [0, Tp), cj at [Tp, 2 Tp), zeros past T.
// e_part, s_part (B, n_t): this tile's row sums of ep and cx at column blockIdx.y.
template <typename scalar_t, typename C = Cfg<scalar_t, 2>>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
planes_kernel(const scalar_t* __restrict__ xq, const scalar_t* __restrict__ xt,
              const scalar_t* __restrict__ ja, const scalar_t* __restrict__ xt_sq,
              const scalar_t* __restrict__ tja, const scalar_t* __restrict__ ae,
              const scalar_t sig, const int B, const int T, const int D,
              scalar_t* __restrict__ planes, scalar_t* __restrict__ e_part,
              scalar_t* __restrict__ s_part) {
  constexpr int NT = C::THREADS, LDK = C::LDK, LDE = Smem<scalar_t>::LDE;
  constexpr int XT = TILE * LDK, STAGE = Smem<scalar_t>::planes_stage;
  static_assert(2 * TILE <= NT, "one thread per row sum");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* smem = reinterpret_cast<scalar_t*>(smem_raw);
  __shared__ scalar_t xq_sq_s[TILE];

  const int b0 = blockIdx.x * TILE, t0 = blockIdx.y * TILE;
  const int n_t = gridDim.y, Tp = n_t * TILE;
  const int n_k = (D + BK - 1) / BK;

  auto load = [&](int kt) {
    if (kt < n_k) {
      scalar_t* s = smem + (kt % STAGES) * STAGE;
      const int k0 = kt * BK;
      stage_tile<TILE, BK, LDK, NT>(s, xq, b0, B, k0, D, D);
      stage_tile<TILE, BK, LDK, NT>(s + XT, xt, t0, T, k0, D, D);
      stage_tile<TILE, BK, LDK, NT>(s + 2 * XT, ja, t0, T, k0, D, D);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  scalar_t acc[2][C::ACC] = {};  // gram, xq.ja
  scalar_t sq = 0;               // |xq|^2 of row threadIdx.x (< TILE)
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load(kt + STAGES - 1);
    const scalar_t* s = smem + (kt % STAGES) * STAGE;
    if (threadIdx.x < TILE) {
#pragma unroll
      for (int c = 0; c < BK; ++c) {
        const scalar_t v = s[threadIdx.x * LDK + c];
        sq += v * v;
      }
    }
    const scalar_t* const bs[2] = {s + XT, s + 2 * XT};
    tile_step<false, 2>(s, bs, acc);
  }
  cp_async_wait<0>();
  if (threadIdx.x < TILE) xq_sq_s[threadIdx.x] = sq;
  __syncthreads();  // the ring is free: it now stages ep and cx for the row sums

  scalar_t* cx_s = smem;
  scalar_t* ep_s = smem + TILE * LDE;
  const Coeffs<scalar_t> cf = coeffs(sig);
  const size_t ldp = 2 * (size_t)Tp;
#pragma unroll
  for (int e = 0; e < C::ACC; ++e) {
    const int r = acc_row<2>(scalar_t(), e), c = acc_col<2>(scalar_t(), e);
    const int b = b0 + r, t = t0 + c;
    const bool t_ok = t < T;
    const scalar_t xts = t_ok ? xt_sq[t] : scalar_t(0);
    const scalar_t tj = t_ok ? tja[t] : scalar_t(0);
    const scalar_t aet = (ae != nullptr && t_ok) ? ae[t] : scalar_t(0);
    scalar_t ep, cx, cj;
    plane_terms(acc[0][e], acc[1][e], xq_sq_s[r], xts, tj, ae != nullptr, aet, t_ok, cf, ep, cx, cj);
    cx_s[r * LDE + c] = cx;
    ep_s[r * LDE + c] = ep;
    if (b < B) {
      planes[b * ldp + t] = cx;
      planes[b * ldp + Tp + t] = cj;
    }
  }
  __syncthreads();
  // Row sums in column order: thread r < TILE sums cx, TILE <= r < 2 TILE ep.
  if (threadIdx.x < 2 * TILE) {
    const int r = threadIdx.x % TILE, b = b0 + r;
    const scalar_t* src = threadIdx.x < TILE ? cx_s : ep_s;
    scalar_t sum = 0;
    for (int c = 0; c < TILE; ++c) sum += src[r * LDE + c];
    if (b < B) (threadIdx.x < TILE ? s_part : e_part)[(size_t)b * n_t + blockIdx.y] = sum;
  }
}

// Pass B: partial[s] = [cx | cj] [Xt ; JA] over split s of the K = 2 Tp axis,
// for one (TILE query rows) x (TILE descriptor columns) tile. K rows below Tp
// come from Xt, the rest from JA, each from its own base pointer; rows past T
// are zero (and so are their planes).
template <typename scalar_t, typename C = Cfg<scalar_t, 1>>
__global__ void __launch_bounds__(C::THREADS, C::MIN_BLOCKS)
forces_kernel(const scalar_t* __restrict__ xt, const scalar_t* __restrict__ ja,
              const scalar_t* __restrict__ planes, const int B, const int T, const int D,
              const int Tp, const int per, scalar_t* __restrict__ partial) {
  constexpr int NT = C::THREADS, LDK = C::LDK, LDN = Smem<scalar_t>::LDN;
  constexpr int A = TILE * LDK, STAGE = Smem<scalar_t>::forces_stage;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* smem = reinterpret_cast<scalar_t*>(smem_raw);

  const int b0 = blockIdx.x * TILE, d0 = blockIdx.y * TILE;
  const int K = 2 * Tp, n_k = K / BK;
  const int kt0 = blockIdx.z * per, kt1 = min(n_k, kt0 + per);

  auto load = [&](int kt) {
    if (kt < kt1) {
      scalar_t* s = smem + ((kt - kt0) % STAGES) * STAGE;
      const int k0 = kt * BK;
      stage_tile<TILE, BK, LDK, NT>(s, planes, b0, B, k0, K, K);
      const bool from_xt = k0 < Tp;  // Tp is a multiple of BK: a stage never straddles
      stage_tile<BK, TILE, LDN, NT>(s + A, from_xt ? xt : ja, from_xt ? k0 : k0 - Tp, T, d0, D, D);
    }
    cp_async_commit();
  };

  scalar_t acc[1][C::ACC] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(kt0 + s);
  for (int kt = kt0; kt < kt1; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    load(kt + STAGES - 1);
    const scalar_t* s = smem + ((kt - kt0) % STAGES) * STAGE;
    const scalar_t* const bs[1] = {s + A};
    tile_step<true, 1>(s, bs, acc);
  }
  cp_async_wait<0>();

  scalar_t* dst = partial + (size_t)blockIdx.z * B * D;
#pragma unroll
  for (int e = 0; e < C::ACC; ++e) {
    const int b = b0 + acc_row<1>(scalar_t(), e), d = d0 + acc_col<1>(scalar_t(), e);
    if (b < B && d < D) dst[(size_t)b * D + d] = acc[0][e];
  }
}

// F_d[b] = (sum_j s_part[b, j]) xq[b] - sum_s partial[s, b] and E[b] =
// sum_j e_part[b, j], every sum in index order. One block per query row.
constexpr int REDUCE_THREADS = 256;

template <typename scalar_t>
__global__ void __launch_bounds__(REDUCE_THREADS)
reduce_kernel(const scalar_t* __restrict__ xq, const scalar_t* __restrict__ e_part,
              const scalar_t* __restrict__ s_part, const scalar_t* __restrict__ partial,
              const int B, const int D, const int n_t, const int splits,
              scalar_t* __restrict__ e_out, scalar_t* __restrict__ f_out) {
  __shared__ scalar_t scx;
  const int b = blockIdx.x;
  if (threadIdx.x == 0 || threadIdx.x == 32) {
    const scalar_t* src = (threadIdx.x == 0 ? s_part : e_part) + (size_t)b * n_t;
    scalar_t sum = 0;
    for (int j = 0; j < n_t; ++j) sum += src[j];
    if (threadIdx.x == 0) scx = sum;
    else e_out[b] = sum;
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += REDUCE_THREADS) {
    const size_t i = (size_t)b * D + d;
    scalar_t acc = partial[i];
    for (int s = 1; s < splits; ++s) acc += partial[(size_t)s * B * D + i];
    f_out[i] = scx * xq[i] - acc;
  }
}

// Raise the dynamic shared-memory limit of the pass (scalar_t, NP) kernel to
// `bytes`, once per device: the call costs microseconds, and MD makes
// thousands of calls.
template <typename scalar_t, int NP>
cudaError_t allow_smem(const void* kernel, size_t bytes, int device) {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  if (device >= 0 && device < kDevices && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(bytes));
  if (err == cudaSuccess && device >= 0 && device < kDevices) done[device] = true;
  return err;
}

template <typename scalar_t>
int launch_planes(const void* xq, const void* xt, const void* ja, const void* xt_sq,
                  const void* tja, const void* ae, double sig, int B, int T, int D,
                  void* planes, void* e_part, void* s_part, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem = Smem<scalar_t>::planes;
  err = allow_smem<scalar_t, 2>(reinterpret_cast<const void*>(planes_kernel<scalar_t>), smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int threads = Cfg<scalar_t, 2>::THREADS;
  const dim3 grid((B + TILE - 1) / TILE, (T + TILE - 1) / TILE);
  planes_kernel<scalar_t><<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const scalar_t*>(xq), static_cast<const scalar_t*>(xt),
      static_cast<const scalar_t*>(ja), static_cast<const scalar_t*>(xt_sq),
      static_cast<const scalar_t*>(tja), static_cast<const scalar_t*>(ae),
      static_cast<scalar_t>(sig), B, T, D, static_cast<scalar_t*>(planes),
      static_cast<scalar_t*>(e_part), static_cast<scalar_t*>(s_part));
  return static_cast<int>(cudaGetLastError());
}

template <typename scalar_t>
int launch_forces(const void* xq, const void* xt, const void* ja, const void* planes,
                  const void* e_part, const void* s_part, int B, int T, int D, int splits,
                  int per, void* partial, void* e_out, void* f_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr size_t smem = Smem<scalar_t>::forces;
  err = allow_smem<scalar_t, 1>(reinterpret_cast<const void*>(forces_kernel<scalar_t>), smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_t = (T + TILE - 1) / TILE;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  constexpr int threads = Cfg<scalar_t, 1>::THREADS;
  const dim3 grid((B + TILE - 1) / TILE, (D + TILE - 1) / TILE, splits);
  forces_kernel<scalar_t><<<grid, threads, smem, st>>>(
      static_cast<const scalar_t*>(xt), static_cast<const scalar_t*>(ja),
      static_cast<const scalar_t*>(planes), B, T, D, n_t * TILE, per,
      static_cast<scalar_t*>(partial));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<scalar_t><<<B, REDUCE_THREADS, 0, st>>>(
      static_cast<const scalar_t*>(xq), static_cast<const scalar_t*>(e_part),
      static_cast<const scalar_t*>(s_part), static_cast<const scalar_t*>(partial), B, D, n_t,
      splits, static_cast<scalar_t*>(e_out), static_cast<scalar_t*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

// Both passes, their scratch carved from one buffer of B (2 Tp + 2 n_t +
// splits D) elements: planes (B, 2 Tp), e_part and s_part (B, n_t), partial
// (splits, B, D).
template <typename scalar_t>
int launch_two_pass(const void* xq, const void* xt, const void* ja, const void* xt_sq,
                    const void* tja, const void* ae, double sig, int B, int T, int D, int splits,
                    int per, void* scratch, void* e_out, void* f_out, int device, void* stream) {
  const size_t n_t = (T + TILE - 1) / TILE;
  scalar_t* planes = static_cast<scalar_t*>(scratch);
  scalar_t* e_part = planes + (size_t)B * 2 * n_t * TILE;
  scalar_t* s_part = e_part + (size_t)B * n_t;
  scalar_t* partial = s_part + (size_t)B * n_t;
  const int err = launch_planes<scalar_t>(xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, planes, e_part,
                                          s_part, device, stream);
  if (err != 0) return err;
  return launch_forces<scalar_t>(xq, xt, ja, planes, e_part, s_part, B, T, D, splits, per, partial,
                                 e_out, f_out, device, stream);
}

// ===========================================================================
// Split T (small batches: B <= 16).
// ===========================================================================

constexpr int ST_WARPS = 8;                   // ops/fused_predict.py:SPLIT_T_WARPS
constexpr int ST_THREADS = ST_WARPS * 32;
constexpr int ST_CHUNK = ST_WARPS;            // table rows a block takes at a time, one a warp
constexpr int ST_RUNS = 32;                   // ops/fused_predict.py:SPLIT_T_REDUCE_RUNS
constexpr int ST_SMEM_MAX = 227 * 1024;       // a block's shared memory on sm_90

template <typename scalar_t>
struct Vec16;
template <>
struct Vec16<double> {
  using type = double2;
  static __device__ __forceinline__ double at(const double2& v, int e) { return e == 0 ? v.x : v.y; }
};
template <>
struct Vec16<float> {
  using type = float4;
  static __device__ __forceinline__ float at(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
};

// acc[b] += xq[b, d] v for the B staged queries (row stride D), and with SQ
// sq[b] += xq[b, d]^2 on the way.
template <bool SQ, typename scalar_t, int MAXB>
__device__ __forceinline__ void fma_queries(scalar_t v, int d, const scalar_t* xq_s, int B, int D,
                                            scalar_t (&acc)[MAXB], scalar_t (&sq)[MAXB]) {
#pragma unroll
  for (int b = 0; b < MAXB; ++b)
    if (b < B) {
      const scalar_t x = xq_s[b * D + d];
      acc[b] += x * v;
      if (SQ) sq[b] += x * x;
    }
}

// Elements of a row before its first 16-byte boundary (fewer than 16 bytes).
template <typename scalar_t>
__device__ __forceinline__ int head_elems(const scalar_t* row, int D) {
  const int h = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15) / int(sizeof(scalar_t));
  return h < D ? h : D;
}

// A table row pair xt[t], ja[t] as one lane of a warp reads it: the aligned
// body of each row in 16-byte vectors, the ragged head and tail (fewer than
// 16 bytes each) in elements. A lane holds K vectors of each row at a time,
// loaded before any is used, so that 2 K loads are in flight (a row of D =
// 210 doubles in one batch at B = 1); the kernel loads a warp's first batch
// while the queries are staged. Fewer at larger B, whose accumulators take
// the registers.
template <typename scalar_t, int MAXB>
struct RowPair {
  using V = typename Vec16<scalar_t>::type;
  static constexpr int VEC = 16 / sizeof(scalar_t);
  static constexpr int K = (MAXB == 1 ? 16 : MAXB <= 4 ? 8 : 4) / VEC;
  const scalar_t* xr;
  const scalar_t* jr;
  int hx, hj, nx, nj;
  V x[K], j[K];

  __device__ __forceinline__ void at(const scalar_t* xr_, const scalar_t* jr_, int D) {
    xr = xr_;
    jr = jr_;
    hx = head_elems(xr, D);
    hj = head_elems(jr, D);
    nx = (D - hx) / VEC;
    nj = (D - hj) / VEC;
  }

  // Vectors v0 + 32 k of each body, k < K.
  __device__ __forceinline__ void load(int v0) {
    const V* xv = reinterpret_cast<const V*>(xr + hx);
    const V* jv = reinterpret_cast<const V*>(jr + hj);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int v = v0 + 32 * k;
      if (v < nx) x[k] = xv[v];
      if (v < nj) j[k] = jv[v];
    }
  }

  template <bool SQ>
  __device__ __forceinline__ void use(const V& vec, int d0, const scalar_t* xq_s, int B, int D,
                                      scalar_t (&acc)[MAXB], scalar_t (&sq)[MAXB]) {
#pragma unroll
    for (int e = 0; e < VEC; ++e) fma_queries<SQ>(Vec16<scalar_t>::at(vec, e), d0 + e, xq_s, B, D, acc, sq);
  }

  // This lane's part of g[b] = xq[b].xt[t], q[b] = xq[b].ja[t] and, with
  // SQ, sq[b] = |xq[b]|^2 (the lanes of a warp cover every column of xt[t]
  // once), the batch at v0 = lane already loaded.
  template <bool SQ>
  __device__ __forceinline__ void dots(int lane, const scalar_t* xq_s, int B, int D, scalar_t (&g)[MAXB],
                                       scalar_t (&q)[MAXB], scalar_t (&sq)[MAXB]) {
    const int n = nx > nj ? nx : nj;
    for (int v0 = lane;; ) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int v = v0 + 32 * k;
        if (v < nx) use<SQ>(x[k], hx + v * VEC, xq_s, B, D, g, sq);
        if (v < nj) use<false>(j[k], hj + v * VEC, xq_s, B, D, q, sq);
      }
      v0 += 32 * K;
      if (v0 >= n) break;
      load(v0);
    }
    if (lane < hx) fma_queries<SQ>(xr[lane], lane, xq_s, B, D, g, sq);
    if (lane < hj) fma_queries<false>(jr[lane], lane, xq_s, B, D, q, sq);
    const int tx = hx + nx * VEC + lane, tj = hj + nj * VEC + lane;
    if (tx < D) fma_queries<SQ>(xr[tx], tx, xq_s, B, D, g, sq);
    if (tj < D) fma_queries<false>(jr[tj], tj, xq_s, B, D, q, sq);
  }
};

// Sums of v[b] over the warp's lanes, scattered: lane l returns the sum of
// v[l % MAXB]. Plain butterflies over the offsets at or above MAXB, then at
// each lower offset a lane keeps the half of its values whose index has the
// lane's bit: 31 shuffles for 32 sums where 32 warp sums take 160.
// The offsets are template arguments, so that every index into v is a
// constant and v stays in registers.
template <int OFF, typename scalar_t, int MAXB>
__device__ __forceinline__ void scatter_steps(scalar_t (&v)[MAXB], int lane) {
  if constexpr (OFF >= MAXB) {
#pragma unroll
    for (int b = 0; b < MAXB; ++b) v[b] += __shfl_xor_sync(0xffffffffu, v[b], OFF);
  } else {
    const bool upper = lane & OFF;
#pragma unroll
    for (int i = 0; i < OFF; ++i) {
      const scalar_t send = upper ? v[i] : v[i + OFF];
      const scalar_t keep = upper ? v[i + OFF] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
    }
  }
  if constexpr (OFF > 1) scatter_steps<OFF / 2>(v, lane);
}

template <typename scalar_t, int MAXB>
__device__ __forceinline__ scalar_t warp_scatter_sum(scalar_t (&v)[MAXB], int lane) {
  static_assert(MAXB >= 1 && MAXB <= 32 && (MAXB & (MAXB - 1)) == 0, "a power of two up to 32");
  scatter_steps<16>(v, lane);
  return v[0];
}

// The split-T kernel's step policy: how a block stages its queries before
// the rows, and what it does after them. Queries, the default, copies the B
// query rows from xq and does nothing after: the contraction alone, whose
// block partials reduce_kernel adds.
template <typename scalar_t>
struct Queries {
  __device__ __forceinline__ void stage(scalar_t* xq_s, const scalar_t* __restrict__ xq, int B, int D) const {
#pragma unroll 4
    for (int i = threadIdx.x; i < B * D; i += ST_THREADS) xq_s[i] = xq[i];
  }

  __device__ __forceinline__ void finish(scalar_t*, const scalar_t*, int) const {}
};

// Products, sums and differences rounded each on its own, never contracted
// into an FMA: the step's elementwise arithmetic as PyTorch's separate
// kernels (and md_step_reference) round it.
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double drsqrt(double x) { return rsqrt(x); }
__device__ __forceinline__ float drsqrt(float x) { return rsqrtf(x); }

// Atom pair p = (a, b), a > b, in numpy.tril_indices(N, -1) order: p = a (a - 1) / 2 + b.
__device__ __forceinline__ void tril_pair(int p, int& a, int& b) {
  int r = static_cast<int>(0.5f * (1.0f + sqrtf(8.0f * p + 1.0f)));  // then corrected to the exact row
  while (r * (r - 1) / 2 > p) --r;
  while (r * (r + 1) / 2 <= p) ++r;
  a = r;
  b = p - r * (r - 1) / 2;
}

// Column c of the rows j0 <= j < j1 of src (row stride ld), added in order
// from zero as reduce_kernel adds them: loaded R at a time (zeros past j1)
// before any is added. Read past L1: other blocks wrote them during this
// kernel.
template <int R, typename scalar_t>
__device__ __forceinline__ scalar_t ordered_sum(const scalar_t* src, int j0, int j1, int c, size_t ld) {
  scalar_t acc = 0;
  for (int j = j0; j < j1; j += R) {
    scalar_t x[R];
#pragma unroll
    for (int k = 0; k < R; ++k) x[k] = j + k < j1 ? __ldcg(src + (j + k) * ld + c) : scalar_t(0);
#pragma unroll
    for (int k = 0; k < R; ++k) acc += x[k];
  }
  return acc;
}

// The ticket of a block that has written its share, taken by one thread
// after a barrier behind which the block's writes lie: one atomic add that
// releases them at the GPU's scope and acquires the writes of the blocks
// that took the ticket before (no full fence). Returns the count before
// this block's.
__device__ __forceinline__ unsigned take_ticket(unsigned* ticket) {
  unsigned seen;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(seen) : "l"(ticket) : "memory");
  return seen;
}

// One velocity-Verlet step of MD at B = 1, as the split-T kernel's policy
// (md.MDEngine.run_nve's substep: the drift, the descriptor, K1, the
// Jacobian-transpose map and the kick, in one launch). Every block stages
// the drifted positions r' = r + dt (v + dt/2 f / m) and the centred
// descriptor of r' (the pair loop of ops/descriptor.descriptor_jacobian) in
// place of a copy of xq; no block writes the state before all have read it.
// After the rows one block finishes the step: the partials of each run of
// `per` consecutive blocks are added, in block order, by the run's last block
// to finish (a ticket a run), and the run sums, in run order, by the last run
// to finish (one more ticket): reduce_kernel's sums, to the bit. That block
// forms F_d = s xq - sum, the forces F = std J^T F_d by the incidence sum (for
// each atom over its pairs in pair order), and writes r <- r', v <- v_half +
// dt/2 F / m, f <- F and E_raw. The tickets are the only atomics and count
// blocks, never values; each is set back to zero by the block that read it
// last, so every launch (and every CUDA graph replay) finds them at zero.
// (A second kernel of one block in place of the tickets made a step twice as
// long: PERF.md, section 6.)
template <typename scalar_t>
struct NveStep {
  scalar_t* r;            // (N, 3) positions, advanced in place
  scalar_t* v;            // (N, 3) velocities
  scalar_t* f;            // (N, 3) forces
  const scalar_t* inv_m;  // (N,) inverse masses
  const scalar_t* mu;     // (D,) the tables' mean descriptor
  scalar_t* runs;         // (n_runs, D + 2) the run sums of the block partials
  unsigned* tickets;      // n_runs + 1 block counters, zero between launches
  scalar_t* e_out;        // (1,) E_raw at the new positions
  scalar_t dt, half_dt, label_std;  // the step, half of it, the model's label scale
  int N, per, n_runs;

  // Shared memory past the staged query: r' and v_half (3N each), the
  // inverse masses (N), 1/d^3 (D), the column sums (D + 2) and the ticket's
  // verdict (one element; no static shared memory, which would cut the
  // dynamic limit below ST_SMEM_MAX).
  static size_t extra(int N, int D) { return 7 * (size_t)N + 2 * (size_t)D + 3; }

  __device__ __forceinline__ void stage(scalar_t* xq_s, const scalar_t* /*xq*/, int /*B*/, int D) const {
    scalar_t* rd = xq_s + D;
    scalar_t* vh = rd + 3 * N;
    scalar_t* im = vh + 3 * N;
    scalar_t* id3 = im + N;
    for (int n = threadIdx.x; n < N; n += ST_THREADS) im[n] = inv_m[n];  // for the kick, without a load
    scalar_t mu_next = threadIdx.x < D ? mu[threadIdx.x] : scalar_t(0);  // on its way during the drift
    for (int i = threadIdx.x; i < 3 * N; i += ST_THREADS) {
      const scalar_t v_half = add_rn(v[i], mul_rn(mul_rn(half_dt, f[i]), inv_m[i / 3]));
      vh[i] = v_half;
      rd[i] = add_rn(r[i], mul_rn(dt, v_half));
    }
    __syncthreads();
    for (int p = threadIdx.x; p < D; p += ST_THREADS) {
      const scalar_t mu_p = mu_next;
      if (p + ST_THREADS < D) mu_next = mu[p + ST_THREADS];
      int a, b;
      tril_pair(p, a, b);
      const scalar_t dx = sub_rn(rd[3 * a], rd[3 * b]), dy = sub_rn(rd[3 * a + 1], rd[3 * b + 1]),
                     dz = sub_rn(rd[3 * a + 2], rd[3 * b + 2]);
      const scalar_t inv_d = drsqrt(add_rn(add_rn(mul_rn(dx, dx), mul_rn(dy, dy)), mul_rn(dz, dz)));
      xq_s[p] = sub_rn(inv_d, mu_p);
      id3[p] = mul_rn(mul_rn(inv_d, inv_d), inv_d);
    }
  }

  // F_d, the forces, the kick and the new state from the column sums tot
  // (D + 2: the force partials, E_raw, the cx sum); one block.
  __device__ __forceinline__ void advance(const scalar_t* xq_s, scalar_t* tot, int D) const {
    const scalar_t* rd = xq_s + D;
    const scalar_t* vh = rd + 3 * N;
    const scalar_t* im = vh + 3 * N;
    const scalar_t* id3 = im + N;
    const scalar_t s = tot[D + 1];
    for (int p = threadIdx.x; p < D; p += ST_THREADS) tot[p] = s * xq_s[p] - tot[p];  // F_d, as reduce_kernel
    __syncthreads();
    for (int i = threadIdx.x; i < 3 * N; i += ST_THREADS) {
      const int n = i / 3, c = i % 3;
      scalar_t acc = 0;
#pragma unroll 4
      for (int b = 0; b < n; ++b) {  // pairs (n, b): the incidence -1
        const int p = n * (n - 1) / 2 + b;
        acc = sub_rn(acc, mul_rn(mul_rn(sub_rn(rd[3 * n + c], rd[3 * b + c]), id3[p]), tot[p]));
      }
#pragma unroll 4
      for (int a = n + 1; a < N; ++a) {  // pairs (a, n): +1
        const int p = a * (a - 1) / 2 + n;
        acc = add_rn(acc, mul_rn(mul_rn(sub_rn(rd[3 * a + c], rd[3 * n + c]), id3[p]), tot[p]));
      }
      const scalar_t F = mul_rn(acc, label_std);
      r[i] = rd[i];
      v[i] = add_rn(vh[i], mul_rn(mul_rn(half_dt, F), im[n]));
      f[i] = F;
    }
    if (threadIdx.x == 0) e_out[0] = tot[D];
  }

  __device__ __forceinline__ void finish(scalar_t* xq_s, const scalar_t* part, int D) const {
    scalar_t* tot = xq_s + D + 7 * N + D;
    volatile int& last = *reinterpret_cast<int*>(tot + D + 2);
    const size_t ld = D + 2;
    const int k = blockIdx.x / per, j0 = k * per, j1 = min((int)gridDim.x, j0 + per);
    __syncthreads();  // this block's partial written
    if (threadIdx.x == 0) last = take_ticket(tickets + k) == unsigned(j1 - j0 - 1);
    __syncthreads();
    if (!last) return;
    for (int c = threadIdx.x; c < D + 2; c += ST_THREADS) runs[k * ld + c] = ordered_sum<8>(part, j0, j1, c, ld);
    __syncthreads();
    if (threadIdx.x == 0) {
      tickets[k] = 0;
      last = take_ticket(tickets + n_runs) == unsigned(n_runs - 1);
    }
    __syncthreads();
    if (!last) return;
    // The run sums in order (reduce_kernel adds zeros for its empty runs too: no sum but -0 changes).
    for (int c = threadIdx.x; c < D + 2; c += ST_THREADS) tot[c] = ordered_sum<ST_RUNS>(runs, 0, n_runs, c, ld);
    if (threadIdx.x == 0) tickets[n_runs] = 0;
    __syncthreads();
    advance(xq_s, tot, D);
  }
};

// Block j owns table rows [j rows, (j + 1) rows) (none past T) and takes them
// ST_CHUNK at a time, one a warp. Dynamic shared memory: the chunk's planes
// cx, cj and ep (MAXB x ST_CHUNK each), |xq|^2 (MAXB), then the B staged
// queries (B x D), then what the step policy Step stages past them. Thread ST_THREADS - 1 - b (idle
// in the column loop when D < ST_THREADS - B) adds query b's row sums of ep
// and cx. One query's |xq|^2 is summed by each warp beside its first gram
// (FOLD), which saves a barrier; more queries' once, before the rows.
// Block j writes part[j, b] = [sum_t cx xt + cj ja over its rows (D),
// sum_t ep, sum_t cx] (row stride D + 2), and the reduction kernel finishes.
// Phase 2 reads the chunk's rows a second time, thread = column, from the
// L1 or L2 that phase 1's reads filled (see the note at the head).
template <typename scalar_t, int MAXB, typename Step = Queries<scalar_t>>
__global__ void __launch_bounds__(ST_THREADS, MAXB <= 4 ? 2 : 1)
fused_predict_kernel(const scalar_t* __restrict__ xq, const scalar_t* __restrict__ xt,
                     const scalar_t* __restrict__ ja, const scalar_t* __restrict__ xt_sq,
                     const scalar_t* __restrict__ tja, const scalar_t* __restrict__ ae,
                     const scalar_t sig, const int B, const int T, const int D, const int rows,
                     scalar_t* __restrict__ part, const Step step) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  scalar_t* cx_s = reinterpret_cast<scalar_t*>(smem_raw);
  scalar_t* cj_s = cx_s + MAXB * ST_CHUNK;
  scalar_t* ep_s = cj_s + MAXB * ST_CHUNK;
  scalar_t* xq_sq_s = ep_s + MAXB * ST_CHUNK;
  scalar_t* xq_s = xq_sq_s + MAXB;
  constexpr bool FOLD = MAXB == 1;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, sum_b = ST_THREADS - 1 - tid;
  const Coeffs<scalar_t> cf = coeffs(sig);
  const int t_begin = blockIdx.x * rows;
  const int n_rows = max(0, min(rows, T - t_begin));

  RowPair<scalar_t, MAXB> row;
  if (warp < n_rows) {  // this warp's first row, on its way while the queries are staged
    row.at(xt + (size_t)(t_begin + warp) * D, ja + (size_t)(t_begin + warp) * D, D);
    row.load(lane);
  }
  step.stage(xq_s, xq, B, D);
  __syncthreads();
  if constexpr (!FOLD) {
    for (int b = warp; b < B; b += ST_WARPS) {
      scalar_t acc = 0;
      for (int k = lane; k < D; k += 32) acc += xq_s[b * D + k] * xq_s[b * D + k];
      acc = warp_sum(acc);
      if (lane == 0) xq_sq_s[b] = acc;
    }
    __syncthreads();
  }

  scalar_t e_acc = 0, s_acc = 0;
  // A block without rows still writes its (zero) partial: one chunk at least.
  for (int c0 = 0; c0 < max(n_rows, 1); c0 += ST_CHUNK) {
    const int n_c = min(ST_CHUNK, n_rows - c0);
    // Phase 1: the planes of row c0 + warp against every query.
    if (warp < n_c) {
      const int t = t_begin + c0 + warp;
      const scalar_t xts = xt_sq[t], tj = tja[t], aet = ae != nullptr ? ae[t] : scalar_t(0);
      if (c0 > 0) {
        row.at(xt + (size_t)t * D, ja + (size_t)t * D, D);
        row.load(lane);
      }
      scalar_t g[MAXB] = {}, q[MAXB] = {}, sq[MAXB] = {};
      row.template dots<FOLD>(lane, xq_s, B, D, g, q, sq);
      const scalar_t gb = warp_scatter_sum<scalar_t, MAXB>(g, lane);
      const scalar_t qb = warp_scatter_sum<scalar_t, MAXB>(q, lane);
      scalar_t sqb;
      if constexpr (FOLD) sqb = warp_scatter_sum<scalar_t, MAXB>(sq, lane);
      else sqb = xq_sq_s[lane < B ? lane : 0];
      if (lane < B) {
        scalar_t ep, cx, cj;
        plane_terms(gb, qb, sqb, xts, tj, ae != nullptr, aet, true, cf, ep, cx, cj);
        cx_s[lane * ST_CHUNK + warp] = cx;
        cj_s[lane * ST_CHUNK + warp] = cj;
        ep_s[lane * ST_CHUNK + warp] = ep;
      }
    }
    __syncthreads();
    if (sum_b < B)
      for (int r = 0; r < n_c; ++r) {
        e_acc += ep_s[sum_b * ST_CHUNK + r];
        s_acc += cx_s[sum_b * ST_CHUNK + r];
      }
    // Phase 2: sum over the chunk's rows of cx xt[t] + cj ja[t]; thread = column.
    for (int d = tid; d < D; d += ST_THREADS) {
      scalar_t x[ST_CHUNK], j[ST_CHUNK], acc[MAXB] = {};
#pragma unroll
      for (int r = 0; r < ST_CHUNK; ++r) {
        const size_t i = (size_t)(t_begin + c0 + r) * D + d;
        x[r] = r < n_c ? xt[i] : scalar_t(0);
        j[r] = r < n_c ? ja[i] : scalar_t(0);
      }
#pragma unroll
      for (int r = 0; r < ST_CHUNK; ++r) {
        if (r >= n_c) break;
#pragma unroll
        for (int b = 0; b < MAXB; ++b)
          if (b < B) acc[b] += cx_s[b * ST_CHUNK + r] * x[r] + cj_s[b * ST_CHUNK + r] * j[r];
      }
#pragma unroll
      for (int b = 0; b < MAXB; ++b) {
        if (b >= B) continue;
        // The same thread owns this element in every chunk: no barrier.
        scalar_t* dst = part + ((size_t)blockIdx.x * B + b) * (D + 2) + d;
        *dst = (c0 == 0 ? scalar_t(0) : *dst) + acc[b];
      }
    }
    __syncthreads();  // the next chunk's planes overwrite this one's
  }

  if (sum_b < B) {
    scalar_t* dst = part + ((size_t)blockIdx.x * B + sum_b) * (D + 2) + D;
    dst[0] = e_acc;
    dst[1] = s_acc;
  }
  step.finish(xq_s, part, D);
}

// E_raw[b] and F_d[b] = (sum_j s_j) xq[b] - sum_j P_j from the block
// partials part[j, b] = [P_j (D), e_j, s_j] of `blocks` blocks: grid
// (ceil((D + 1) / 32), B), lane = column (column D is the energy). Warp w adds
// blocks [w per, (w + 1) per) in order, then warp 0 adds the ST_RUNS run sums
// in order. Every block adds the s_j column the same way, so all agree.
template <typename scalar_t, int RUNS>
__global__ void __launch_bounds__(RUNS * 32)
reduce_kernel(const scalar_t* __restrict__ xq, const scalar_t* __restrict__ part, const int B,
              const int D, const int blocks, scalar_t* __restrict__ e_out,
              scalar_t* __restrict__ f_out) {
  __shared__ scalar_t run_s[RUNS][33];  // column 32: the s_j run sums
  const int lane = threadIdx.x % 32, w = threadIdx.x / 32;
  const int b = blockIdx.y, c = blockIdx.x * 32 + lane;
  const int per = (blocks + RUNS - 1) / RUNS;
  const int j0 = min(blocks, w * per), j1 = min(blocks, j0 + per);
  const size_t ld = (size_t)B * (D + 2);
  const scalar_t* src = part + (size_t)b * (D + 2);
  // Loads in batches of R, issued before any is added (zeros past the run).
  constexpr int R = 8;
  scalar_t acc = 0, s = 0;
  for (int j = j0; j < j1; j += R) {
    scalar_t v[R], sv[R];
#pragma unroll
    for (int k = 0; k < R; ++k) {
      v[k] = c <= D && j + k < j1 ? src[(j + k) * ld + c] : scalar_t(0);
      sv[k] = lane == 0 && j + k < j1 ? src[(j + k) * ld + D + 1] : scalar_t(0);
    }
#pragma unroll
    for (int k = 0; k < R; ++k) {
      acc += v[k];
      s += sv[k];
    }
  }
  if (lane == 0) run_s[w][32] = s;
  run_s[w][lane] = acc;
  __syncthreads();
  if (w != 0) return;
  acc = 0, s = 0;
#pragma unroll
  for (int k = 0; k < RUNS; ++k) {
    acc += run_s[k][lane];
    s += run_s[k][32];
  }
  if (c < D) f_out[(size_t)b * D + c] = s * xq[(size_t)b * D + c] - acc;
  else if (c == D) e_out[b] = acc;
}

template <typename scalar_t, int MAXB>
int launch_split_t_b(const void* xq, const void* xt, const void* ja, const void* xt_sq,
                     const void* tja, const void* ae, double sig, int B, int T, int D, int blocks,
                     void* part, void* e_out, void* f_out, int device, cudaStream_t st) {
  const auto kernel = fused_predict_kernel<scalar_t, MAXB>;
  cudaError_t err = allow_smem<scalar_t, 100 + MAXB>(reinterpret_cast<const void*>(kernel), ST_SMEM_MAX, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = sizeof(scalar_t) * (3 * MAXB * ST_CHUNK + MAXB + (size_t)B * D);
  if (smem > ST_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (T + blocks - 1) / blocks;
  kernel<<<blocks, ST_THREADS, smem, st>>>(
      static_cast<const scalar_t*>(xq), static_cast<const scalar_t*>(xt),
      static_cast<const scalar_t*>(ja), static_cast<const scalar_t*>(xt_sq),
      static_cast<const scalar_t*>(tja), static_cast<const scalar_t*>(ae),
      static_cast<scalar_t>(sig), B, T, D, rows, static_cast<scalar_t*>(part), Queries<scalar_t>());
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<scalar_t, ST_RUNS><<<dim3((D + 1 + 31) / 32, B), ST_RUNS * 32, 0, st>>>(
      static_cast<const scalar_t*>(xq), static_cast<const scalar_t*>(part), B, D, blocks,
      static_cast<scalar_t*>(e_out), static_cast<scalar_t*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

template <typename scalar_t>
int launch_split_t(const void* xq, const void* xt, const void* ja, const void* xt_sq,
                   const void* tja, const void* ae, double sig, int B, int T, int D, int blocks,
                   void* part, void* e_out, void* f_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // Three instances: 2 and 5-8 queries ran in the next one up within 3% of
  // their own instances' times or faster (PERF.md, section 6), and each
  // instance is seconds of nvcc.
#define SGDML_SPLIT_T(MAXB)                                                                        \
  if (B <= MAXB)                                                                                   \
    return launch_split_t_b<scalar_t, MAXB>(xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, blocks, part, \
                                            e_out, f_out, device, st);
  SGDML_SPLIT_T(1)
  SGDML_SPLIT_T(4)
  SGDML_SPLIT_T(16)
#undef SGDML_SPLIT_T
  return static_cast<int>(cudaErrorInvalidValue);  // B > 16
}

// One NVE step at B = 1 (see NveStep): `blocks` blocks of the split-T kernel.
template <typename scalar_t>
int launch_md_step(const void* xt, const void* ja, const void* xt_sq, const void* tja, const void* mu,
                   const void* inv_m, double sig, double std_, double dt, int N, int T, int D, int blocks,
                   void* r, void* v, void* f, void* part, void* runs, void* tickets, void* e_out,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks < 1 || N < 2 || D != N * (N - 1) / 2) return static_cast<int>(cudaErrorInvalidValue);
  using Step = NveStep<scalar_t>;
  const auto kernel = fused_predict_kernel<scalar_t, 1, Step>;
  err = allow_smem<scalar_t, 201>(reinterpret_cast<const void*>(kernel), ST_SMEM_MAX, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t tail = D + Step::extra(N, D);
  const size_t smem = sizeof(scalar_t) * (3 * ST_CHUNK + 1 + tail);
  if (smem > ST_SMEM_MAX) return static_cast<int>(cudaErrorInvalidValue);
  const int per = (blocks + ST_RUNS - 1) / ST_RUNS;
  Step step{static_cast<scalar_t*>(r), static_cast<scalar_t*>(v), static_cast<scalar_t*>(f),
            static_cast<const scalar_t*>(inv_m), static_cast<const scalar_t*>(mu),
            static_cast<scalar_t*>(runs), static_cast<unsigned*>(tickets), static_cast<scalar_t*>(e_out),
            static_cast<scalar_t>(dt), static_cast<scalar_t>(0.5 * dt), static_cast<scalar_t>(std_),
            N, per, (blocks + per - 1) / per};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<blocks, ST_THREADS, smem, st>>>(
      nullptr, static_cast<const scalar_t*>(xt), static_cast<const scalar_t*>(ja),
      static_cast<const scalar_t*>(xt_sq), static_cast<const scalar_t*>(tja), nullptr,
      static_cast<scalar_t>(sig), 1, T, D, (T + blocks - 1) / blocks, static_cast<scalar_t*>(part), step);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// Wide (up to 4 queries, each too wide for split T).
// ===========================================================================
//
// Past split T's 64 KiB of f64 queries (D > 8,192 at B = 1: 129 atoms and
// more) a warp would hold a whole row pair (174 KB at D = 10,878), and the
// tables (104 MB at the buckyball catcher's T = 600) are twice the L2, so
// phase 2 of split T could not find its rows on chip again. The bound is
// those table bytes, read once (31.2 us at the buckyball width). This route
// splits the row as well: a cluster of WD_CLUSTER blocks owns a run of
// consecutive table rows, and block `rank` of it the slice [rank W, (rank +
// 1) W) of the D columns, W = ceil(D / WD_CLUSTER). A block's loader warps
// hold a row's slice in registers, a thread WD_COLS columns WD_LOAD_THREADS
// apart (coalesced 8- or 4-byte loads, so any width and alignment). For
// each row they form their part of xq.xt and xq.ja; warp 0 adds the warps
// in order, stores the block's partials into a slot of every block of the
// cluster (distributed shared memory, st.async, counted by that block's
// mbarrier), then adds the WD_CLUSTER slots it was sent in rank order, so
// that every block gets the same planes from plane_terms; the loaders then
// add cx xt + cj ja into their columns' forces from the registers that
// still hold the row. HBM and L2 see each row once a call. Only warp 0,
// which loads no table rows, takes part in the exchange, and the loaders
// meet it at named block barriers; they hand in the next row's partials
// before they wait for this row's planes, so that the exchange's latency
// overlaps their next row's dots, with a third row's loads in flight.
// Cluster g writes part[g] = [P_g (D), e_g, s_g] in split T's layout and
// reduce_kernel adds the clusters' partials in order. No atomics: the same
// bits every run.

constexpr int WD_CLUSTER = 4;                     // ops/fused_predict.py:WIDE_CLUSTER
constexpr int WD_LOADERS = 15;                    // loader warps of a block, after warp 0
constexpr int WD_LOAD_THREADS = WD_LOADERS * 32;  // ops/fused_predict.py:WIDE_THREADS
constexpr int WD_THREADS = WD_LOAD_THREADS + 32;  // 16 warps: 128 registers a thread
constexpr int WD_COLS = 6;                        // ops/fused_predict.py:WIDE_COLS
// The named barriers of exchange n: the loaders' partials in (WD_PARTS + n
// % 2), the planes out (WD_PLANES + n % 2). Two of each, since the loaders
// hand in exchange n + 1's partials before they take exchange n's planes.
constexpr int WD_PARTS = 1, WD_PLANES = 3;
// The runs of reduce_kernel: 4 warps of a block each add a run of about G /
// 4 cluster partials, loaded 8 at a time; 5 us faster at the buckyball
// width than split T's 32 runs of one (PERF.md, section 6).
constexpr int WD_REDUCE_RUNS = 4;                 // ops/fused_predict.py:WIDE_REDUCE_RUNS

// The wide kernel's instance: up to MAXB queries; NBUF table rows held in
// registers (the row whose planes are on their way, the row being dotted,
// the next on its way); NX partial dots a row (gram and xq.ja of each query).
template <int MAXB_>
struct Wide {
  static constexpr int MAXB = MAXB_, NBUF = 3, NX = 2 * MAXB_;
};

template <typename scalar_t>
struct WideArgs {
  const scalar_t* xq;
  const scalar_t* xt;
  const scalar_t* ja;
  const scalar_t* xt_sq;
  const scalar_t* tja;
  const scalar_t* ae;
  scalar_t sig;
  int B, T, D, W;  // W: the columns of a block's slice
  scalar_t* part;  // (clusters, B, D + 2)
};

// Dynamic shared memory of an instance, in bytes: two mbarriers, then in
// scalar_t, each twice (exchanges n and n + 1), the exchange slots
// [WD_CLUSTER][NX], the loader warps' partials [WD_LOADERS][NX] and the
// planes [NX] (cx, then cj, of each query); then, for each loader thread's
// own columns [MAXB][WD_COLS][WD_LOAD_THREADS], the block's slice of the
// queries and of the force partials.
template <typename scalar_t, typename Shape>
constexpr size_t wide_smem() {
  return 16 + sizeof(scalar_t) * (2 * (WD_CLUSTER + WD_LOADERS + 1) * Shape::NX +
                                  2 * (size_t)Shape::MAXB * WD_COLS * WD_LOAD_THREADS);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory"); }
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(WD_THREADS) : "memory");
}
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(WD_THREADS) : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// The address of shared-memory word `addr` in the cluster's block `rank`.
__device__ __forceinline__ unsigned map_rank(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}
// v into `addr` of a block of the cluster, counted as its bytes by the
// transaction count of that block's mbarrier `bar`.
__device__ __forceinline__ void st_async(unsigned addr, double v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, [%2];\n" ::"r"(addr),
               "l"(__double_as_longlong(v)), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void st_async(unsigned addr, float v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];\n" ::"r"(addr),
               "r"(__float_as_uint(v)), "r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// Row `row` of xt and ja at this loader thread's columns col0 +
// WD_LOAD_THREADS k, zeros past c1 and for rows at or past t1 (whose planes
// are zero). Streamed: nothing reads them again in this call.
template <typename scalar_t>
__device__ __forceinline__ void wide_load(scalar_t (&x)[WD_COLS], scalar_t (&j)[WD_COLS], const WideArgs<scalar_t>& a,
                                          int row, int t1, int col0, int c1) {
  const bool ok = row < t1;
  const scalar_t* xr = a.xt + (size_t)(ok ? row : 0) * a.D;
  const scalar_t* jr = a.ja + (size_t)(ok ? row : 0) * a.D;
#pragma unroll
  for (int k = 0; k < WD_COLS; ++k) {
    const int col = col0 + k * WD_LOAD_THREADS;
    x[k] = ok && col < c1 ? __ldcs(xr + col) : scalar_t(0);
    j[k] = ok && col < c1 ? __ldcs(jr + col) : scalar_t(0);
  }
}

// A loader warp's sums of its threads' v[i] for exchange n into its row of
// red[n % 2]; then the warp arrives at exchange n's WD_PARTS barrier.
template <int NX, typename scalar_t>
__device__ __forceinline__ void loader_parts(int n, const scalar_t (&v)[NX], scalar_t* red, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < NX; ++i) {
    const scalar_t s = warp_sum(v[i]);
    if (lane == 0) red[((n & 1) * WD_LOADERS + warp - 1) * NX + i] = s;
  }
  bar_arrive(WD_PARTS + (n & 1));
}

// The loader thread's part of xq.xt and xq.ja for every query, from the row
// pair x, j it holds.
template <int MAXB, typename scalar_t>
__device__ __forceinline__ void wide_dots(const scalar_t (&x)[WD_COLS], const scalar_t (&j)[WD_COLS],
                                          const scalar_t* xq_s, int lt, scalar_t (&d)[2 * MAXB]) {
#pragma unroll
  for (int i = 0; i < 2 * MAXB; ++i) d[i] = 0;
#pragma unroll
  for (int k = 0; k < WD_COLS; ++k)
#pragma unroll
    for (int b = 0; b < MAXB; ++b) {
      const scalar_t q = xq_s[(b * WD_COLS + k) * WD_LOAD_THREADS + lt];
      d[b] += q * x[k];
      d[MAXB + b] += q * j[k];
    }
}

// Warp 0's exchange n (every block of the cluster makes the same ones in
// the same order): past exchange n's WD_PARTS barrier, lane i < NX adds the
// loader warps' partials of value i in warp order and stores the sum into
// slot [n % 2][rank] of every block of the cluster, each store counted by
// that block's mbarrier n % 2; lane 0 arms its own mbarrier for the
// cluster's NX x WD_CLUSTER values. Once they are in, lane i adds the
// WD_CLUSTER slots of value i in rank order and returns that sum, the same
// bits in every block. A slot and its mbarrier are used again two exchanges
// later, which no block reaches before every block has finished this one:
// its next exchange waits on the stores of all.
template <int NX, typename scalar_t>
__device__ __forceinline__ scalar_t exchange(int n, const scalar_t* red, scalar_t* xs, unsigned long long* mbar,
                                             int rank, int lane) {
  const int p = n & 1;
  bar_sync(WD_PARTS + p);
  const unsigned bar = smem_u32(mbar + p);
  if (lane == 0) mbar_expect_tx(bar, WD_CLUSTER * NX * sizeof(scalar_t));
  if (lane < NX) {
    scalar_t s = 0;
#pragma unroll
    for (int w = 0; w < WD_LOADERS; ++w) s += red[(p * WD_LOADERS + w) * NX + lane];
    const unsigned slot = smem_u32(xs + (p * WD_CLUSTER + rank) * NX + lane);
#pragma unroll
    for (int r = 0; r < WD_CLUSTER; ++r) st_async(map_rank(slot, r), s, map_rank(bar, r));
  }
  mbar_wait(bar, (n >> 1) & 1);
  scalar_t tot = 0;
  if (lane < NX) {
#pragma unroll
    for (int r = 0; r < WD_CLUSTER; ++r) tot += xs[(p * WD_CLUSTER + r) * NX + lane];
  }
  return tot;
}

// The wide route's kernel (see the note above); an overload of the split-T
// kernel's name, so that a trace that names kernels counts it as K1's. Grid:
// clusters x WD_CLUSTER blocks; cluster g owns rows [g T / G, (g + 1) T / G).
// Exchange 0 sums |xq|^2, exchange k + 1 row t0 + k. The loaders hand in row
// k + 1's partials before they wait for row k's planes, so that warp 0's
// exchange of a row overlaps their dots of the next; row k sits in
// registers xr[k % 3] from two rows before its dots to its forces.
template <typename scalar_t, typename Shape>
__global__ void __cluster_dims__(WD_CLUSTER, 1, 1) __launch_bounds__(WD_THREADS, 1)
fused_predict_kernel(const WideArgs<scalar_t> a) {
  constexpr int MAXB = Shape::MAXB, NBUF = Shape::NBUF, NX = Shape::NX;
  constexpr int SLICE = MAXB * WD_COLS * WD_LOAD_THREADS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem_raw);
  scalar_t* xs = reinterpret_cast<scalar_t*>(smem_raw + 16);  // [2][WD_CLUSTER][NX]
  scalar_t* red = xs + 2 * WD_CLUSTER * NX;                    // [2][WD_LOADERS][NX]
  scalar_t* pl = red + 2 * WD_LOADERS * NX;                    // [2][NX]
  scalar_t* xq_s = pl + 2 * NX;                                // [MAXB][WD_COLS][WD_LOAD_THREADS]
  scalar_t* acc_s = xq_s + SLICE;                              // the same layout

  unsigned rank_u;
  asm("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank_u));
  const int rank = static_cast<int>(rank_u);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, lt = threadIdx.x - 32;  // lt: loader thread
  const int g = blockIdx.x / WD_CLUSTER, G = gridDim.x / WD_CLUSTER;
  const int B = a.B, D = a.D;
  const int c0 = rank * a.W, c1 = min(D, c0 + a.W), col0 = c0 + lt;
  const int t0 = static_cast<int>((long long)g * a.T / G), t1 = static_cast<int>((long long)(g + 1) * a.T / G);
  const Coeffs<scalar_t> cf = coeffs(a.sig);

  if (threadIdx.x == 0) {
    mbar_init(smem_u32(mbar), 1);
    mbar_init(smem_u32(mbar + 1), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (warp == 0 && lane < 2 * NX) pl[lane] = 0;  // the planes of queries past B stay zero
  // Every block's mbarriers ready, and the whole cluster running, before
  // warp 0 stores into another block's shared memory. The loaders, which
  // touch none, wait for this barrier only at the end.
  if (warp == 0) {
    cluster_arrive_release();
    cluster_wait();
  } else {
    cluster_arrive_relaxed();
  }

  scalar_t xr[NBUF][WD_COLS], jr[NBUF][WD_COLS];
  scalar_t xq_sq = 0, e_acc = 0, s_acc = 0;  // warp 0, lane b: |xq_b|^2 and its sums of ep and cx
  if (warp > 0) {
#pragma unroll
    for (int u = 0; u < NBUF - 1; ++u) wide_load(xr[u], jr[u], a, t0 + u, t1, col0, c1);
    scalar_t sq[NX] = {};
#pragma unroll
    for (int b = 0; b < MAXB; ++b)
#pragma unroll
      for (int k = 0; k < WD_COLS; ++k) {
        const int col = col0 + k * WD_LOAD_THREADS, i = (b * WD_COLS + k) * WD_LOAD_THREADS + lt;
        const scalar_t x = b < B && col < c1 ? a.xq[(size_t)b * D + col] : scalar_t(0);
        xq_s[i] = x;
        acc_s[i] = 0;
        sq[b] += x * x;
      }
    loader_parts(0, sq, red, warp, lane);
    if (t0 < t1) {
      scalar_t d[NX];
      wide_dots<MAXB>(xr[0], jr[0], xq_s, lt, d);
      loader_parts(1, d, red, warp, lane);
    }
    bar_sync(WD_PLANES);
  } else {
    xq_sq = __shfl_sync(0xffffffffu, exchange<NX>(0, red, xs, mbar, rank, lane), lane % MAXB);
    bar_arrive(WD_PLANES);
  }

  for (int t = t0; t < t1; t += NBUF) {
#pragma unroll
    for (int u = 0; u < NBUF; ++u) {  // row t + u sits in xr[u]
      const int row = t + u, n = row - t0 + 1;
      if (row >= t1) break;  // the same in every block of the cluster
      if (warp > 0) {
        const int next = (u + 1) % NBUF, ahead = (u + NBUF - 1) % NBUF;
        wide_load(xr[ahead], jr[ahead], a, row + NBUF - 1, t1, col0, c1);
        if (row + 1 < t1) {
          scalar_t d[NX];
          wide_dots<MAXB>(xr[next], jr[next], xq_s, lt, d);
          loader_parts(n + 1, d, red, warp, lane);
        }
        bar_sync(WD_PLANES + (n & 1));
        const scalar_t* pn = pl + (n & 1) * NX;
#pragma unroll
        for (int b = 0; b < MAXB; ++b) {
          const scalar_t cx = pn[b], cj = pn[MAXB + b];
#pragma unroll
          for (int k = 0; k < WD_COLS; ++k)
            acc_s[(b * WD_COLS + k) * WD_LOAD_THREADS + lt] += cx * xr[u][k] + cj * jr[u][k];
        }
      } else {
        scalar_t xts = 0, tj = 0, aet = 0;
        if (lane < B) {
          xts = a.xt_sq[row];
          tj = a.tja[row];
          aet = a.ae != nullptr ? a.ae[row] : scalar_t(0);
        }
        const scalar_t tot = exchange<NX>(n, red, xs, mbar, rank, lane);
        const scalar_t q = __shfl_down_sync(0xffffffffu, tot, MAXB);  // lane b: xq_b.ja
        if (lane < B) {
          scalar_t ep, cx, cj;
          plane_terms(tot, q, xq_sq, xts, tj, a.ae != nullptr, aet, true, cf, ep, cx, cj);
          pl[(n & 1) * NX + lane] = cx;
          pl[(n & 1) * NX + MAXB + lane] = cj;
          e_acc += ep;
          s_acc += cx;
        }
        bar_arrive(WD_PLANES + (n & 1));
      }
    }
  }

  // Past its last exchange no block touches another's shared memory; the
  // last cluster barrier keeps each block's until every block is there.
  if (warp > 0) cluster_wait();  // the first barrier's
  cluster_arrive_relaxed();
  scalar_t* dst = a.part + (size_t)g * B * (D + 2);
  if (warp > 0) {
#pragma unroll
    for (int b = 0; b < MAXB; ++b)
#pragma unroll
      for (int k = 0; k < WD_COLS; ++k) {
        const int col = col0 + k * WD_LOAD_THREADS;
        if (b < B && col < c1) dst[(size_t)b * (D + 2) + col] = acc_s[(b * WD_COLS + k) * WD_LOAD_THREADS + lt];
      }
  } else if (rank == 0 && lane < B) {
    dst[(size_t)lane * (D + 2) + D] = e_acc;
    dst[(size_t)lane * (D + 2) + D + 1] = s_acc;
  }
  cluster_wait();
}

// Whether the wide kernel takes B queries of width D: a slice of ceil(D /
// WD_CLUSTER) columns in WD_COLS a loader thread (ops/fused_predict.py:_wide_takes).
inline bool wide_takes(int B, int D) {
  return B >= 1 && B <= 4 && D >= 1 && (D + WD_CLUSTER - 1) / WD_CLUSTER <= WD_COLS * WD_LOAD_THREADS;
}

template <typename scalar_t, int MAXB>
void (*wide_kernel())(WideArgs<scalar_t>) {
  return fused_predict_kernel<scalar_t, Wide<MAXB>>;
}

template <typename scalar_t, int MAXB>
int launch_wide_b(const WideArgs<scalar_t>& a, int clusters, scalar_t* e_out, scalar_t* f_out, int device,
                  cudaStream_t st) {
  const auto kernel = wide_kernel<scalar_t, MAXB>();
  constexpr size_t smem = wide_smem<scalar_t, Wide<MAXB>>();
  cudaError_t err = allow_smem<scalar_t, 300 + MAXB>(reinterpret_cast<const void*>(kernel), smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<clusters * WD_CLUSTER, WD_THREADS, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<scalar_t, WD_REDUCE_RUNS><<<dim3((a.D + 1 + 31) / 32, a.B), WD_REDUCE_RUNS * 32, 0, st>>>(
      a.xq, a.part, a.B, a.D, clusters, e_out, f_out);
  return static_cast<int>(cudaGetLastError());
}

template <typename scalar_t>
int launch_wide(const void* xq, const void* xt, const void* ja, const void* xt_sq, const void* tja,
                const void* ae, double sig, int B, int T, int D, int clusters, void* part, void* e_out,
                void* f_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1 || T < 1 || !wide_takes(B, D)) return static_cast<int>(cudaErrorInvalidValue);
  const WideArgs<scalar_t> a{static_cast<const scalar_t*>(xq), static_cast<const scalar_t*>(xt),
                             static_cast<const scalar_t*>(ja), static_cast<const scalar_t*>(xt_sq),
                             static_cast<const scalar_t*>(tja), static_cast<const scalar_t*>(ae),
                             static_cast<scalar_t>(sig), B, T, D, (D + WD_CLUSTER - 1) / WD_CLUSTER,
                             static_cast<scalar_t*>(part)};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B == 1) return launch_wide_b<scalar_t, 1>(a, clusters, static_cast<scalar_t*>(e_out),
                                                static_cast<scalar_t*>(f_out), device, st);
  return launch_wide_b<scalar_t, 4>(a, clusters, static_cast<scalar_t*>(e_out), static_cast<scalar_t*>(f_out),
                                    device, st);
}

// The clusters of the B-query instance that the card runs at once, in *n.
template <typename scalar_t>
int wide_max_clusters(int B, int device, int* n) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B < 1 || B > 4) return static_cast<int>(cudaErrorInvalidValue);
  const void* kernel = B == 1 ? reinterpret_cast<const void*>(wide_kernel<scalar_t, 1>())
                              : reinterpret_cast<const void*>(wide_kernel<scalar_t, 4>());
  const size_t smem = B == 1 ? wide_smem<scalar_t, Wide<1>>() : wide_smem<scalar_t, Wide<4>>();
  err = B == 1 ? allow_smem<scalar_t, 301>(kernel, smem, device) : allow_smem<scalar_t, 304>(kernel, smem, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(WD_CLUSTER);
  config.blockDim = dim3(WD_THREADS);
  config.dynamicSmemBytes = smem;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(n, kernel, &config));
}

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers of
// contiguous row-major tensors; `ae` may be null. Each returns
// cudaGetLastError() after its launches (0 on success); the launches are
// asynchronous on `stream`, and nothing is allocated here.
extern "C" {

// Pass A: planes (B, 2 Tp), e_part and s_part (B, Tp / 64), Tp = T rounded up to 64.
int sgdml_planes_f32(const void* xq, const void* xt, const void* ja, const void* xt_sq,
                     const void* tja, const void* ae, double sig, int B, int T, int D,
                     void* planes, void* e_part, void* s_part, int device, void* stream) {
  return launch_planes<float>(xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, planes, e_part, s_part,
                              device, stream);
}

int sgdml_planes_f64(const void* xq, const void* xt, const void* ja, const void* xt_sq,
                     const void* tja, const void* ae, double sig, int B, int T, int D,
                     void* planes, void* e_part, void* s_part, int device, void* stream) {
  return launch_planes<double>(xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, planes, e_part, s_part,
                               device, stream);
}

// Pass B and its reduction: E_raw (B,) and F_d (B, D) from pass A's outputs;
// K = 2 Tp is cut into `splits` runs of `per` 16-deep steps (the last may be
// shorter), with scratch partial (splits, B, D).
int sgdml_forces_f32(const void* xq, const void* xt, const void* ja, const void* planes,
                     const void* e_part, const void* s_part, int B, int T, int D, int splits,
                     int per, void* partial, void* e_out, void* f_out, int device, void* stream) {
  return launch_forces<float>(xq, xt, ja, planes, e_part, s_part, B, T, D, splits, per, partial,
                              e_out, f_out, device, stream);
}

int sgdml_forces_f64(const void* xq, const void* xt, const void* ja, const void* planes,
                     const void* e_part, const void* s_part, int B, int T, int D, int splits,
                     int per, void* partial, void* e_out, void* f_out, int device, void* stream) {
  return launch_forces<double>(xq, xt, ja, planes, e_part, s_part, B, T, D, splits, per, partial,
                               e_out, f_out, device, stream);
}

// Both passes: E_raw (B,) and F_d (B, D), with `scratch` as launch_two_pass says.
int sgdml_two_pass_f32(const void* xq, const void* xt, const void* ja, const void* xt_sq,
                       const void* tja, const void* ae, double sig, int B, int T, int D,
                       int splits, int per, void* scratch, void* e_out, void* f_out, int device,
                       void* stream) {
  return launch_two_pass<float>(xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, splits, per, scratch,
                                e_out, f_out, device, stream);
}

int sgdml_two_pass_f64(const void* xq, const void* xt, const void* ja, const void* xt_sq,
                       const void* tja, const void* ae, double sig, int B, int T, int D,
                       int splits, int per, void* scratch, void* e_out, void* f_out, int device,
                       void* stream) {
  return launch_two_pass<double>(xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, splits, per, scratch,
                                 e_out, f_out, device, stream);
}

// Split T: E_raw (B,) and F_d (B, D) for B <= 16, the table rows cut into
// `blocks` runs of ceil(T / blocks); `part` is scratch of blocks x B x (D + 2)
// elements.
int sgdml_split_t_f32(const void* xq, const void* xt, const void* ja, const void* xt_sq,
                      const void* tja, const void* ae, double sig, int B, int T, int D, int blocks,
                      void* part, void* e_out, void* f_out, int device, void* stream) {
  return launch_split_t<float>(xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, blocks, part, e_out, f_out,
                               device, stream);
}

int sgdml_split_t_f64(const void* xq, const void* xt, const void* ja, const void* xt_sq,
                      const void* tja, const void* ae, double sig, int B, int T, int D, int blocks,
                      void* part, void* e_out, void* f_out, int device, void* stream) {
  return launch_split_t<double>(xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, blocks, part, e_out, f_out,
                                device, stream);
}

// One NVE step of MD on one geometry (N atoms, D = N (N - 1) / 2) against
// the centred tables: r, v, f (N x 3) advanced in place, E_raw (1) at the new
// positions; `blocks` split-T blocks with scratch part (blocks x (D + 2)),
// runs (32 x (D + 2)) and 33 unsigned tickets, zero before the first launch
// (each launch leaves them at zero).
int sgdml_md_step_f32(const void* xt, const void* ja, const void* xt_sq, const void* tja, const void* mu,
                      const void* inv_m, double sig, double std_, double dt, int N, int T, int D, int blocks,
                      void* r, void* v, void* f, void* part, void* runs, void* tickets, void* e_out, int device,
                      void* stream) {
  return launch_md_step<float>(xt, ja, xt_sq, tja, mu, inv_m, sig, std_, dt, N, T, D, blocks, r, v, f, part, runs,
                               tickets, e_out, device, stream);
}

int sgdml_md_step_f64(const void* xt, const void* ja, const void* xt_sq, const void* tja, const void* mu,
                      const void* inv_m, double sig, double std_, double dt, int N, int T, int D, int blocks,
                      void* r, void* v, void* f, void* part, void* runs, void* tickets, void* e_out, int device,
                      void* stream) {
  return launch_md_step<double>(xt, ja, xt_sq, tja, mu, inv_m, sig, std_, dt, N, T, D, blocks, r, v, f, part, runs,
                                tickets, e_out, device, stream);
}

// Wide: E_raw (B,) and F_d (B, D) for B <= 4 queries of width D up to
// 4 x 6 x 480 = 11,520, the table rows cut into `clusters` runs of T /
// clusters; `part` is scratch of clusters x B x (D + 2) elements.
int sgdml_wide_f32(const void* xq, const void* xt, const void* ja, const void* xt_sq, const void* tja,
                   const void* ae, double sig, int B, int T, int D, int clusters, void* part, void* e_out,
                   void* f_out, int device, void* stream) {
  return launch_wide<float>(xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, clusters, part, e_out, f_out, device,
                            stream);
}

int sgdml_wide_f64(const void* xq, const void* xt, const void* ja, const void* xt_sq, const void* tja,
                   const void* ae, double sig, int B, int T, int D, int clusters, void* part, void* e_out,
                   void* f_out, int device, void* stream) {
  return launch_wide<double>(xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, clusters, part, e_out, f_out, device,
                             stream);
}

// The wide kernel's clusters that run at once on the card for B queries, in *n.
int sgdml_wide_clusters_f32(int B, int device, int* n) { return wide_max_clusters<float>(B, device, n); }

int sgdml_wide_clusters_f64(int B, int device, int* n) { return wide_max_clusters<double>(B, device, n); }

const char* sgdml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
