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
// the (B, T) coefficient planes, which are 1/D of that work. Two routes, chosen
// by D in ops/fused_predict.py:route (measurements in PERF.md):
//
//  * One pass, for narrow descriptors (ethanol, D = 36). The (B, T) planes
//    never leave the chip: a block owns TB query rows and walks all table
//    tiles itself, so nothing carries over between blocks, there are no
//    atomics, and the result is the same from run to run. One launch per
//    call, which is what MD on small molecules needs. Plain FP32 or FP64
//    FMAs; each shared-memory load feeds one FMA, and small batches fill few
//    SMs, so it does not scale to wide descriptors.
//  * Two passes, for wide descriptors (AT-AT, D = 1770). At that width a
//    block's (rows, D) force accumulator does not fit on chip (64 x 1770 f64
//    is 906 KB), while writing the planes to device memory costs ~1/D of the
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

// ===========================================================================
// One pass (narrow descriptors).
// ===========================================================================

constexpr int TB = 16;        // query rows per block
constexpr int TT = 32;        // table rows per tile (one per lane)
constexpr int DK = 32;        // descriptor columns per shared-memory chunk
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
static_assert(TB == 2 * NWARPS, "each warp owns two query rows");
static_assert(TT == 32 && DK == 32, "lanes index table rows and columns");

template <typename scalar_t>
__device__ __forceinline__ scalar_t warp_sum(scalar_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copy rows [r0, r0 + R) x columns [k0, k0 + DK) of a (n_rows, D) row-major
// matrix into dst[R][DK + 1], with zeros outside the matrix.
template <typename scalar_t, int R>
__device__ __forceinline__ void load_chunk(scalar_t (*dst)[DK + 1],
                                           const scalar_t* __restrict__ src,
                                           int r0, int n_rows, int k0, int D) {
  for (int i = threadIdx.x; i < R * DK; i += NTHREADS) {
    const int r = i / DK, c = i % DK;
    const int row = r0 + r, k = k0 + c;
    dst[r][c] = (row < n_rows && k < D) ? src[(size_t)row * D + k] : scalar_t(0);
  }
}

// Each warp owns two query rows for the whole kernel, so the row sums of the
// planes are warp shuffles and need no shared memory.
template <typename scalar_t>
__global__ void __launch_bounds__(NTHREADS)
fused_predict_kernel(const scalar_t* __restrict__ xq, const scalar_t* __restrict__ xt,
                     const scalar_t* __restrict__ ja, const scalar_t* __restrict__ xt_sq,
                     const scalar_t* __restrict__ tja, const scalar_t* __restrict__ ae,
                     const scalar_t sig, const int B, const int T, const int D,
                     scalar_t* __restrict__ e_out, scalar_t* __restrict__ f_out) {
  __shared__ scalar_t xq_s[TB][DK + 1];
  __shared__ scalar_t xt_s[TT][DK + 1];
  __shared__ scalar_t ja_s[TT][DK + 1];
  __shared__ scalar_t cx_s[TB][TT + 1];  // w1 + w3: weight of -xt (and, summed, of +xq)
  __shared__ scalar_t cj_s[TB][TT + 1];  // w2: weight of -ja

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int b0 = blockIdx.x * TB;
  const int rows[2] = {warp, warp + NWARPS};  // this warp's rows within the block
  const Coeffs<scalar_t> cf = coeffs(sig);

  // |xq|^2 of this warp's rows; every lane ends with the full sum.
  scalar_t xq_sq[2], e_acc[2] = {0, 0}, s_acc[2] = {0, 0};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int b = b0 + rows[r];
    scalar_t acc = 0;
    if (b < B)
      for (int k = lane; k < D; k += 32) {
        const scalar_t v = xq[(size_t)b * D + k];
        acc += v * v;
      }
    xq_sq[r] = warp_sum(acc);
  }

  for (int t0 = 0; t0 < T; t0 += TT) {
    // Phase 1: gram = xq.xt and xq.ja for the (TB, TT) tile; lane = table row.
    scalar_t g[2] = {0, 0}, q[2] = {0, 0};
    for (int k0 = 0; k0 < D; k0 += DK) {
      load_chunk<scalar_t, TB>(xq_s, xq, b0, B, k0, D);
      load_chunk<scalar_t, TT>(xt_s, xt, t0, T, k0, D);
      load_chunk<scalar_t, TT>(ja_s, ja, t0, T, k0, D);
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < DK; ++c) {
        const scalar_t vt = xt_s[lane][c], vj = ja_s[lane][c];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const scalar_t vq = xq_s[rows[r]][c];
          g[r] += vq * vt;
          q[r] += vq * vj;
        }
      }
      __syncthreads();
    }

    // Coefficient planes.
    const int t = t0 + lane;
    const bool t_ok = t < T;
    const scalar_t xts = t_ok ? xt_sq[t] : scalar_t(0);
    const scalar_t tj = t_ok ? tja[t] : scalar_t(0);
    const scalar_t aet = (ae != nullptr && t_ok) ? ae[t] : scalar_t(0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      scalar_t ep, cx, cj;
      plane_terms(g[r], q[r], xq_sq[r], xts, tj, ae != nullptr, aet, t_ok, cf, ep, cx, cj);
      cx_s[rows[r]][lane] = cx;
      cj_s[rows[r]][lane] = cj;
      e_acc[r] += warp_sum(ep);
      s_acc[r] += warp_sum(cx);
    }
    __syncthreads();

    // Phase 2: F_d[b, k] -= sum_t cx[b, t] xt[t, k] + cj[b, t] ja[t, k]; lane = column.
    for (int k0 = 0; k0 < D; k0 += DK) {
      load_chunk<scalar_t, TT>(xt_s, xt, t0, T, k0, D);
      load_chunk<scalar_t, TT>(ja_s, ja, t0, T, k0, D);
      __syncthreads();
      scalar_t f[2] = {0, 0};
#pragma unroll 8
      for (int tt = 0; tt < TT; ++tt) {
        const scalar_t vt = xt_s[tt][lane], vj = ja_s[tt][lane];
#pragma unroll
        for (int r = 0; r < 2; ++r) f[r] += cx_s[rows[r]][tt] * vt + cj_s[rows[r]][tt] * vj;
      }
      const int k = k0 + lane;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int b = b0 + rows[r];
        if (b < B && k < D) {
          scalar_t* dst = f_out + (size_t)b * D + k;
          *dst = (t0 == 0 ? scalar_t(0) : *dst) - f[r];  // the first tile initialises
        }
      }
      __syncthreads();
    }
  }

  // F_d += (sum_t cx) xq, and the energies. The same thread wrote each
  // element of F_d above (k = k0 + lane), so no barrier is needed.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int b = b0 + rows[r];
    if (b >= B) continue;
    for (int k = lane; k < D; k += 32) f_out[(size_t)b * D + k] += s_acc[r] * xq[(size_t)b * D + k];
    if (lane == 0) e_out[b] = e_acc[r];
  }
}

template <typename scalar_t>
int launch(const void* xq, const void* xt, const void* ja, const void* xt_sq,
           const void* tja, const void* ae, double sig, int B, int T, int D,
           void* e_out, void* f_out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + TB - 1) / TB);
  fused_predict_kernel<scalar_t><<<grid, NTHREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const scalar_t*>(xq), static_cast<const scalar_t*>(xt),
      static_cast<const scalar_t*>(ja), static_cast<const scalar_t*>(xt_sq),
      static_cast<const scalar_t*>(tja), static_cast<const scalar_t*>(ae),
      static_cast<scalar_t>(sig), B, T, D,
      static_cast<scalar_t*>(e_out), static_cast<scalar_t*>(f_out));
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// Two passes (wide descriptors).
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

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers of
// contiguous row-major tensors; `ae` may be null. Each returns
// cudaGetLastError() after its launches (0 on success); the launches are
// asynchronous on `stream`, and nothing is allocated here.
extern "C" {

// One pass: E_raw (B,) and F_d (B, D).
int sgdml_fused_predict_f32(const void* xq, const void* xt, const void* ja,
                            const void* xt_sq, const void* tja, const void* ae,
                            double sig, int B, int T, int D, void* e_out,
                            void* f_out, int device, void* stream) {
  return launch<float>(xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, e_out, f_out, device, stream);
}

int sgdml_fused_predict_f64(const void* xq, const void* xt, const void* ja,
                            const void* xt_sq, const void* tja, const void* ae,
                            double sig, int B, int T, int D, void* e_out,
                            void* f_out, int device, void* stream) {
  return launch<double>(xq, xt, ja, xt_sq, tja, ae, sig, B, T, D, e_out, f_out, device, stream);
}

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

const char* sgdml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
