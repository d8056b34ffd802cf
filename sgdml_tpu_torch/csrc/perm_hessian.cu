// The permutation-summed Hessian blocks of the GDML kernel matrix, written
// in place, for NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package leaves this tile to XLA
// (sgdml_tpu/ops/kernel.py:253-296, the permutation scan of
// _perm_summed_tile). The port ran it as some 15 PyTorch operations a
// permutation a tile, each writing an (I, T, 9 N^2) plane to device memory
// and reading it back, and then copied the tile into K through a permuted
// view. At the MD17 aspirin width (N = 21, M = 1000) that took 1.17 s of a
// 3.26 s training summed over a group of P = 6, and 0.18 s at P = 1, against
// a bound of 4.7 ms (PERF.md, section 6).
//
// For row geometry i, column geometry t and permutation p, with
// d = x_i - x_t^p, u5 = sqrt5 |d|, b = 5 exp(-u5/sig) / (3 sig^4) and
// cc = b (sig^2 + sig u5), the 3N x 3N block is
//
//   out[(m,a), (n,b)] = scale sum_p 5 b A[m,a] C[n,b] - cc G[(m,a), (n,b)]
//
// with A = J_i^T d, C = d^T J_t^p and the Jacobian Gram G = J_i^T J_t^p,
// written to out[i 3N + 3m + a, t 3N + 3n + b] of a strided 2-D view. The
// Jacobians are compressed: descriptor e of the pair (u, v), u > v, has the
// signs -1 at atom u and +1 at atom v, so every sum over descriptors is a sum
// over the N - 1 descriptors through one atom:
//
//   A[m,a]   = sum_{k != m} s(m,k) Jc_i[e(m,k), a] d[e(m,k)]
//   C[n,b]   = sum of Jc_t^p[g, b] d[g] over the N - 1 descriptors g whose
//              permuted pair holds n: the off-diagonal entries g_idx[p, r, n]
//              of column n, with the sign sgn[p, r, n] s(r, g)
//   G        = sgn[p, m, n] Jc_i[g, a] Jc_t^p[g, b],  g = g_idx[p, m, n],
//              where n != pi_p(m) (one descriptor); on the diagonal slot
//              n = pi_p(m) (diag_col), the sum over the N - 1 descriptors
//              through m, each signed -sgn[p, k, pi_p(m)]
//
// (ops/kernel.py: gram_maps; the identities hold for every permutation table
// that gram_maps accepts, N >= 3).
//
// What bounds it: the bytes of K. One (i, t) pair writes 9 N^2 values; the
// operations, about 81 D + 27 N^2 a (pair, permutation) block
// (benchmark/counts_sym.py), are a quarter to a half of the store time at
// P = 6 on the FP64 pipes and less at P = 1. So the design keeps everything
// but K on chip and writes K once, in its final row-major place:
//
//  * a block owns a run of TT column geometries and walks through a run of
//    row geometries one at a time; it stages the columns' permuted Jacobians
//    and the Gram tables once, for all its rows, and each row's tables as it
//    comes; it loops over the permutations in chunks of PC (all of them,
//    unless a chunk would not fit shared memory, as at wide molecules, where
//    the tables are read in place);
//  * per (column geometry, permutation) pair the block computes d, |d|, b,
//    cc, 5 b A, C and the diagonal-slot Gram once into shared memory: a warp
//    reduces |d|^2, a thread an atom sums A with the diagonal slot, another C;
//  * a thread sums the 3 x 3 block of one (column geometry, row atom, column
//    atom) over the permutations in registers, reading each gathered
//    Jacobian row once for nine values, into a slab of rows in shared
//    memory; the block then stores the slab's rows, each a contiguous run of
//    TT 3N values of K, so that neighbouring threads store neighbouring
//    values;
//  * no atomics: a block owns its outputs (a later chunk, where P needs
//    more than one, adds to what the block's earlier chunk stored), so the
//    bits repeat from run to run.
//
// FP64 or FP32 FMAs (true f32, no TF32).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int PH_THREADS = 256;
// Shared memory a block may take: two blocks an SM (227 KB).
constexpr size_t PH_SMEM_BUDGET = 113 * 1024;
// Row geometries a block walks through, one at a time, against its columns.
constexpr int PH_ROWS = 16;
// Column geometries a block at most.
constexpr int PH_MAX_TT = 8;

__device__ __forceinline__ float ph_exp(float x) { return expf(x); }
__device__ __forceinline__ double ph_exp(double x) { return exp(x); }
__device__ __forceinline__ float ph_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double ph_sqrt(double x) { return sqrt(x); }

template <typename scalar_t>
__device__ __forceinline__ scalar_t ph_warp_sum(scalar_t v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Descriptor of the atom pair (m, k), m != k, in tril order.
__device__ __forceinline__ int pair_index(int m, int k) {
  return m > k ? m * (m - 1) / 2 + k : k * (k - 1) / 2 + m;
}

// The sign of atom r in descriptor g, which holds r: -1 where r is the
// pair's larger atom.
__device__ __forceinline__ int atom_sign(int g, int r) { return g < r * (r + 1) / 2 ? -1 : 1; }

// Per (column geometry, permutation) pair of a chunk: 5 b A (3N), C (3N),
// the diagonal-slot Gram (9N), 5 b and cc.
__host__ __device__ __forceinline__ int res_stride(int N) { return 15 * N + 2; }

struct Plan {
  int tt, pc, mb;  // column geometries a block, permutations a chunk, row atoms a slab
  bool staged;     // column and row tables in shared memory
  size_t smem;     // bytes of dynamic shared memory
};

// Shared memory, in this order: staged, the chunk's column Jacobians (C 3D)
// and d (C D) for the C = tt pc pairs, the row's descriptor and Jacobian
// (4D); always, the pairs' results (C res_stride) and the output slab (mb 3 x
// tt 3N); staged, the chunk's signed Gram indices (pc N^2) and diagonal
// columns (pc N) as ints.
template <typename scalar_t>
size_t smem_bytes(int N, int D, bool staged, int tt, int pc, int mb) {
  const size_t c = static_cast<size_t>(tt) * pc;
  size_t vals = c * res_stride(N) + static_cast<size_t>(mb) * 3 * tt * 3 * N;
  size_t ints = 0;
  if (staged) {
    vals += c * 4 * D + 4 * static_cast<size_t>(D);
    ints = static_cast<size_t>(pc) * N * (N + 1);
  }
  return vals * sizeof(scalar_t) + ints * sizeof(int);
}

// The block's shape: about 128 / N (column geometry, permutation) pairs, so
// that the per-atom sums (two a pair and atom) keep the block's threads busy;
// the slab's row atoms so that its (row atom, column atom) pairs fill two
// rounds of them; then the largest that fits the budget, its tables staged
// where they fit.
template <typename scalar_t>
Plan plan(int N, int D, int P) {
  const int want = 128 / N < 1 ? 1 : 128 / N;
  Plan pl;
  pl.pc = P < want ? P : want;
  pl.tt = want / pl.pc < 1 ? 1 : (want / pl.pc > PH_MAX_TT ? PH_MAX_TT : want / pl.pc);
  const int mb0 = 2 * PH_THREADS / (pl.tt * N);
  pl.mb = mb0 < 1 ? 1 : (mb0 > N ? N : mb0);
  for (int staged = 1; staged >= 0; --staged) {
    Plan q = pl;
    q.staged = staged;
    while (smem_bytes<scalar_t>(N, D, q.staged, q.tt, q.pc, q.mb) > PH_SMEM_BUDGET) {
      if (q.tt > 1) --q.tt;
      else if (q.mb > 1) --q.mb;
      else if (q.pc > 1) --q.pc;
      else break;
    }
    q.smem = smem_bytes<scalar_t>(N, D, q.staged, q.tt, q.pc, q.mb);
    if (q.smem <= PH_SMEM_BUDGET) return q;
  }
  pl.staged = false;
  pl.smem = smem_bytes<scalar_t>(N, D, false, 1, 1, 1);
  return pl;
}

template <typename scalar_t>
struct PermHessian {
  const scalar_t* x;    // (I, D) row descriptors
  const scalar_t* jc;   // (I, D, 3) row compressed Jacobians
  const scalar_t* xp;   // (T, P, D) permuted column descriptors
  const scalar_t* jcp;  // (T, P, D, 3) permuted column Jacobians
  const int* gs;        // (P, N, N): sgn (g_idx + 1), 0 on the diagonal slots
  const int* pim;       // (P, N): pi_p(m), the diagonal slot of row atom m
  scalar_t sig, scale;
  int N, D, P, I, T;
  Plan pl;
  scalar_t* out;  // row i 3N + (m,a), column t 3N + (n,b) at out[row ld + col]
  int64_t ld;
};

template <typename scalar_t>
__global__ void __launch_bounds__(PH_THREADS, 2) perm_hessian_kernel(const PermHessian<scalar_t> k) {
  extern __shared__ __align__(16) unsigned char ph_smem[];
  const int N = k.N, D = k.D, P = k.P, N3 = 3 * N, rs = res_stride(N);
  const bool staged = k.pl.staged;
  const int runs_t = (k.T + k.pl.tt - 1) / k.pl.tt;
  const int t0 = (blockIdx.x % runs_t) * k.pl.tt;
  const int tt = min(k.pl.tt, k.T - t0);
  const int i_begin = (blockIdx.x / runs_t) * PH_ROWS, i_end = min(k.I, i_begin + PH_ROWS);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, warps = blockDim.x / 32;
  const scalar_t sqrt5 = scalar_t(2.23606797749978969640917366873127623544);

  // Shared memory, as smem_bytes lays it out for the plan's shape.
  const size_t cmax = static_cast<size_t>(k.pl.tt) * k.pl.pc;
  scalar_t* sh = reinterpret_cast<scalar_t*>(ph_smem);
  scalar_t* jt_s = sh;
  scalar_t* dd_s = jt_s + (staged ? cmax * 3 * D : 0);
  scalar_t* xi_s = dd_s + (staged ? cmax * D : 0);
  scalar_t* ji_s = xi_s + (staged ? D : 0);
  scalar_t* res = ji_s + (staged ? 3 * D : 0);
  scalar_t* slab = res + cmax * rs;
  int* gs_s = reinterpret_cast<int*>(slab + static_cast<size_t>(k.pl.mb) * 3 * k.pl.tt * N3);
  int* pim_s = gs_s + static_cast<size_t>(k.pl.pc) * N * N;

  for (int p0 = 0; p0 < P; p0 += k.pl.pc) {
    const int pc = min(k.pl.pc, P - p0), pairs = tt * pc;
    // Pair c = (column tl = c / pc, permutation p0 + c % pc) of the chunk.
    auto col_row = [&](int c) { return static_cast<size_t>(t0 + c / pc) * P + p0 + c % pc; };
    const int* gs = staged ? gs_s : k.gs + static_cast<size_t>(p0) * N * N;
    const int* pim = staged ? pim_s : k.pim + static_cast<size_t>(p0) * N;
    if (staged) {
      for (int c = 0; c < pairs; ++c) {
        const scalar_t* src = k.jcp + col_row(c) * 3 * D;
        for (int e = threadIdx.x; e < 3 * D; e += blockDim.x) jt_s[static_cast<size_t>(c) * 3 * D + e] = src[e];
      }
      for (int e = threadIdx.x; e < pc * N * N; e += blockDim.x) gs_s[e] = k.gs[static_cast<size_t>(p0) * N * N + e];
      for (int e = threadIdx.x; e < pc * N; e += blockDim.x) pim_s[e] = k.pim[static_cast<size_t>(p0) * N + e];
    }
    auto jt_of = [&](int c) -> const scalar_t* {
      return staged ? jt_s + static_cast<size_t>(c) * 3 * D : k.jcp + col_row(c) * 3 * D;
    };

    for (int i = i_begin; i < i_end; ++i) {
      const scalar_t* xi = k.x + static_cast<size_t>(i) * D;
      const scalar_t* ji = k.jc + static_cast<size_t>(i) * 3 * D;
      if (staged) {
        for (int e = threadIdx.x; e < D; e += blockDim.x) xi_s[e] = xi[e];
        for (int e = threadIdx.x; e < 3 * D; e += blockDim.x) ji_s[e] = ji[e];
        xi = xi_s;
        ji = ji_s;
      }
      __syncthreads();
      // d = x_i - x_t^p of pair c at descriptor e.
      auto dd_of = [&](int c, int e) -> scalar_t {
        return staged ? dd_s[static_cast<size_t>(c) * D + e] : xi[e] - k.xp[col_row(c) * D + e];
      };

      // d (staged), |d|^2, 5 b and cc: a warp a pair.
      for (int c = warp; c < pairs; c += warps) {
        const scalar_t* xt = k.xp + col_row(c) * D;
        scalar_t u2 = 0;
        for (int e = lane; e < D; e += 32) {
          const scalar_t dd = xi[e] - xt[e];
          if (staged) dd_s[static_cast<size_t>(c) * D + e] = dd;
          u2 += dd * dd;
        }
        u2 = ph_warp_sum(u2);
        if (lane == 0) {
          const scalar_t u5 = sqrt5 * ph_sqrt(u2 > scalar_t(0) ? u2 : scalar_t(0));
          const scalar_t b = scalar_t(5) * ph_exp(-u5 / k.sig) / (scalar_t(3) * k.sig * k.sig * k.sig * k.sig);
          res[c * rs + 15 * N] = scalar_t(5) * b;
          res[c * rs + 15 * N + 1] = b * (k.sig * k.sig + k.sig * u5);
        }
      }
      __syncthreads();

      // The per-atom sums of each pair: a thread sums 5 b A and the
      // diagonal-slot Gram of row atom m, another C of column atom m.
      for (int w = threadIdx.x; w < 2 * pairs * N; w += blockDim.x) {
        const bool col_side = w >= pairs * N;
        const int w2 = col_side ? w - pairs * N : w;
        const int c = w2 / N, m = w2 - c * N, pl = c % pc;
        const scalar_t* jt = jt_of(c);
        const int* gs_p = gs + pl * N * N;
        scalar_t* r_ = res + c * rs;
        if (!col_side) {
          const int pm = pim[pl * N + m];
          scalar_t a0 = 0, a1 = 0, a2 = 0;
          scalar_t t2[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
          for (int q = 0; q < N; ++q) {
            if (q == m) continue;
            const int e = pair_index(m, q);
            const scalar_t dd = dd_of(c, e);
            const scalar_t w_a = m < q ? dd : -dd;
            const scalar_t j0 = ji[3 * e], j1 = ji[3 * e + 1], j2 = ji[3 * e + 2];
            const scalar_t q0 = jt[3 * e], q1 = jt[3 * e + 1], q2 = jt[3 * e + 2];
            a0 += w_a * j0;
            a1 += w_a * j1;
            a2 += w_a * j2;
            // The diagonal slot's sign: -sgn[p, q, pi_p(m)].
            const scalar_t v0 = gs_p[q * N + pm] > 0 ? -j0 : j0;
            const scalar_t v1 = gs_p[q * N + pm] > 0 ? -j1 : j1;
            const scalar_t v2 = gs_p[q * N + pm] > 0 ? -j2 : j2;
            t2[0] += v0 * q0; t2[1] += v0 * q1; t2[2] += v0 * q2;
            t2[3] += v1 * q0; t2[4] += v1 * q1; t2[5] += v1 * q2;
            t2[6] += v2 * q0; t2[7] += v2 * q1; t2[8] += v2 * q2;
          }
          const scalar_t b5 = r_[15 * N];
          r_[3 * m] = b5 * a0;
          r_[3 * m + 1] = b5 * a1;
          r_[3 * m + 2] = b5 * a2;
#pragma unroll
          for (int e = 0; e < 9; ++e) r_[6 * N + 9 * m + e] = t2[e];
        } else {
          scalar_t c0 = 0, c1 = 0, c2 = 0;
          for (int r = 0; r < N; ++r) {
            const int v = gs_p[r * N + m];
            if (v == 0) continue;  // the diagonal slot of row atom r
            const int g = (v > 0 ? v : -v) - 1;
            const scalar_t dd = dd_of(c, g);
            const scalar_t w_c = (v > 0) == (atom_sign(g, r) > 0) ? dd : -dd;
            c0 += w_c * jt[3 * g];
            c1 += w_c * jt[3 * g + 1];
            c2 += w_c * jt[3 * g + 2];
          }
          r_[N3 + 3 * m] = c0;
          r_[N3 + 3 * m + 1] = c1;
          r_[N3 + 3 * m + 2] = c2;
        }
      }
      __syncthreads();

      // The outputs, a slab of row atoms at a time: a thread sums the 3 x 3
      // block of one (column geometry, row atom, column atom) over the
      // chunk into the slab, then the block stores the slab's rows, each a
      // contiguous run of tt 3N values of K.
      const int ncols = tt * N3;
      for (int m0 = 0; m0 < N; m0 += k.pl.mb) {
        const int mbs = min(k.pl.mb, N - m0);
        for (int w = threadIdx.x; w < tt * mbs * N; w += blockDim.x) {
          const int tl = w / (mbs * N), rem = w - tl * mbs * N, ml = rem / N, n = rem - ml * N, m = m0 + ml;
          scalar_t acc[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
          for (int pl = 0; pl < pc; ++pl) {
            const int c = tl * pc + pl;
            const scalar_t* r_ = res + c * rs;
            const scalar_t cc = r_[15 * N + 1];
            const scalar_t a5[3] = {r_[3 * m], r_[3 * m + 1], r_[3 * m + 2]};
            const scalar_t cn[3] = {r_[N3 + 3 * n], r_[N3 + 3 * n + 1], r_[N3 + 3 * n + 2]};
            const int v = gs[pl * N * N + m * N + n];
            if (v != 0) {
              const int g = (v > 0 ? v : -v) - 1;
              const scalar_t s = v > 0 ? cc : -cc;
              const scalar_t* jt = jt_of(c);
              const scalar_t gi[3] = {s * ji[3 * g], s * ji[3 * g + 1], s * ji[3 * g + 2]};
              const scalar_t gt[3] = {jt[3 * g], jt[3 * g + 1], jt[3 * g + 2]};
#pragma unroll
              for (int al = 0; al < 3; ++al)
#pragma unroll
                for (int be = 0; be < 3; ++be) acc[3 * al + be] += a5[al] * cn[be] - gi[al] * gt[be];
            } else {
              const scalar_t* t2 = r_ + 6 * N + 9 * m;
#pragma unroll
              for (int al = 0; al < 3; ++al)
#pragma unroll
                for (int be = 0; be < 3; ++be) acc[3 * al + be] += a5[al] * cn[be] - cc * t2[3 * al + be];
            }
          }
          scalar_t* o = slab + static_cast<size_t>(3 * ml) * ncols + tl * N3 + 3 * n;
#pragma unroll
          for (int al = 0; al < 3; ++al)
#pragma unroll
            for (int be = 0; be < 3; ++be) o[static_cast<size_t>(al) * ncols + be] = acc[3 * al + be];
        }
        __syncthreads();
        // Rows i 3N + 3 m0 ... of K, columns t0 3N ...: contiguous runs.
        const int rows = 3 * mbs;
        int row = threadIdx.x / ncols, col = threadIdx.x - row * ncols;
        const int step_rows = blockDim.x / ncols, step_cols = blockDim.x - step_rows * ncols;
        for (; row < rows;) {
          scalar_t* dst = k.out + (static_cast<size_t>(i) * N3 + 3 * m0 + row) * k.ld + static_cast<size_t>(t0) * N3 + col;
          const scalar_t v = k.scale * slab[static_cast<size_t>(row) * ncols + col];
          *dst = p0 == 0 ? v : *dst + v;
          row += step_rows;
          col += step_cols;
          if (col >= ncols) {
            col -= ncols;
            ++row;
          }
        }
        __syncthreads();
      }
    }
  }
}

template <typename scalar_t>
cudaError_t ph_allow_smem(int device) {
  constexpr int kDevices = 64;
  static bool done[kDevices] = {};
  if (device >= 0 && device < kDevices && done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(perm_hessian_kernel<scalar_t>),
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(PH_SMEM_BUDGET));
  if (err == cudaSuccess && device >= 0 && device < kDevices) done[device] = true;
  return err;
}

template <typename scalar_t>
int launch_perm_hessian(const void* x, const void* jc, const void* xp, const void* jcp, const void* gs,
                        const void* pim, double sig, double scale, int N, int P, int I, int T, void* out,
                        int64_t ld, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int D = N * (N - 1) / 2;
  PermHessian<scalar_t> k;
  k.pl = plan<scalar_t>(N, D, P);
  if (N < 3 || k.pl.smem > PH_SMEM_BUDGET) return static_cast<int>(cudaErrorInvalidValue);
  err = ph_allow_smem<scalar_t>(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  k.x = static_cast<const scalar_t*>(x);
  k.jc = static_cast<const scalar_t*>(jc);
  k.xp = static_cast<const scalar_t*>(xp);
  k.jcp = static_cast<const scalar_t*>(jcp);
  k.gs = static_cast<const int*>(gs);
  k.pim = static_cast<const int*>(pim);
  k.sig = static_cast<scalar_t>(sig);
  k.scale = static_cast<scalar_t>(scale);
  k.N = N;
  k.D = D;
  k.P = P;
  k.I = I;
  k.T = T;
  k.out = static_cast<scalar_t*>(out);
  k.ld = ld;
  const long long blocks = static_cast<long long>((T + k.pl.tt - 1) / k.pl.tt) * ((I + PH_ROWS - 1) / PH_ROWS);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  perm_hessian_kernel<scalar_t><<<static_cast<unsigned>(blocks), PH_THREADS, k.pl.smem,
                                  static_cast<cudaStream_t>(stream)>>>(k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface, bound with ctypes (as csrc/fused_predict.cu's). x (I, D)
// and jc (I, D, 3) are the row geometries' tables, xp (T, P, D) and jcp (T, P,
// D, 3) the column geometries' permuted tables, gs (P, N, N) the signed Gram
// index sgn (g_idx + 1) and pim (P, N) the diagonal column of
// ops/kernel.py:gram_maps, as int32, all contiguous on the device; out points
// at the block's first value of a row-major view with leading dimension ld.
// Writes scale times the permutation-summed blocks of the I x T geometry
// pairs; returns cudaGetLastError() after the launch (0 on success),
// asynchronous on `stream`, nothing allocated.
extern "C" {

int sgdml_perm_hessian_f32(const void* x, const void* jc, const void* xp, const void* jcp, const void* gs,
                           const void* pim, double sig, double scale, int N, int P, int I, int T, void* out,
                           int64_t ld, int device, void* stream) {
  return launch_perm_hessian<float>(x, jc, xp, jcp, gs, pim, sig, scale, N, P, I, T, out, ld, device, stream);
}

int sgdml_perm_hessian_f64(const void* x, const void* jc, const void* xp, const void* jcp, const void* gs,
                           const void* pim, double sig, double scale, int N, int P, int I, int T, void* out,
                           int64_t ld, int device, void* stream) {
  return launch_perm_hessian<double>(x, jc, xp, jcp, gs, pim, sig, scale, N, P, I, T, out, ld, device, stream);
}

}  // extern "C"
