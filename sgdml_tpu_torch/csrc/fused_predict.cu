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
// What bounds it on this card: four B x T x D products, 8 B T D flop (about
// 10 T D flop per geometry with the planes). At D = 1770 (AT-AT width) that
// is compute: the (B, T) planes never leave the chip, so device-memory
// traffic is only the tables, re-read per block from L2. At D = 36 (ethanol
// width) each geometry needs ~0.3 MFLOP, and small requests are bound by
// the launch and by the table re-reads. This first version stays far from
// the compute bound at D = 1770: with one block per 16 query rows, small
// batches fill few of the 132 SMs, and each shared-memory load in the inner
// loops feeds one FMA (measurements in PERF.md).
//
// What the design does about it (simple and correct first):
//  * The TPU's sequential table axis becomes a loop inside the block. A block
//    owns TB query rows and walks all table tiles itself, so nothing carries
//    over between blocks, there are no atomics, and the result is the same
//    from run to run.
//  * D is tiled. The gram/a phase streams D in DK-wide chunks through shared
//    memory; the force phase accumulates into the block's own rows of F_d in
//    device memory (a TB x D accumulator does not fit on chip at D = 1770 in
//    f64). No padding: ragged B, T and D edges are masked by bounds.
//  * The (TB, TT) coefficient planes live in shared memory and registers only.
//  * Plain FP32 or native FP64 fused multiply-adds; no tensor cores, no TF32.
// Each warp owns two query rows for the whole kernel, so the row sums of the
// planes are warp shuffles and need no shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int TB = 16;        // query rows per block
constexpr int TT = 32;        // table rows per tile (one per lane)
constexpr int DK = 32;        // descriptor columns per shared-memory chunk
constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
static_assert(TB == 2 * NWARPS, "each warp owns two query rows");
static_assert(TT == 32 && DK == 32, "lanes index table rows and columns");

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dsqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double dsqrt(double x) { return sqrt(x); }

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

  const scalar_t sqrt5 = scalar_t(2.23606797749978969640917366873127623544);
  const scalar_t c_b1 = scalar_t(5) / (scalar_t(3) * sig * sig * sig);
  const scalar_t c_w1 = scalar_t(5) / sig;

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

    // Coefficient planes; a table row past T gets zero weight everywhere.
    const int t = t0 + lane;
    const bool t_ok = t < T;
    const scalar_t xts = t_ok ? xt_sq[t] : scalar_t(0);
    const scalar_t tj = t_ok ? tja[t] : scalar_t(0);
    const scalar_t aet = (ae != nullptr && t_ok) ? ae[t] : scalar_t(0);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      scalar_t u2 = xq_sq[r] - scalar_t(2) * g[r] + xts;
      u2 = u2 > scalar_t(0) ? u2 : scalar_t(0);
      const scalar_t u5 = sqrt5 * dsqrt(u2);
      const scalar_t ex = t_ok ? dexp(-u5 / sig) : scalar_t(0);
      const scalar_t b1 = c_b1 * ex;
      const scalar_t w2 = b1 * (u5 + sig);
      const scalar_t a = q[r] - tj;
      scalar_t ep = a * w2;
      scalar_t cx = a * b1 * c_w1;
      if (ae != nullptr) {
        const scalar_t k_ee = (scalar_t(1) + (u5 / sig) * (scalar_t(1) + u5 / (scalar_t(3) * sig))) * ex;
        ep += k_ee * aet;
        cx += w2 * aet;
      }
      cx_s[rows[r]][lane] = cx;
      cj_s[rows[r]][lane] = w2;
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

}  // namespace

// Plain C interface, bound with ctypes. Pointers are device pointers of
// contiguous row-major tensors; `ae` may be null. Returns cudaGetLastError()
// after the launch (0 on success). The launch is asynchronous on `stream`.
extern "C" {

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

const char* sgdml_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
