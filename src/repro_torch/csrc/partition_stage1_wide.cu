// Stage 1 of the partition method on the interleaved layout: per-block
// spikes and reduced rows, with the systems on the fastest axis.
//
// Replaces the TPU kernel src/repro/kernels/partition_stage1/stage1.py
// (_stage1_kernel_wide, through stage1_tiled_wide) together with the
// reduced-row assembly of src/repro/kernels/partition_stage1/ops.py
// (_stage1_impl_wide).
//
// Operands are (P, m, B): row r of block p of system i is at
// (p*m + r)*B + i. Outputs: spikes y, v, w of shape (P, m-1, B) and the
// reduced rows red_dl/red_d/red_du/red_b of shape (P, B).
//
// Bound: bytes. Each (block, system) pair reads 4m values and writes
// 3(m-1)+4, with about 10 flops per row, far below the card's fp32 and fp64
// rates for what 3.35 TB/s delivers. The recurrence is serial in m, but the
// P*B (block, system) pairs are independent.
//
// Design: one thread per (block p, system i), with i fastest across
// threads, so a warp's 32 threads read 32 adjacent values of one row: every
// load and store is coalesced (the system-major kernel's threads read
// addresses m apart). The thread walks its block's m rows as the
// system-major kernel does: a forward elimination shared by the three
// right-hand sides, then back substitution, with the modified diagonal kept
// in the w output's own slots during the forward sweep, so no scratch buffer
// is needed. A second kernel on the same stream assembles the reduced rows,
// since each needs block p+1's first spike row, which another thread
// computes. That shift runs along p and is zero at p = P-1, which is exact
// for ragged batches: a system's padding blocks are identity blocks with
// zero spikes, and its last real row has no coupling to them. The TPU
// kernel's row and lane padding (block_rows = 32, block_b = 256) is not
// carried over: a thread past the last pair returns.
#include "common.cuh"

template <typename T>
__global__ void stage1_wide_spikes_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                                          const T* __restrict__ du, const T* __restrict__ b,
                                          T* __restrict__ y, T* __restrict__ v,
                                          T* __restrict__ w, long long nblocks, long long nsys,
                                          int m) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= nblocks * nsys) return;
  const long long p = g / nsys;
  const long long i = g - p * nsys;
  const int mi = m - 1;  // interior rows
  const long long B = nsys;
  // Row r of this block is at in0 + r*B; interior row k of its spikes at
  // out0 + k*B.
  const long long in0 = p * m * B + i;
  const long long out0 = p * mi * B + i;
  const T* dlp = dl + in0;
  const T* dp = d + in0;
  const T* dup = du + in0;
  const T* bp = b + in0;
  T* yp = y + out0;
  T* vp = v + out0;
  T* wp = w + out0;  // holds dhat until the backward sweep overwrites it

  // Forward elimination, shared factorization; spikes seeded per their RHS.
  T dhat = dp[0];
  T yc = bp[0];
  T vc = dlp[0];
  wp[0] = dhat;
  yp[0] = yc;
  vp[0] = vc;
  for (int k = 1; k < mi; ++k) {
    const long long o = k * B;
    const T wgt = dlp[o] / dhat;
    dhat = dp[o] - wgt * dup[o - B];
    yc = bp[o] - wgt * yc;
    vc = -wgt * vc;
    wp[o] = dhat;
    yp[o] = yc;
    vp[o] = vc;
  }

  // Backward substitution, all three spikes per step, in place.
  const long long last = static_cast<long long>(mi - 1) * B;
  yc = yc / dhat;
  vc = vc / dhat;
  // The w spike's forward image is du[m-2] e_last, so its seed is direct.
  T wc = dup[last] / dhat;
  yp[last] = yc;
  vp[last] = vc;
  wp[last] = wc;
  for (int k = mi - 2; k >= 0; --k) {
    const long long o = k * B;
    const T du_k = dup[o];
    const T dhat_k = wp[o];
    yc = (yp[o] - du_k * yc) / dhat_k;
    vc = (vp[o] - du_k * vc) / dhat_k;
    wc = (T(0) - du_k * wc) / dhat_k;
    yp[o] = yc;
    vp[o] = vc;
    wp[o] = wc;
  }
}

template <typename T>
__global__ void stage1_wide_reduced_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                                           const T* __restrict__ du, const T* __restrict__ b,
                                           const T* __restrict__ y, const T* __restrict__ v,
                                           const T* __restrict__ w, T* __restrict__ red_dl,
                                           T* __restrict__ red_d, T* __restrict__ red_du,
                                           T* __restrict__ red_b, long long nblocks,
                                           long long nsys, int m) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= nblocks * nsys) return;
  const long long p = g / nsys;
  const long long i = g - p * nsys;
  const int mi = m - 1;
  const long long B = nsys;
  const long long row = (p * m + (m - 1)) * B + i;  // the block's last (interface) row
  const T aL = dl[row];
  const T bL = d[row];
  const T cL = du[row];
  const T dL = b[row];
  const long long lastk = (p * mi + (mi - 1)) * B + i;
  const T y_last = y[lastk];
  const T v_last = v[lastk];
  const T w_last = w[lastk];
  T y_nf = T(0), v_nf = T(0), w_nf = T(0);
  if (p + 1 < nblocks) {
    const long long first = (p + 1) * mi * B + i;
    y_nf = y[first];
    v_nf = v[first];
    w_nf = w[first];
  }
  red_dl[g] = -aL * v_last;
  red_d[g] = bL - aL * w_last - cL * v_nf;
  red_du[g] = -cL * w_nf;
  red_b[g] = dL - aL * y_last - cL * y_nf;
}

template <typename T>
static int launch_stage1_wide(const void* dl, const void* d, const void* du, const void* b,
                              void* y, void* v, void* w, void* red_dl, void* red_d,
                              void* red_du, void* red_b, long long nblocks, long long nsys,
                              int m, void* stream) {
  const long long work = nblocks * nsys;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (work == 0) return static_cast<int>(cudaGetLastError());
  const unsigned int grid = repro_grid(work);
  stage1_wide_spikes_kernel<T><<<grid, REPRO_THREADS, 0, s>>>(
      static_cast<const T*>(dl), static_cast<const T*>(d), static_cast<const T*>(du),
      static_cast<const T*>(b), static_cast<T*>(y), static_cast<T*>(v), static_cast<T*>(w),
      nblocks, nsys, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stage1_wide_reduced_kernel<T><<<grid, REPRO_THREADS, 0, s>>>(
      static_cast<const T*>(dl), static_cast<const T*>(d), static_cast<const T*>(du),
      static_cast<const T*>(b), static_cast<const T*>(y), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<T*>(red_dl), static_cast<T*>(red_d),
      static_cast<T*>(red_du), static_cast<T*>(red_b), nblocks, nsys, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int partition_stage1_wide_f32(const void* dl, const void* d, const void* du,
                                         const void* b, void* y, void* v, void* w,
                                         void* red_dl, void* red_d, void* red_du,
                                         void* red_b, long long nblocks, long long nsys,
                                         int m, void* stream) {
  return launch_stage1_wide<float>(dl, d, du, b, y, v, w, red_dl, red_d, red_du, red_b,
                                   nblocks, nsys, m, stream);
}

extern "C" int partition_stage1_wide_f64(const void* dl, const void* d, const void* du,
                                         const void* b, void* y, void* v, void* w,
                                         void* red_dl, void* red_d, void* red_du,
                                         void* red_b, long long nblocks, long long nsys,
                                         int m, void* stream) {
  return launch_stage1_wide<double>(dl, d, du, b, y, v, w, red_dl, red_d, red_du, red_b,
                                    nblocks, nsys, m, stream);
}
