// Stage 1 of the partition method: per-block spikes and reduced rows.
//
// Replaces the TPU kernel src/repro/kernels/partition_stage1/stage1.py
// (_stage1_kernel, through stage1_tiled / stage1_tiled_batched) together
// with the reduced-row assembly of src/repro/kernels/partition_stage1/ops.py
// (_stage1_impl / _stage1_impl_batched).
//
// Operands are the row-major (nsys, P, m) view of (nsys, P*m) diagonals:
// every partition block is m contiguous rows. Outputs: spikes y, v, w of
// shape (nsys, P, m-1) and the reduced rows red_dl/red_d/red_du/red_b of
// shape (nsys, P).
//
// Bound: bytes. Each block reads 4m values and writes 3(m-1)+4, with about
// 10 flops per row, far below the card's 67 TFLOP/s fp32 rate for what
// 3.35 TB/s delivers; the per-block recurrence is serial in m but the P
// blocks are independent.
//
// Design: one thread per block walks its m rows (forward elimination shared
// by the three right-hand sides, then back substitution), so no thread waits
// on another and no shared memory is needed. The modified diagonal dhat is
// kept in the w output's own slots during the forward sweep: the w spike's
// forward image is zero except its last row, so the backward sweep reads
// dhat[i] from slot i just before writing w[i] there. A second kernel on the
// same stream assembles the reduced rows, since each needs the next block's
// first spike row, which another thread computes. That shift stops at each
// system's last block (zero past it), so it never crosses from one system
// into the next. Neighbouring threads read addresses m apart; the TPU
// kernel's (m, 512) transposed tiles are not carried over.
#include "common.cuh"

template <typename T>
__global__ void stage1_spikes_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                                     const T* __restrict__ du, const T* __restrict__ b,
                                     T* __restrict__ y, T* __restrict__ v, T* __restrict__ w,
                                     long long nblocks, int m) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= nblocks) return;
  const int mi = m - 1;  // interior rows
  const T* dlp = dl + g * m;
  const T* dp = d + g * m;
  const T* dup = du + g * m;
  const T* bp = b + g * m;
  T* yp = y + g * mi;
  T* vp = v + g * mi;
  T* wp = w + g * mi;  // holds dhat until the backward sweep overwrites it

  // Forward elimination, shared factorization; spikes seeded per their RHS.
  T dhat = dp[0];
  T yc = bp[0];
  T vc = dlp[0];
  wp[0] = dhat;
  yp[0] = yc;
  vp[0] = vc;
  for (int i = 1; i < mi; ++i) {
    const T wgt = dlp[i] / dhat;
    dhat = dp[i] - wgt * dup[i - 1];
    yc = bp[i] - wgt * yc;
    vc = -wgt * vc;
    wp[i] = dhat;
    yp[i] = yc;
    vp[i] = vc;
  }

  // Backward substitution, all three spikes per step, in place.
  const int last = mi - 1;
  yc = yc / dhat;
  vc = vc / dhat;
  // The w spike's forward image is du[m-2] e_last, so its seed is direct.
  T wc = dup[last] / dhat;
  yp[last] = yc;
  vp[last] = vc;
  wp[last] = wc;
  for (int i = last - 1; i >= 0; --i) {
    const T du_i = dup[i];
    const T dhat_i = wp[i];
    yc = (yp[i] - du_i * yc) / dhat_i;
    vc = (vp[i] - du_i * vc) / dhat_i;
    wc = (T(0) - du_i * wc) / dhat_i;
    yp[i] = yc;
    vp[i] = vc;
    wp[i] = wc;
  }
}

template <typename T>
__global__ void stage1_reduced_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                                      const T* __restrict__ du, const T* __restrict__ b,
                                      const T* __restrict__ y, const T* __restrict__ v,
                                      const T* __restrict__ w, T* __restrict__ red_dl,
                                      T* __restrict__ red_d, T* __restrict__ red_du,
                                      T* __restrict__ red_b, long long nblocks,
                                      long long blocks_per_system, int m) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= nblocks) return;
  const int mi = m - 1;
  const long long row = g * m + (m - 1);  // the block's last (interface) row
  const T aL = dl[row];
  const T bL = d[row];
  const T cL = du[row];
  const T dL = b[row];
  const long long lastk = g * mi + (mi - 1);
  const T y_last = y[lastk];
  const T v_last = v[lastk];
  const T w_last = w[lastk];
  T y_nf = T(0), v_nf = T(0), w_nf = T(0);
  if ((g % blocks_per_system) + 1 < blocks_per_system) {
    const long long first = (g + 1) * mi;
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
static int launch_stage1(const void* dl, const void* d, const void* du, const void* b,
                         void* y, void* v, void* w, void* red_dl, void* red_d,
                         void* red_du, void* red_b, long long nsys,
                         long long blocks_per_system, int m, void* stream) {
  const long long nblocks = nsys * blocks_per_system;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nblocks == 0) return static_cast<int>(cudaGetLastError());
  const unsigned int grid = repro_grid(nblocks);
  stage1_spikes_kernel<T><<<grid, REPRO_THREADS, 0, s>>>(
      static_cast<const T*>(dl), static_cast<const T*>(d), static_cast<const T*>(du),
      static_cast<const T*>(b), static_cast<T*>(y), static_cast<T*>(v), static_cast<T*>(w),
      nblocks, m);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stage1_reduced_kernel<T><<<grid, REPRO_THREADS, 0, s>>>(
      static_cast<const T*>(dl), static_cast<const T*>(d), static_cast<const T*>(du),
      static_cast<const T*>(b), static_cast<const T*>(y), static_cast<const T*>(v),
      static_cast<const T*>(w), static_cast<T*>(red_dl), static_cast<T*>(red_d),
      static_cast<T*>(red_du), static_cast<T*>(red_b), nblocks, blocks_per_system, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int partition_stage1_f32(const void* dl, const void* d, const void* du,
                                    const void* b, void* y, void* v, void* w,
                                    void* red_dl, void* red_d, void* red_du, void* red_b,
                                    long long nsys, long long blocks_per_system, int m,
                                    void* stream) {
  return launch_stage1<float>(dl, d, du, b, y, v, w, red_dl, red_d, red_du, red_b, nsys,
                              blocks_per_system, m, stream);
}

extern "C" int partition_stage1_f64(const void* dl, const void* d, const void* du,
                                    const void* b, void* y, void* v, void* w,
                                    void* red_dl, void* red_d, void* red_du, void* red_b,
                                    long long nsys, long long blocks_per_system, int m,
                                    void* stream) {
  return launch_stage1<double>(dl, d, du, b, y, v, w, red_dl, red_d, red_du, red_b, nsys,
                               blocks_per_system, m, stream);
}
