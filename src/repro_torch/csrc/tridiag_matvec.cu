// Tridiagonal matvec r = A . x for one system of N rows.
//
// Replaces the TPU kernel src/repro/kernels/tridiag_matvec/matvec.py
// (_matvec_kernel, through matvec_tiled, from ops.py::tridiag_matvec_pallas)
// together with that wrapper's glue, which builds the shifted copies of x
// and pads every operand to (R, 128) tiles.
//
//   r[i] = dl[i] * x[i-1] + d[i] * x[i] + du[i] * x[i+1],
//
// with dl[0] and du[N-1] ignored, as the reference's zero-filled shifts give.
//
// Bound: bytes. Five multiply-adds' worth of work against four reads and
// one write of N values: 5 * N * itemsize over the card's 3.35 TB/s.
//
// Design: one thread per row reads x[i-1], x[i] and x[i+1] directly (the
// neighbours come from the same or the next cache line, so x is read from
// memory about once); no shifted copies, no lane padding.
#include "common.cuh"

template <typename T>
__global__ void matvec_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                              const T* __restrict__ du, const T* __restrict__ x,
                              T* __restrict__ r, long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  T v = d[i] * x[i];
  if (i > 0) v += dl[i] * x[i - 1];
  if (i < n - 1) v += du[i] * x[i + 1];
  r[i] = v;
}

template <typename T>
static int launch_matvec(const void* dl, const void* d, const void* du, const void* x,
                         void* r, long long n, void* stream) {
  if (n == 0) return static_cast<int>(cudaGetLastError());
  matvec_kernel<T><<<repro_grid(n), REPRO_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dl), static_cast<const T*>(d), static_cast<const T*>(du),
      static_cast<const T*>(x), static_cast<T*>(r), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int tridiag_matvec_f32(const void* dl, const void* d, const void* du,
                                  const void* x, void* r, long long n, void* stream) {
  return launch_matvec<float>(dl, d, du, x, r, n, stream);
}

extern "C" int tridiag_matvec_f64(const void* dl, const void* d, const void* du,
                                  const void* x, void* r, long long n, void* stream) {
  return launch_matvec<double>(dl, d, du, x, r, n, stream);
}
