// Batched Thomas solve: B independent tridiagonal systems of n rows.
//
// Replaces the TPU kernel src/repro/kernels/thomas/thomas.py (_thomas_kernel,
// through thomas_tiled) as reached from src/repro/kernels/thomas/ops.py
// (thomas_pallas); a 1-D system is a batch of one. On the main path it is the
// fused executor's device Stage 2: the reduced system of P = N/m rows.
//
// Operands are row-major (B, n); output x is (B, n); dhat is a (B, n) scratch
// buffer the wrapper allocates. x holds bhat during the forward sweep and is
// overwritten with the solution on the way back.
//
// Bound: the serial dependency chain, not bytes. Row i needs dhat[i-1]
// through a division, so one system is n dependent division steps forward
// and n back, whatever the card's bandwidth. The main path solves one fused
// reduced system, so one thread runs 2P dependent steps while the rest of
// the card idles; the bytes (4 reads + 1 write per row) are a far smaller
// floor at P = 1e6.
//
// Design: one thread per system, walking its rows in order; consecutive rows
// are contiguous, so each thread's loads stream through L1. There are no
// padded lanes: a thread past the last system returns before touching
// memory, so nothing divides by zero. Making the reduced solve parallel (a
// cyclic-reduction or recursive partition of the reduced system) is left
// for a later change.
#include "common.cuh"

template <typename T>
__global__ void thomas_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                              const T* __restrict__ du, const T* __restrict__ b,
                              T* __restrict__ x, T* __restrict__ dhat, long long nsys,
                              long long n) {
  const long long sys = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (sys >= nsys) return;
  const long long off = sys * n;
  dl += off;
  d += off;
  du += off;
  b += off;
  x += off;
  dhat += off;

  T dh = d[0];
  T bh = b[0];
  dhat[0] = dh;
  x[0] = bh;
  for (long long i = 1; i < n; ++i) {
    const T wgt = dl[i] / dh;
    dh = d[i] - wgt * du[i - 1];
    bh = b[i] - wgt * bh;
    dhat[i] = dh;
    x[i] = bh;
  }
  T xc = bh / dh;
  x[n - 1] = xc;
  for (long long i = n - 2; i >= 0; --i) {
    xc = (x[i] - du[i] * xc) / dhat[i];
    x[i] = xc;
  }
}

template <typename T>
static int launch_thomas(const void* dl, const void* d, const void* du, const void* b,
                         void* x, void* dhat, long long nsys, long long n, void* stream) {
  if (nsys == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  thomas_kernel<T><<<repro_grid(nsys), REPRO_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dl), static_cast<const T*>(d), static_cast<const T*>(du),
      static_cast<const T*>(b), static_cast<T*>(x), static_cast<T*>(dhat), nsys, n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int thomas_f32(const void* dl, const void* d, const void* du, const void* b,
                          void* x, void* dhat, long long nsys, long long n, void* stream) {
  return launch_thomas<float>(dl, d, du, b, x, dhat, nsys, n, stream);
}

extern "C" int thomas_f64(const void* dl, const void* d, const void* du, const void* b,
                          void* x, void* dhat, long long nsys, long long n, void* stream) {
  return launch_thomas<double>(dl, d, du, b, x, dhat, nsys, n, stream);
}
