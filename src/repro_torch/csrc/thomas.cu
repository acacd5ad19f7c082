// Batched Thomas solve: B independent tridiagonal systems of n rows.
//
// Replaces the TPU kernel src/repro/kernels/thomas/thomas.py (_thomas_kernel,
// through thomas_tiled) on both of its routes in
// src/repro/kernels/thomas/ops.py: thomas_pallas, (B, n) operands with a 1-D
// system as a batch of one, and thomas_pallas_wide, interleaved (n, B)
// operands. On the main path it is the fused executor's device Stage 2: the
// reduced system of P = N/m rows (system-major), or B reduced systems of
// P rows each on (P, B) rows (interleaved).
//
// Row i of system s is at s * sys_stride + i * row_stride in every operand,
// in x and in the dhat scratch buffer the wrapper allocates: (B, n) has row
// stride 1 and system stride n, (n, B) row stride B and system stride 1. x
// holds bhat during the forward sweep and is overwritten with the solution
// on the way back.
//
// Bound: the serial dependency chain, not bytes. Row i needs dhat[i-1]
// through a division, so one system is n dependent division steps forward
// and n back, whatever the card's bandwidth. On the system-major main path
// one thread runs 2P dependent steps while the rest of the card idles.
//
// Design: one thread per system, walking its rows in order. On the (B, n)
// route consecutive rows of one thread are contiguous, and a warp's 32
// threads read 32 addresses n apart. On the (n, B) route a warp's 32 threads
// read 32 adjacent lanes of one row, so each step's loads are coalesced.
// There are no padded lanes (the TPU kernel pads to 256): a thread past the
// last system returns before touching memory, so nothing divides by zero.
#include "common.cuh"

template <typename T>
__global__ void thomas_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                              const T* __restrict__ du, const T* __restrict__ b,
                              T* __restrict__ x, T* __restrict__ dhat, long long nsys,
                              long long n, long long rs, long long ss) {
  const long long sys = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (sys >= nsys) return;
  const long long off = sys * ss;
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
    const long long k = i * rs;
    const T wgt = dl[k] / dh;
    dh = d[k] - wgt * du[k - rs];
    bh = b[k] - wgt * bh;
    dhat[k] = dh;
    x[k] = bh;
  }
  T xc = bh / dh;
  x[(n - 1) * rs] = xc;
  for (long long i = n - 2; i >= 0; --i) {
    const long long k = i * rs;
    xc = (x[k] - du[k] * xc) / dhat[k];
    x[k] = xc;
  }
}

template <typename T>
static int launch_thomas(const void* dl, const void* d, const void* du, const void* b,
                         void* x, void* dhat, long long nsys, long long n, long long rs,
                         long long ss, void* stream) {
  if (nsys == 0 || n == 0) return static_cast<int>(cudaGetLastError());
  thomas_kernel<T><<<repro_grid(nsys), REPRO_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(dl), static_cast<const T*>(d), static_cast<const T*>(du),
      static_cast<const T*>(b), static_cast<T*>(x), static_cast<T*>(dhat), nsys, n, rs, ss);
  return static_cast<int>(cudaGetLastError());
}

// rs: row stride, ss: system stride, in elements.
extern "C" int thomas_f32(const void* dl, const void* d, const void* du, const void* b,
                          void* x, void* dhat, long long nsys, long long n, long long rs,
                          long long ss, void* stream) {
  return launch_thomas<float>(dl, d, du, b, x, dhat, nsys, n, rs, ss, stream);
}

extern "C" int thomas_f64(const void* dl, const void* d, const void* du, const void* b,
                          void* x, void* dhat, long long nsys, long long n, long long rs,
                          long long ss, void* stream) {
  return launch_thomas<double>(dl, d, du, b, x, dhat, nsys, n, rs, ss, stream);
}
