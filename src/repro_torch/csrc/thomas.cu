// Batched Thomas solve: the base case of the reduced solve.
//
// Together with csrc/partition_stage1.cu and csrc/partition_stage3.cu (and
// their wide counterparts) it replaces the TPU kernel
// src/repro/kernels/thomas/thomas.py (_thomas_kernel, through thomas_tiled)
// on both of its routes in src/repro/kernels/thomas/ops.py: thomas_pallas,
// (B, n) operands with a 1-D system as a batch of one, and
// thomas_pallas_wide, interleaved (n, B) operands. On the main path that is
// the fused executor's device Stage 2: the reduced system of P = N/m rows
// (system-major), or B reduced systems of P rows each on (P, B) rows
// (interleaved).
//
// What bounds a Thomas solve here is its chain, not bytes: row i needs
// dhat[i-1] through a division, so one system is n dependent division steps
// forward and n back (about 189 ns a step on one thread of an H100), and
// one thread per system leaves all but one SM idle on the single reduced
// system of the system-major path. So the wrapper
// (repro_torch/kernels/thomas/ops.py) solves a system of n rows by the
// partition method itself, recursively: while n > n0 it cuts the rows into
// sub-blocks of r, runs Stage 1 with m = r (spikes, and one reduced row per
// sub-block, written into the next level's buffers already padded to a
// multiple of r with identity rows), recurses on the ceil(n/r) reduced
// rows, then runs Stage 3 with m = r. This body solves only what is left at
// n <= n0: a chain of at most 2*n0 steps per system. Every level above it is
// bytes-bound and fills the card, so the whole solve is bound by the bytes
// of its levels (each level 1/r of the one above, so about r/(r-1) times
// the first level's Stage 1 and Stage 3) plus about 2*levels + 1 kernel
// launches. No level needs pivoting: the solver's systems are strictly
// diagonally dominant, and the reduced system of such a system is too, as
// in the reference's Stage 1. There are no atomics, so the same rows give
// the same bits.
//
// Row i of system s is at s * sys_stride + i * row_stride in every operand,
// in x and in the dhat scratch buffer the wrapper allocates: (B, n) has row
// stride 1 and system stride n, (n, B) row stride B and system stride 1. x
// holds bhat during the forward sweep and is overwritten with the solution
// on the way back. One thread walks one system in order: on the (n, B)
// route a warp's 32 threads read 32 adjacent lanes of one row. On the (B, n)
// route they read rows n apart, so each load a warp issues is one L1
// wavefront per active lane, in every step of the chain. A block is
// therefore kThreads = 8 threads (a warp with 8 lanes active), so a step
// costs 8 wavefronts a load and more systems go to more SMs. A thread past
// the last system returns before touching memory, so nothing divides by
// zero.
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
  constexpr int kThreads = 8;  // see the note above
  const unsigned int blocks = static_cast<unsigned int>((nsys + kThreads - 1) / kThreads);
  thomas_kernel<T><<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
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
