// Stage 3 of the partition method: back substitution into block interiors.
//
// Replaces the TPU kernel src/repro/kernels/partition_stage3/stage3.py
// (_stage3_kernel, through stage3_tiled / stage3_tiled_batched) together
// with the s_left shift of src/repro/kernels/partition_stage3/ops.py
// (_stage3_impl / _stage3_impl_batched).
//
// Inputs: spikes y, v, w of shape (nsys, P, m-1), interface values s of
// shape (nsys, P) and left of shape (nsys,), the s_{p-1} of each system's
// first block (zero for a whole system, the neighbouring chunk's last s for
// one chunk of a longer fused system). Output x: (nsys, P*m), where
// x[p, r] = y - v*s_{p-1} - w*s_p for the m-1 interior rows and x[p, m-1] =
// s_p.
//
// Bound: bytes. Two multiply-adds per output element against 3 spike reads
// and 1 write; the card's 3.35 TB/s is the limit.
//
// Design: one thread per output element, so consecutive threads write
// consecutive addresses and read consecutive spike entries; the s_{p-1}
// shift is an index (s[g-1], or left[] at a system's first block), never a
// shifted copy. Elementwise CUDA C++ keeps the port on one build route.
#include "common.cuh"

template <typename T>
__global__ void stage3_kernel(const T* __restrict__ y, const T* __restrict__ v,
                              const T* __restrict__ w, const T* __restrict__ s,
                              const T* __restrict__ left, T* __restrict__ x,
                              long long total, long long blocks_per_system, int m) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const long long g = idx / m;  // global block index
  const int r = static_cast<int>(idx - g * m);
  const T sp = s[g];
  if (r == m - 1) {
    x[idx] = sp;
    return;
  }
  const long long p = g % blocks_per_system;
  const T sl = (p == 0) ? left[g / blocks_per_system] : s[g - 1];
  const long long k = g * (m - 1) + r;
  x[idx] = y[k] - v[k] * sl - w[k] * sp;
}

template <typename T>
static int launch_stage3(const void* y, const void* v, const void* w, const void* s,
                         const void* left, void* x, long long nsys,
                         long long blocks_per_system, int m, void* stream) {
  const long long total = nsys * blocks_per_system * m;
  if (total == 0) return static_cast<int>(cudaGetLastError());
  stage3_kernel<T><<<repro_grid(total), REPRO_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(s), static_cast<const T*>(left), static_cast<T*>(x), total,
      blocks_per_system, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int partition_stage3_f32(const void* y, const void* v, const void* w,
                                    const void* s, const void* left, void* x,
                                    long long nsys, long long blocks_per_system, int m,
                                    void* stream) {
  return launch_stage3<float>(y, v, w, s, left, x, nsys, blocks_per_system, m, stream);
}

extern "C" int partition_stage3_f64(const void* y, const void* v, const void* w,
                                    const void* s, const void* left, void* x,
                                    long long nsys, long long blocks_per_system, int m,
                                    void* stream) {
  return launch_stage3<double>(y, v, w, s, left, x, nsys, blocks_per_system, m, stream);
}
