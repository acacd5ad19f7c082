// Stage 3 of the partition method on the interleaved layout: back
// substitution into block interiors, with the systems on the fastest axis.
//
// Replaces the TPU kernel src/repro/kernels/partition_stage3/stage3.py
// (_stage3_kernel_wide, through stage3_tiled_wide) together with the s_left
// shift of src/repro/kernels/partition_stage3/ops.py (_stage3_impl_wide).
//
// Inputs: spikes y, v, w of shape (P, m-1, B) and interface values s of
// shape (P, B). Output x: (P, m, B), where x[p, r, i] = y - v*s_{p-1} -
// w*s_p for the m-1 interior rows and x[p, m-1, i] = s_p, with s_{-1} = 0:
// row 0 of every lane is a system's first block.
//
// Bound: bytes. Two multiply-adds per output element against 3 spike reads
// and 1 write; the card's 3.35 TB/s is the limit.
//
// Design: one thread per output element (p, r, i), with i fastest, so
// consecutive threads write consecutive addresses and read consecutive spike
// entries. s_{p-1} is an index (s[(p-1)*B + i], or 0 at p = 0), never a
// shifted copy, and there is no row or lane padding.
#include "common.cuh"

template <typename T>
__global__ void stage3_wide_kernel(const T* __restrict__ y, const T* __restrict__ v,
                                   const T* __restrict__ w, const T* __restrict__ s,
                                   T* __restrict__ x, long long nrows, long long nsys, int m) {
  const long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= nrows * nsys) return;
  const long long row = idx / nsys;  // p*m + r
  const long long i = idx - row * nsys;
  const long long p = row / m;
  const int r = static_cast<int>(row - p * m);
  const T sp = s[p * nsys + i];
  if (r == m - 1) {
    x[idx] = sp;
    return;
  }
  const T sl = (p == 0) ? T(0) : s[(p - 1) * nsys + i];
  const long long k = (p * (m - 1) + r) * nsys + i;
  x[idx] = y[k] - v[k] * sl - w[k] * sp;
}

template <typename T>
static int launch_stage3_wide(const void* y, const void* v, const void* w, const void* s,
                              void* x, long long nblocks, long long nsys, int m,
                              void* stream) {
  const long long nrows = nblocks * m;
  if (nrows * nsys == 0) return static_cast<int>(cudaGetLastError());
  stage3_wide_kernel<T><<<repro_grid(nrows * nsys), REPRO_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(s), static_cast<T*>(x), nrows, nsys, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int partition_stage3_wide_f32(const void* y, const void* v, const void* w,
                                         const void* s, void* x, long long nblocks,
                                         long long nsys, int m, void* stream) {
  return launch_stage3_wide<float>(y, v, w, s, x, nblocks, nsys, m, stream);
}

extern "C" int partition_stage3_wide_f64(const void* y, const void* v, const void* w,
                                         const void* s, void* x, long long nblocks,
                                         long long nsys, int m, void* stream) {
  return launch_stage3_wide<double>(y, v, w, s, x, nblocks, nsys, m, stream);
}
