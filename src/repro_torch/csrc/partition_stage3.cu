// Stage 3 of the partition method: back substitution into block interiors.
//
// Replaces the TPU kernel src/repro/kernels/partition_stage3/stage3.py
// (_stage3_kernel, through stage3_tiled / stage3_tiled_batched) together
// with the s_left shift of src/repro/kernels/partition_stage3/ops.py
// (_stage3_impl / _stage3_impl_batched). It also climbs back through every
// level of the reduced solve (kernels/thomas/ops.py), with m = R = 32.
//
// Inputs: spikes y, v, w of shape (nsys, P, m-1), interface values s of
// shape (nsys, P) and left of shape (nsys,), the s_{p-1} of each system's
// first block (zero for a whole system, the neighbouring chunk's last s for
// one chunk of a longer fused system). Output x: (nsys, P*m), where
// x[p, r] = y - v*s_{p-1} - w*s_p for the m-1 interior rows and x[p, m-1] =
// s_p.
//
// Bound: bytes. Two multiply-adds per output element against 3 spike reads
// and 1 write: at P = 1e6, m = 10 that is 304 MB in fp64, at least 0.091 ms
// at an H100's 3.35 TB/s (0.045 ms in fp32).
//
// Design: one CUDA block owns a span of nb consecutive partition blocks
// (nb from the spikes' bytes, at most 16 KB a span: 32 KB measured no
// faster on an H100). The span's nb*(m-1)
// spike entries lie contiguous in each of y, v and w, and its nb*m outputs
// contiguous in x, so:
//   1. Each spike array is copied into shared memory with 16-byte cp.async,
//      the unaligned head and tail element by element. The shared copy is
//      offset by the source's misalignment, so that 16-byte runs of device
//      memory land on 16-byte runs of shared memory (the fused path hands
//      in chunk views at any element offset). The span's s_p and s_{p-1}
//      (left[] at each system's first block, s[g-1] elsewhere) are staged
//      beside them, so a system boundary costs one division a block, not
//      three 64-bit divisions an element.
//   2. Each thread forms 16 bytes of x (2 fp64 or 4 fp32 outputs) from
//      shared memory and stores them with one vector store, the unaligned
//      head and tail element by element. In-span indices are 32-bit, and m
//      is a template parameter for the paths' two sizes (10 and R = 32),
//      with one runtime-m instantiation for the rest.
// The expression is y - v*s_{p-1} - w*s_p in that order, as one thread per
// element computed it before, so results are bit for bit what they were,
// and a block's result does not depend on the span it falls in: chunked
// and unchunked solves agree bit for bit. Blocks too long for a 16 KB span
// (m > 683 in fp64, m > 1366 in fp32) read their spikes straight from device memory, one
// CUDA block each.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSpanBytes = 16 * 1024;  // spikes staged per CUDA block
constexpr int kMaxSpan = 1024;         // partition blocks per CUDA block

template <typename T>
__host__ __device__ constexpr int vec_elems() {
  return 16 / static_cast<int>(sizeof(T));
}

// Shared-memory slots for the s_p (and again the s_{p-1}) of a span of nb
// blocks: a 16-byte multiple, so the staged spikes after them stay aligned.
template <typename T>
__host__ __device__ constexpr int s_slots(int nb) {
  return (nb + vec_elems<T>() - 1) / vec_elems<T>() * vec_elems<T>();
}

// Elements a staged spike array takes: room for the misaligned head, a
// 16-byte multiple.
template <typename T>
__host__ __device__ constexpr int spike_slots(int nb, int mi) {
  return (nb * mi + 2 * vec_elems<T>() - 1) / vec_elems<T>() * vec_elems<T>();
}

template <typename T>
__device__ __forceinline__ void store16(T* dst, const T (&o)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
    *reinterpret_cast<double2*>(dst) = make_double2(o[0], o[1]);
  }
}

template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) / sizeof(T)) % vec_elems<T>());
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  }
}

// Copy n contiguous elements from src into dst + mis, where mis is src's
// misalignment in elements: element j of dst is 16-byte aligned exactly
// where the source element is.
template <typename T>
__device__ __forceinline__ void stage_run(T* dst, const T* src, int n, int mis) {
  constexpr int V = vec_elems<T>();
  const T* base = src - mis;  // 16-byte aligned
  const int chunks = (n + mis + V - 1) / V;
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int j0 = c * V;
    if (j0 >= mis && j0 + V <= n + mis) {
      cp_async16(dst + j0, base + j0);
    } else {
      for (int j = max(j0, mis); j < min(j0 + V, n + mis); ++j) cp_async_elem(dst + j, base + j);
    }
  }
}

// One output element: o is its index in the span, m the block size.
template <typename T>
__device__ __forceinline__ T back_substitute(int o, int m, const T* py, const T* pv,
                                             const T* pw, const T* sl, const T* sp) {
  const int blk = o / m;
  const int r = o - blk * m;
  if (r == m - 1) return sp[blk];
  const int k = o - blk;  // the spike entry: m-1 of them a block
  return py[k] - pv[k] * sl[blk] - pw[k] * sp[blk];
}

// kM > 0: m fixed at compile time; kM == 0: m = m_rt. kStaged: spikes come
// from shared memory; otherwise (one block a span) from device memory.
template <typename T, int kM, bool kStaged>
__global__ void __launch_bounds__(kThreads)
stage3_span_kernel(const T* __restrict__ y, const T* __restrict__ v, const T* __restrict__ w,
                   const T* __restrict__ s, const T* __restrict__ left, T* __restrict__ x,
                   long long nblocks, long long bps, int m_rt, int nb) {
  constexpr int V = vec_elems<T>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int m = kM > 0 ? kM : m_rt;
  const int mi = m - 1;
  const long long g0 = static_cast<long long>(blockIdx.x) * nb;
  const int cnt = static_cast<int>(min(static_cast<long long>(nb), nblocks - g0));
  const long long e0 = g0 * mi;  // first spike entry of the span
  const int ne = cnt * mi;

  T* sp = reinterpret_cast<T*>(smem_raw);  // s_p of the span's blocks
  T* sl = sp + s_slots<T>(nb);             // s_{p-1}
  const T* py = y + e0;
  const T* pv = v + e0;
  const T* pw = w + e0;
  if constexpr (kStaged) {
    const int run = spike_slots<T>(nb, mi);
    T* sy = sl + s_slots<T>(nb);
    T* sv = sy + run;
    T* sw = sv + run;
    const int my = misalign(py), mv = misalign(pv), mw = misalign(pw);
    stage_run(sy, py, ne, my);
    stage_run(sv, pv, ne, mv);
    stage_run(sw, pw, ne, mw);
    py = sy + my;
    pv = sv + mv;
    pw = sw + mw;
  }
  for (int t = threadIdx.x; t < cnt; t += kThreads) {
    const long long g = g0 + t;
    const long long sys = g / bps;
    sp[t] = s[g];
    sl[t] = (g == sys * bps) ? left[sys] : s[g - 1];
  }
  if constexpr (kStaged) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  // x in 16-byte slots of device memory: slot c holds span outputs
  // c*V - mx ... c*V - mx + V - 1.
  const int no = cnt * m;
  T* px = x + g0 * m;
  const int mx = misalign(px);
  T* xbase = px - mx;
  const int slots = (no + mx + V - 1) / V;
  for (int c = threadIdx.x; c < slots; c += kThreads) {
    const int o0 = c * V - mx;
    if (o0 >= 0 && o0 + V <= no) {
      T out[V];
#pragma unroll
      for (int j = 0; j < V; ++j) out[j] = back_substitute(o0 + j, m, py, pv, pw, sl, sp);
      store16(xbase + c * V, out);
    } else {
      for (int o = max(o0, 0); o < min(o0 + V, no); ++o)
        px[o] = back_substitute(o, m, py, pv, pw, sl, sp);
    }
  }
}

// Partition blocks a span: the most (a power of two, at most kMaxSpan)
// whose spikes fit kSpanBytes; 0 when not even one block's fit.
int span_blocks(int m, int es) {
  const long long per_block = 3LL * (m - 1) * es;
  int nb = kMaxSpan;
  while (nb > 0 && nb * per_block > kSpanBytes) nb /= 2;
  return nb;
}

template <typename T, int kM, bool kStaged>
int launch(const void* y, const void* v, const void* w, const void* s, const void* left,
           void* x, long long nblocks, long long bps, int m, int nb, size_t smem,
           cudaStream_t stream) {
  const long long spans = (nblocks + nb - 1) / nb;
  stage3_span_kernel<T, kM, kStaged><<<static_cast<unsigned>(spans), kThreads, smem, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(s), static_cast<const T*>(left), static_cast<T*>(x), nblocks, bps, m,
      nb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_stage3(const void* y, const void* v, const void* w, const void* s, const void* left,
                  void* x, long long nsys, long long bps, int m, void* stream) {
  const long long nblocks = nsys * bps;
  if (nblocks == 0) return static_cast<int>(cudaGetLastError());
  if (m < 2) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int es = static_cast<int>(sizeof(T));
  const int nb = span_blocks(m, es);
  if (nb == 0) return launch<T, 0, false>(y, v, w, s, left, x, nblocks, bps, m, 1,
                                          2 * s_slots<T>(1) * es, st);
  // At most 16 KB of spikes, 16 bytes of head room each and 16 KB of s:
  // under 48 KB, so no opt-in is needed.
  const size_t smem = static_cast<size_t>(2 * s_slots<T>(nb) + 3 * spike_slots<T>(nb, m - 1)) * es;
  if (m == 10) return launch<T, 10, true>(y, v, w, s, left, x, nblocks, bps, m, nb, smem, st);
  if (m == 32) return launch<T, 32, true>(y, v, w, s, left, x, nblocks, bps, m, nb, smem, st);
  return launch<T, 0, true>(y, v, w, s, left, x, nblocks, bps, m, nb, smem, st);
}

}  // namespace

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
