// Stage 3 of the partition method on the interleaved layout: back
// substitution into block interiors, with the systems on the fastest axis.
//
// Replaces the TPU kernel src/repro/kernels/partition_stage3/stage3.py
// (_stage3_kernel_wide, through stage3_tiled_wide) together with the s_left
// shift of src/repro/kernels/partition_stage3/ops.py (_stage3_impl_wide).
// It also climbs back through every level of the wide reduced solve
// (kernels/thomas/ops.py) with m = the level's r.
//
// Inputs: spikes y, v, w of shape (P, m-1, B) and interface values s of
// shape (P, B). Output x: (P, m, B), where x[p, r, i] = y - v*s_{p-1} -
// w*s_p for the m-1 interior rows and x[p, m-1, i] = s_p, with s_{-1} = 0:
// row 0 of every lane is a system's first block.
//
// Bound: bytes. Two multiply-adds per output element against 3 spike reads
// and 1 write; the card's 3.35 TB/s is the limit.
//
// Design: a thread works one group of lanes: 16 bytes (2 fp64, 4 fp32)
// when B*sizeof(T) and the five arrays' addresses allow, else one lane, in
// the same kernel. A CUDA block of 256 threads takes a tile of consecutive
// blocks p by up to 32 lane groups, and ry threads share each (block, lane
// group): thread ty does rows ty, ty+ry, ... of the block, the interface
// row included. s is read from device memory once per (block, lane) into
// registers, s_p and s_{p-1} (zero at p = 0), before the rows. Every load
// and store is a 16-byte access where alignment allows, and a warp's
// accesses to one row are consecutive. ry is 1 where the launch has at
// least kManyColumns (block, lane group) columns: each thread loads its own
// s_p and s_{p-1} and loops over all m rows, many loads in flight (the main
// path's shapes). Below that, ry is the smallest power of two, at most 16,
// that makes kFewThreads threads, and the tile's s rows, with the row
// before it, are read once into shared memory for the ry threads of each
// column. One thread per column leaves 5-16 K threads at the reduced
// solve's level shapes (m = 32), and on an H100 it ran well behind one
// thread per element there, while 8 threads a column ran behind one at
// m = 10 with 160 K columns; a sweep of ry = 4 ... 32 at the level shapes
// put the best ry near 2^16 threads in all. The grid strides over the
// tiles on y and no index is divided. Each element is computed by the same expression as one thread
// per element, y - v*s_{p-1} - w*s_p, so results keep their bits. m = 10
// and 32 (the main path, the reduced solve's levels) are compiled as their
// own cases, the row loop unrolled in full at m = 10.
#include <cstdint>

#include "common.cuh"

template <typename T>
__device__ __forceinline__ T back_sub(T y, T v, T w, T sl, T sp) {
  return y - v * sl - w * sp;
}

__device__ __forceinline__ float4 back_sub(float4 y, float4 v, float4 w, float4 sl, float4 sp) {
  return make_float4(back_sub(y.x, v.x, w.x, sl.x, sp.x), back_sub(y.y, v.y, w.y, sl.y, sp.y),
                     back_sub(y.z, v.z, w.z, sl.z, sp.z), back_sub(y.w, v.w, w.w, sl.w, sp.w));
}

__device__ __forceinline__ double2 back_sub(double2 y, double2 v, double2 w, double2 sl,
                                            double2 sp) {
  return make_double2(back_sub(y.x, v.x, w.x, sl.x, sp.x), back_sub(y.y, v.y, w.y, sl.y, sp.y));
}

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static __device__ __forceinline__ float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};
template <>
struct Vec16<double> {
  using type = double2;
  static __device__ __forceinline__ double2 zero() { return make_double2(0.0, 0.0); }
};

template <typename T>
struct Scalar {
  using type = T;
  static __device__ __forceinline__ T zero() { return T(0); }
};

constexpr int kThreads = 256;
// Lane groups a CUDA block at most.
constexpr int kMaxGroups = 32;
// From this many (block, lane group) columns, one thread a column.
constexpr long long kManyColumns = 1LL << 17;
// Below kManyColumns, threads a (block, lane group) up to this many threads
// in all, at most kMaxRowThreads.
constexpr long long kFewThreads = 1LL << 16;
constexpr int kMaxRowThreads = 16;
// Groups in the two shared-memory buffers of s rows at ry >= 2:
// (py + 1) * gx each, gx * py <= kThreads / 2.
constexpr int kShared = 2 * (kThreads / 2 + kMaxGroups);

// The tiles of one CUDA block: G is the group type (T, or its 16-byte
// vector), ng the groups a row; blockDim = (lane groups gx, RY, blocks a
// tile py), gx * RY * py <= kThreads. With RY > 1, ``sh`` holds two
// buffers of (py + 1) * gx groups.
template <typename G, typename Z, int M, int RY>
__device__ __forceinline__ void stage3_tiles(const G* __restrict__ y, const G* __restrict__ v,
                                             const G* __restrict__ w, const G* __restrict__ s,
                                             G* __restrict__ x, long long nblocks, long long ng,
                                             int m_rt, G* sh) {
  const int m = M > 0 ? M : m_rt;
  const int mi = m - 1;
  const int gx = blockDim.x;
  const int py = blockDim.z;
  const int tx = threadIdx.x, ty = threadIdx.y, tz = threadIdx.z;
  const long long iv = static_cast<long long>(blockIdx.x) * gx + tx;
  const bool live = iv < ng;
  const long long step = static_cast<long long>(gridDim.y) * py;
  int parity = 0;
  for (long long p0 = static_cast<long long>(blockIdx.y) * py; p0 < nblocks;
       p0 += step, parity ^= 1) {
    const long long p = p0 + tz;
    G sl, sp;
    if constexpr (RY == 1) {
      if (!live || p >= nblocks) continue;
      sp = s[p * ng + iv];
      sl = p == 0 ? Z::zero() : s[(p - 1) * ng + iv];
    } else {
      // Row 0 of the buffer is s_{p0-1}, row 1 + tz is s_{p0+tz}. Two
      // buffers in turn: a thread still reading the last tile's is past
      // this tile's barrier before that buffer is written again.
      G* buf = sh + parity * (py + 1) * gx;
      if (ty == 0 && live) {
        if (p < nblocks) buf[(tz + 1) * gx + tx] = s[p * ng + iv];
        if (tz == 0) buf[tx] = p0 == 0 ? Z::zero() : s[(p0 - 1) * ng + iv];
      }
      __syncthreads();
      if (!live || p >= nblocks) continue;
      sl = buf[tz * gx + tx];
      sp = buf[(tz + 1) * gx + tx];
    }
    const G* yp = y + p * mi * ng + iv;
    const G* vp = v + p * mi * ng + iv;
    const G* wp = w + p * mi * ng + iv;
    G* xp = x + p * m * ng + iv;
    const int k0 = RY == 1 ? 0 : ty;
    if constexpr (M == 10) {
#pragma unroll
      for (int k = k0; k < m; k += RY) {
        xp[k * ng] = k < mi ? back_sub(yp[k * ng], vp[k * ng], wp[k * ng], sl, sp) : sp;
      }
    } else {
#pragma unroll 8
      for (int k = k0; k < m; k += RY) {
        xp[k * ng] = k < mi ? back_sub(yp[k * ng], vp[k * ng], wp[k * ng], sl, sp) : sp;
      }
    }
  }
}

template <typename T, int M, int RY>
__global__ void __launch_bounds__(kThreads)
    stage3_wide_kernel(const T* __restrict__ y, const T* __restrict__ v,
                       const T* __restrict__ w, const T* __restrict__ s, T* __restrict__ x,
                       long long nblocks, long long nsys, int m, bool vec) {
  using Vt = typename Vec16<T>::type;
  __shared__ Vt sh[RY == 1 ? 1 : kShared];
  if (vec) {
    stage3_tiles<Vt, Vec16<T>, M, RY>(
        reinterpret_cast<const Vt*>(y), reinterpret_cast<const Vt*>(v),
        reinterpret_cast<const Vt*>(w), reinterpret_cast<const Vt*>(s),
        reinterpret_cast<Vt*>(x), nblocks, nsys / (16 / static_cast<long long>(sizeof(T))), m,
        sh);
  } else {
    stage3_tiles<T, Scalar<T>, M, RY>(y, v, w, s, x, nblocks, nsys, m, reinterpret_cast<T*>(sh));
  }
}

// The compiled case for blocks of m rows and RY threads a column.
template <typename T, int RY>
static auto pick_kernel(int m) {
  return m == 10 ? &stage3_wide_kernel<T, 10, RY>
                 : (m == 32 ? &stage3_wide_kernel<T, 32, RY> : &stage3_wide_kernel<T, 0, RY>);
}

static inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<std::uintptr_t>(ptr) & 15) == 0;
}

template <typename T>
static int launch_stage3_wide(const void* y, const void* v, const void* w, const void* s,
                              void* x, long long nblocks, long long nsys, int m,
                              void* stream) {
  if (nblocks * nsys == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = (nsys * static_cast<long long>(sizeof(T))) % 16 == 0 && aligned16(y) &&
                   aligned16(v) && aligned16(w) && aligned16(s) && aligned16(x);
  const long long ng = vec ? nsys / (16 / static_cast<long long>(sizeof(T))) : nsys;
  const long long columns = nblocks * ng;
  int ry = 1;  // threads a (block, lane group)
  if (columns < kManyColumns) {
    ry = 2;
    while (ry < kMaxRowThreads && columns * ry < kFewThreads) ry *= 2;
  }
  int gx = 1;  // lane groups a CUDA block: a power of two up to kMaxGroups
  while (gx < kMaxGroups && gx < ng && 2 * gx * ry <= kThreads) gx *= 2;
  const int per = kThreads / (gx * ry);
  const int py = per < 64 ? per : 64;  // blocks p a tile (blockDim.z: at most 64)
  const long long tiles = (nblocks + py - 1) / py;
  const dim3 grid(static_cast<unsigned int>((ng + gx - 1) / gx),
                  static_cast<unsigned int>(tiles < 65535 ? tiles : 65535));
  auto kernel = ry == 1   ? pick_kernel<T, 1>(m)
                : ry == 2 ? pick_kernel<T, 2>(m)
                : ry == 4 ? pick_kernel<T, 4>(m)
                : ry == 8 ? pick_kernel<T, 8>(m)
                          : pick_kernel<T, kMaxRowThreads>(m);
  kernel<<<grid, dim3(gx, ry, py), 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y), static_cast<const T*>(v), static_cast<const T*>(w),
      static_cast<const T*>(s), static_cast<T*>(x), nblocks, nsys, m, vec);
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
