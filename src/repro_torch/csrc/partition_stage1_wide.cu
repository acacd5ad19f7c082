// Stage 1 of the partition method on the interleaved layout: per-block
// spikes and reduced rows, with the systems on the fastest axis.
//
// Replaces the TPU kernel src/repro/kernels/partition_stage1/stage1.py
// (_stage1_kernel_wide, through stage1_tiled_wide) together with the
// reduced-row assembly of src/repro/kernels/partition_stage1/ops.py
// (_stage1_impl_wide). It also runs every level of the wide reduced solve
// (kernels/thomas/ops.py) with m = the level's r.
//
// Operands are (nrows, B) rows: row r of lane i at r*B + i, cut into
// P = ceil(nrows / m) blocks of m rows. Rows at and past nrows read as
// identity rows (d = 1, the rest 0) and are never loaded, so a caller's
// (n, B) rows go in as they are whatever n is. With zero_ends, each lane's
// dl[0] and du[nrows-1] read as zero, as a Thomas solve ignores them.
// Outputs: spikes y, v, w of shape (P, m-1, B) and the reduced rows
// red_dl/red_d/red_du/red_b of shape (red_rows, B), red_rows >= P: rows P
// and past are identity rows, a level's next operands.
//
// Bound: bytes. Each (block, lane) reads 4m values and writes 3(m-1)+4,
// with about 10 flops per row, far below the card's 34 (fp64) / 67 (fp32)
// TFLOP/s for what 3.35 TB/s delivers. The recurrence is serial in m, but
// the P*B (block, lane) columns are independent.
//
// Design: one CUDA block per tile of tp consecutive partition blocks by
// TL = 128 / sizeof(T) lanes (16 fp64, 32 fp32): each row of a tile is one
// 128-byte line of device memory. A thread walks one (block, lane) column.
//   1. All of the tile's loads are issued at once with cp.async into
//      shared memory, laid out [block][row][lane] as in device memory: 16
//      bytes a copy when B*sizeof(T) and the operands' addresses allow,
//      one element a copy otherwise. Rows past nrows are written as
//      identity rows in shared memory, never loaded.
//   2. Each thread walks its column in shared memory in the order of
//      operations of the reference stage: one forward elimination shared
//      by the three right-hand sides, then back substitution. Lanes are
//      the fastest axis in shared memory too, so the walk is free of bank
//      conflicts. Everything stays in place: the modified diagonal
//      overwrites d, y overwrites b, v overwrites dl, w overwrites du. No
//      spike is written to device memory before it is final, and none is
//      read back.
//   3. The reduced rows need the next block's first spike row, so tiles
//      overlap by one block: the last block of a tile is a halo, walked and
//      not stored, and every other block's thread builds its reduced row
//      from shared memory. The next-block shift is zero at p = P-1, which
//      keeps ragged identity-block padding exact. The tile that holds
//      block P-1 also writes the identity rows past P.
//   4. The owned blocks' spikes go to device memory with coalesced 16-byte
//      stores (one element a store when B*sizeof(T) or an output's address
//      does not allow it).
// Tile shape: tp = kTileBytes / (4 m 128 bytes), at most kMaxSpan and at
// least kMinSpan. At m = 10 that is 14 blocks (70 KB, 1/13 of the walks
// are halos, three tiles an SM); at m = 32, the reduced solve's levels, 6
// (96 KB, two tiles an SM, a fifth of the walks halos). In a sweep of
// budgets from 48 to 144 KB on an H100, 72 KB was the fastest or close to
// it at m = 10 (three tiles an SM also shorten the last wave at P = 2,000,
// B = 64), and at m = 32 six blocks a tile beat four. m = 10 and 32 are
// compiled as their own cases, with the walk unrolled. A block's arithmetic does not depend on the tile it falls in,
// so the halo's walk gives the same bits as its owner's.
// Blocks of more than kMaxTileM rows (from m = 65) are walked straight
// from device memory by one thread each, the modified diagonal parked in
// w's slots, and a second kernel assembles their reduced rows.
#include <cstdint>

#include "common.cuh"

constexpr int kMaxTileM = 64;
constexpr int kTileBytes = 72 * 1024;
constexpr int kMinSpan = 6;  // 4 * 6 * 64 * 128 bytes, 192 KB at m = 64, fits a block
constexpr int kMaxSpan = 16;
constexpr int kLineBytes = 128;

// Partition blocks per tile (the halo included) for blocks of m rows; 0
// past the tile path. Independent of the element size: a tile row is one
// line.
static inline int tile_blocks(int m) {
  if (m > kMaxTileM) return 0;
  const int tp = kTileBytes / (4 * m * kLineBytes);
  return tp < kMinSpan ? kMinSpan : (tp > kMaxSpan ? kMaxSpan : tp);
}

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async_elem(T* dst, const T* src) {
  const unsigned int s = static_cast<unsigned int>(__cvta_generic_to_shared(dst));
  if constexpr (sizeof(T) == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
  }
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// M > 0: blocks of M rows, compiled with the walk unrolled; M = 0: m_rt.
template <typename T, int M>
__global__ void __launch_bounds__(512, 2)
    stage1_wide_tile_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                            const T* __restrict__ du, const T* __restrict__ b,
                            T* __restrict__ y, T* __restrict__ v, T* __restrict__ w,
                            T* __restrict__ red_dl, T* __restrict__ red_d,
                            T* __restrict__ red_du, T* __restrict__ red_b, long long nblocks,
                            long long nsys, long long nrows, long long red_rows, int m_rt,
                            bool zero_ends, bool vec_in, bool vec_out) {
  constexpr int TL = kLineBytes / static_cast<int>(sizeof(T));  // lanes a tile
  constexpr int V = 16 / static_cast<int>(sizeof(T));           // elements a 16-byte copy
  constexpr int CPR = TL / V;                                   // 16-byte copies a tile row
  const int m = M > 0 ? M : m_rt;
  const int mi = m - 1;  // interior rows
  const int tp = blockDim.y;
  const int nthreads = TL * tp;
  const int t = threadIdx.y * TL + threadIdx.x;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tile = tp * m * TL;
  T* s_dl = reinterpret_cast<T*>(smem_raw);
  T* s_d = s_dl + tile;
  T* s_du = s_d + tile;
  T* s_b = s_du + tile;

  const long long B = nsys;
  const long long p0 = static_cast<long long>(blockIdx.x) * (tp - 1);  // tp-1 owned blocks a tile
  const int nb = static_cast<int>(min(static_cast<long long>(tp), nblocks - p0));  // walked
  const int nown = min(tp - 1, nb);  // stored; a full tile's last block is the halo
  const long long lane0 = static_cast<long long>(blockIdx.y) * TL;
  const int nl = static_cast<int>(min(static_cast<long long>(TL), B - lane0));
  const long long r0 = p0 * m;
  const int nr = nb * m;
  const int nload = static_cast<int>(max(0LL, min(static_cast<long long>(nr), nrows - r0)));

  // 1. The tile's rows in, all copies in flight at once; rows past nrows
  // are identity rows. Row r of the tile, lane l sits at r*TL + l.
  if (vec_in) {  // nl is a multiple of V here
    for (int c = t; c < nload * CPR; c += nthreads) {
      const int r = c / CPR;
      const int l = (c - r * CPR) * V;
      if (l >= nl) continue;
      const long long g = (r0 + r) * B + lane0 + l;
      const int s = r * TL + l;
      cp_async16(s_dl + s, dl + g);
      cp_async16(s_d + s, d + g);
      cp_async16(s_du + s, du + g);
      cp_async16(s_b + s, b + g);
    }
  } else {
    for (int c = t; c < nload * TL; c += nthreads) {
      const int r = c / TL;
      const int l = c - r * TL;
      if (l >= nl) continue;
      const long long g = (r0 + r) * B + lane0 + l;
      const int s = r * TL + l;
      cp_async_elem(s_dl + s, dl + g);
      cp_async_elem(s_d + s, d + g);
      cp_async_elem(s_du + s, du + g);
      cp_async_elem(s_b + s, b + g);
    }
  }
  for (int s = nload * TL + t; s < nr * TL; s += nthreads) {
    s_dl[s] = T(0);
    s_d[s] = T(1);
    s_du[s] = T(0);
    s_b[s] = T(0);
  }
  cp_async_wait_all();
  __syncthreads();

  // 2. The walk of column (block blk, lane): forward elimination, shared
  // factorization, spikes seeded per their RHS; then back substitution.
  const int lane = threadIdx.x;
  const int blk = threadIdx.y;
  const long long p = p0 + blk;
  if (blk < nb && lane < nl) {
    const int o = blk * m * TL + lane;
    T* pdl = s_dl + o;
    T* pd = s_d + o;
    T* pdu = s_du + o;
    T* pb = s_b + o;
    if (zero_ends) {
      const long long e = nrows - 1 - p * m;  // du[nrows-1]'s row in this block
      if (e >= 0 && e < m) pdu[e * TL] = T(0);
      if (p == 0) pdl[0] = T(0);
    }
    T dhat = pd[0];
    T yc = pb[0];
    T vc = pdl[0];
#pragma unroll
    for (int k = 1; k < mi; ++k) {
      const T wgt = pdl[k * TL] / dhat;
      dhat = pd[k * TL] - wgt * pdu[(k - 1) * TL];
      yc = pb[k * TL] - wgt * yc;
      vc = -wgt * vc;
      pd[k * TL] = dhat;
      pb[k * TL] = yc;
      pdl[k * TL] = vc;
    }
    const int last = mi - 1;
    yc = yc / dhat;
    vc = vc / dhat;
    // The w spike's forward image is du[m-2] e_last, so its seed is direct.
    T wc = pdu[last * TL] / dhat;
    pb[last * TL] = yc;
    pdl[last * TL] = vc;
    pdu[last * TL] = wc;
#pragma unroll
    for (int k = last - 1; k >= 0; --k) {
      const T du_k = pdu[k * TL];
      const T dhat_k = pd[k * TL];
      yc = (pb[k * TL] - du_k * yc) / dhat_k;
      vc = (pdl[k * TL] - du_k * vc) / dhat_k;
      wc = (T(0) - du_k * wc) / dhat_k;
      pb[k * TL] = yc;
      pdl[k * TL] = vc;
      pdu[k * TL] = wc;
    }
  }
  __syncthreads();

  // 3. Reduced rows from shared memory: the block's last row (row m-1,
  // untouched by the walk), its last spike row, and the next block's first
  // spike row (the halo's at a tile's end; zero past P-1).
  if (blk < nown && lane < nl) {
    const int o = blk * m * TL + lane;
    const int il = o + mi * TL;
    const int kl = o + (mi - 1) * TL;
    T y_nf = T(0), v_nf = T(0), w_nf = T(0);
    if (p + 1 < nblocks) {
      const int on = o + m * TL;
      y_nf = s_b[on];
      v_nf = s_dl[on];
      w_nf = s_du[on];
    }
    const T aL = s_dl[il];
    const T bL = s_d[il];
    const T cL = s_du[il];
    const T dL = s_b[il];
    const long long g = p * B + lane0 + lane;
    red_dl[g] = -aL * s_dl[kl];
    red_d[g] = bL - aL * s_du[kl] - cL * v_nf;
    red_du[g] = -cL * w_nf;
    red_b[g] = dL - aL * s_b[kl] - cL * y_nf;
  }
  if (p0 + nb == nblocks && lane < nl) {  // the identity rows past P
    for (long long r = nblocks + blk; r < red_rows; r += tp) {
      const long long g = r * B + lane0 + lane;
      red_dl[g] = T(0);
      red_d[g] = T(1);
      red_du[g] = T(0);
      red_b[g] = T(0);
    }
  }

  // 4. The owned blocks' spikes out: spike row j of the tile is interior
  // row j % (m-1) of block j / (m-1), at (p0*(m-1) + j)*B in device memory.
  const long long e0 = p0 * mi;
  const int ns = nown * mi;
  if (vec_out) {
    using Vt = typename Vec16<T>::type;
    for (int c = t; c < ns * CPR; c += nthreads) {
      const int j = c / CPR;
      const int l = (c - j * CPR) * V;
      if (l >= nl) continue;
      const int bj = j / mi;
      const int s = (bj * m + (j - bj * mi)) * TL + l;
      const long long g = (e0 + j) * B + lane0 + l;
      *reinterpret_cast<Vt*>(y + g) = *reinterpret_cast<const Vt*>(s_b + s);
      *reinterpret_cast<Vt*>(v + g) = *reinterpret_cast<const Vt*>(s_dl + s);
      *reinterpret_cast<Vt*>(w + g) = *reinterpret_cast<const Vt*>(s_du + s);
    }
  } else {
    for (int c = t; c < ns * TL; c += nthreads) {
      const int j = c / TL;
      const int l = c - j * TL;
      if (l >= nl) continue;
      const int bj = j / mi;
      const int s = (bj * m + (j - bj * mi)) * TL + l;
      const long long g = (e0 + j) * B + lane0 + l;
      y[g] = s_b[s];
      v[g] = s_dl[s];
      w[g] = s_du[s];
    }
  }
}

// Blocks of more than kMaxTileM rows: one thread per (block, lane) walks
// its rows straight from device memory, the modified diagonal in w's slots
// until the backward sweep overwrites it.
template <typename T>
__device__ __forceinline__ T row_or(const T* a, long long r, long long nrows, long long B,
                                    long long i, T fill) {
  return r < nrows ? a[r * B + i] : fill;
}

template <typename T>
__global__ void stage1_wide_direct_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                                          const T* __restrict__ du, const T* __restrict__ b,
                                          T* __restrict__ y, T* __restrict__ v,
                                          T* __restrict__ w, long long nblocks, long long nsys,
                                          long long nrows, int m, bool zero_ends) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= nblocks * nsys) return;
  const long long B = nsys;
  const long long p = g / B;
  const long long i = g - p * B;
  const int mi = m - 1;
  const long long r0 = p * m;
  const long long out0 = p * mi * B + i;
  T* yp = y + out0;
  T* vp = v + out0;
  T* wp = w + out0;
  auto du_at = [&](int k) -> T {
    const long long r = r0 + k;
    return (zero_ends && r == nrows - 1) ? T(0) : row_or(du, r, nrows, B, i, T(0));
  };

  T dhat = row_or(d, r0, nrows, B, i, T(1));
  T yc = row_or(b, r0, nrows, B, i, T(0));
  T vc = (zero_ends && p == 0) ? T(0) : row_or(dl, r0, nrows, B, i, T(0));
  wp[0] = dhat;
  yp[0] = yc;
  vp[0] = vc;
  for (int k = 1; k < mi; ++k) {
    const long long o = k * B;
    const T wgt = row_or(dl, r0 + k, nrows, B, i, T(0)) / dhat;
    dhat = row_or(d, r0 + k, nrows, B, i, T(1)) - wgt * du_at(k - 1);
    yc = row_or(b, r0 + k, nrows, B, i, T(0)) - wgt * yc;
    vc = -wgt * vc;
    wp[o] = dhat;
    yp[o] = yc;
    vp[o] = vc;
  }
  const int last = mi - 1;
  const long long lo = static_cast<long long>(last) * B;
  yc = yc / dhat;
  vc = vc / dhat;
  T wc = du_at(last) / dhat;
  yp[lo] = yc;
  vp[lo] = vc;
  wp[lo] = wc;
  for (int k = last - 1; k >= 0; --k) {
    const long long o = k * B;
    const T du_k = du_at(k);
    const T dhat_k = wp[o];
    yc = (yp[o] - du_k * yc) / dhat_k;
    vc = (vp[o] - du_k * vc) / dhat_k;
    wc = (T(0) - du_k * wc) / dhat_k;
    yp[o] = yc;
    vp[o] = vc;
    wp[o] = wc;
  }
}

// The reduced rows of blocks walked from device memory, and the identity
// rows past P: one thread per (reduced row, lane).
template <typename T>
__global__ void stage1_wide_reduced_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                                           const T* __restrict__ du, const T* __restrict__ b,
                                           const T* __restrict__ y, const T* __restrict__ v,
                                           const T* __restrict__ w, T* __restrict__ red_dl,
                                           T* __restrict__ red_d, T* __restrict__ red_du,
                                           T* __restrict__ red_b, long long nblocks,
                                           long long nsys, long long nrows, long long red_rows,
                                           int m, bool zero_ends) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= red_rows * nsys) return;
  const long long B = nsys;
  const long long p = g / B;
  const long long i = g - p * B;
  if (p >= nblocks) {
    red_dl[g] = T(0);
    red_d[g] = T(1);
    red_du[g] = T(0);
    red_b[g] = T(0);
    return;
  }
  const int mi = m - 1;
  const long long row = p * m + mi;  // the block's last (interface) row
  const T aL = row_or(dl, row, nrows, B, i, T(0));
  const T bL = row_or(d, row, nrows, B, i, T(1));
  const T cL = (zero_ends && row == nrows - 1) ? T(0) : row_or(du, row, nrows, B, i, T(0));
  const T dL = row_or(b, row, nrows, B, i, T(0));
  const long long lastk = (p * mi + (mi - 1)) * B + i;
  T y_nf = T(0), v_nf = T(0), w_nf = T(0);
  if (p + 1 < nblocks) {
    const long long first = (p + 1) * mi * B + i;
    y_nf = y[first];
    v_nf = v[first];
    w_nf = w[first];
  }
  red_dl[g] = -aL * v[lastk];
  red_d[g] = bL - aL * w[lastk] - cL * v_nf;
  red_du[g] = -cL * w_nf;
  red_b[g] = dL - aL * y[lastk] - cL * y_nf;
}

static inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<std::uintptr_t>(ptr) & 15) == 0;
}

template <typename T>
static int launch_stage1_wide(const void* dl_, const void* d_, const void* du_, const void* b_,
                              void* y_, void* v_, void* w_, void* red_dl_, void* red_d_,
                              void* red_du_, void* red_b_, long long nblocks, long long nsys,
                              long long nrows, long long red_rows, int m, int zero_ends_,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nblocks * nsys == 0) return static_cast<int>(cudaGetLastError());
  const bool zero_ends = zero_ends_ != 0;
  const T* dl = static_cast<const T*>(dl_);
  const T* d = static_cast<const T*>(d_);
  const T* du = static_cast<const T*>(du_);
  const T* b = static_cast<const T*>(b_);
  T* y = static_cast<T*>(y_);
  T* v = static_cast<T*>(v_);
  T* w = static_cast<T*>(w_);
  T* red_dl = static_cast<T*>(red_dl_);
  T* red_d = static_cast<T*>(red_d_);
  T* red_du = static_cast<T*>(red_du_);
  T* red_b = static_cast<T*>(red_b_);
  const int tp = tile_blocks(m);
  if (tp > 0) {
    constexpr int TL = kLineBytes / static_cast<int>(sizeof(T));
    const bool rows16 = (nsys * static_cast<long long>(sizeof(T))) % 16 == 0;
    const bool vec_in = rows16 && aligned16(dl) && aligned16(d) && aligned16(du) && aligned16(b);
    const bool vec_out = rows16 && aligned16(y) && aligned16(v) && aligned16(w);
    auto kernel = m == 10 ? &stage1_wide_tile_kernel<T, 10>
                          : (m == 32 ? &stage1_wide_tile_kernel<T, 32> : &stage1_wide_tile_kernel<T, 0>);
    const size_t smem = 4ull * tp * m * kLineBytes;
    // Above 48 KB of dynamic shared memory needs the attribute; it is per
    // device, so it is set at every launch.
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    const dim3 grid(static_cast<unsigned int>((nblocks + tp - 2) / (tp - 1)),
                    static_cast<unsigned int>((nsys + TL - 1) / TL));
    kernel<<<grid, dim3(TL, tp), smem, s>>>(dl, d, du, b, y, v, w, red_dl, red_d, red_du, red_b,
                                            nblocks, nsys, nrows, red_rows, m, zero_ends, vec_in,
                                            vec_out);
    return static_cast<int>(cudaGetLastError());
  }
  stage1_wide_direct_kernel<T><<<repro_grid(nblocks * nsys), REPRO_THREADS, 0, s>>>(
      dl, d, du, b, y, v, w, nblocks, nsys, nrows, m, zero_ends);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stage1_wide_reduced_kernel<T><<<repro_grid(red_rows * nsys), REPRO_THREADS, 0, s>>>(
      dl, d, du, b, y, v, w, red_dl, red_d, red_du, red_b, nblocks, nsys, nrows, red_rows, m,
      zero_ends);
  return static_cast<int>(cudaGetLastError());
}

// nblocks: P = ceil(nrows / m); nsys: B lanes; nrows: rows per lane, the
// operands' first dimension; red_rows >= P: rows of the reduced arrays;
// zero_ends: read each lane's dl[0] and du[nrows-1] as zero.
extern "C" int partition_stage1_wide_f32(const void* dl, const void* d, const void* du,
                                         const void* b, void* y, void* v, void* w,
                                         void* red_dl, void* red_d, void* red_du,
                                         void* red_b, long long nblocks, long long nsys,
                                         long long nrows, long long red_rows, int m,
                                         int zero_ends, void* stream) {
  return launch_stage1_wide<float>(dl, d, du, b, y, v, w, red_dl, red_d, red_du, red_b,
                                   nblocks, nsys, nrows, red_rows, m, zero_ends, stream);
}

extern "C" int partition_stage1_wide_f64(const void* dl, const void* d, const void* du,
                                         const void* b, void* y, void* v, void* w,
                                         void* red_dl, void* red_d, void* red_du,
                                         void* red_b, long long nblocks, long long nsys,
                                         long long nrows, long long red_rows, int m,
                                         int zero_ends, void* stream) {
  return launch_stage1_wide<double>(dl, d, du, b, y, v, w, red_dl, red_d, red_du, red_b,
                                    nblocks, nsys, nrows, red_rows, m, zero_ends, stream);
}

// Partition blocks per tile (the halo included) for blocks of m rows; 0
// where the blocks are walked from device memory.
extern "C" int partition_stage1_wide_tile_blocks(int m) { return tile_blocks(m); }
