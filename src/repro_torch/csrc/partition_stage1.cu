// Stage 1 of the partition method: per-block spikes and reduced rows.
//
// Replaces the TPU kernel src/repro/kernels/partition_stage1/stage1.py
// (_stage1_kernel, through stage1_tiled / stage1_tiled_batched) together
// with the reduced-row assembly of src/repro/kernels/partition_stage1/ops.py
// (_stage1_impl / _stage1_impl_batched). It also runs every level of the
// reduced solve in csrc/thomas.cu's wrapper, with m = the level's r.
//
// Operands are the row-major (nsys, P, m) view of (nsys, P*m) diagonals:
// every partition block is m contiguous rows, and the nsys*P blocks of all
// systems are one contiguous run. Outputs: spikes y, v, w of shape
// (nsys, P, m-1) and the reduced rows red_dl/red_d/red_du/red_b, P per
// system at a system stride red_ss >= P, with identity rows (d = 1, the
// rest 0) in the red_ss - P slots past each system's last: a level of the
// reduced solve writes them straight into the next level's padded
// operands. With zero_ends, each system's dl[0] and du[n-1] read as zero,
// as a Thomas solve ignores them (the levels' first Stage 1 reads the
// caller's operands).
//
// Bound: bytes. Each block reads 4m values and writes 3(m-1)+4, with about
// 10 flops per row, far below the card's 34 (fp64) / 67 (fp32) TFLOP/s for
// what 3.35 TB/s delivers; the per-block recurrence is serial in m but the
// P blocks are independent.
//
// Design: one CUDA block of TB threads per span of TB consecutive partition
// blocks, staged through shared memory, so that device memory sees only
// coalesced traffic (one thread per block reading straight from device
// memory makes neighbouring threads touch addresses m apart):
//   1. The span's TB*m contiguous elements of each operand are copied into
//      shared memory with cp.async, consecutive threads on consecutive
//      addresses, the tail of the last span masked. Each element is its own
//      4- or 8-byte copy: a block's rows sit at an odd row pitch (m, or m+1
//      when m is even) so that the walk below is free of bank conflicts,
//      and that pitch leaves no 16-byte run aligned in shared memory for
//      16-byte copies or a bulk copy to fill.
//   2. Each thread walks its own block's m rows in shared memory, in the
//      same order of operations as the reference stage: a forward
//      elimination shared by the three right-hand sides, then back
//      substitution. Everything stays in place: the modified diagonal
//      overwrites d, y overwrites b, v overwrites dl and w overwrites du,
//      so the tile is the only shared memory and nothing round-trips
//      through device memory.
//   3. The spikes of the span (TB*(m-1) contiguous values each) go back to
//      device memory from shared memory with coalesced stores.
//   4. The reduced rows need the next block's first spike row, so spans
//      overlap by one block: the last thread of a span walks the next
//      span's first block (a halo) and stores nothing for it, and every
//      other thread assembles its reduced row from shared memory. (A second
//      kernel reading the spikes back from device memory took 32-45 % more
//      time on an H100; PERF.md.) The next-block shift stops at
//      each system's last block (zero past it), so it never crosses from
//      one system into the next.
// A block is one thread's work and its arithmetic does not depend on the
// span it falls in, so chunked and unchunked Stage 1 agree bit for bit.
// Blocks of more than kMaxTileM rows (no shared-memory tile fits a useful
// span) are walked straight from device memory by one thread each, and a
// second kernel assembles their reduced rows.
#include "common.cuh"

// Largest m staged through shared memory, and the tile budget per CUDA
// block: at most 72 KB keeps three or more spans resident on an SM, so one
// span's copies overlap another's walk.
constexpr int kMaxTileM = 64;
constexpr int kTileBytes = 72 * 1024;

__host__ __device__ inline int row_pitch(int m) { return m | 1; }

// Threads (= partition blocks) per span for blocks of m rows of es bytes.
static inline int span_blocks(int m, int es) {
  int tb = 256;
  while (tb > 32 && 4LL * tb * row_pitch(m) * es > kTileBytes) tb /= 2;
  return tb;
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

// Reduced row g, and after a system's last block the identity rows that
// pad it to red_ss.
template <typename T>
__device__ __forceinline__ void reduced_row(T aL, T bL, T cL, T dL, T y_last, T v_last,
                                            T w_last, T y_nf, T v_nf, T w_nf, T* red_dl,
                                            T* red_d, T* red_du, T* red_b, long long g,
                                            long long bps, long long red_ss) {
  const long long sys = g / bps;
  const long long p = g - sys * bps;
  const long long o = sys * red_ss + p;
  red_dl[o] = -aL * v_last;
  red_d[o] = bL - aL * w_last - cL * v_nf;
  red_du[o] = -cL * w_nf;
  red_b[o] = dL - aL * y_last - cL * y_nf;
  if (p + 1 == bps) {
    for (long long k = o + 1; k < (sys + 1) * red_ss; ++k) {
      red_dl[k] = T(0);
      red_d[k] = T(1);
      red_du[k] = T(0);
      red_b[k] = T(0);
    }
  }
}

template <typename T>
__global__ void stage1_tile_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                                   const T* __restrict__ du, const T* __restrict__ b,
                                   T* __restrict__ y, T* __restrict__ v, T* __restrict__ w,
                                   T* __restrict__ red_dl, T* __restrict__ red_d,
                                   T* __restrict__ red_du, T* __restrict__ red_b,
                                   long long nblocks, long long bps, long long red_ss, int m,
                                   bool zero_ends) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tb = blockDim.x;
  const int pitch = row_pitch(m);
  T* s_dl = reinterpret_cast<T*>(smem_raw);
  T* s_d = s_dl + tb * pitch;
  T* s_du = s_d + tb * pitch;
  T* s_b = s_du + tb * pitch;

  const int own = tb - 1;  // blocks whose results this span stores; the last is the halo
  const long long g0 = static_cast<long long>(blockIdx.x) * own;
  const int nb = static_cast<int>(min(static_cast<long long>(tb), nblocks - g0));  // loaded
  const int nown = min(own, nb);
  const int t = threadIdx.x;
  const int mi = m - 1;  // interior rows

  // 1. Coalesced copies in: element e of the span is row e % m of block
  // e / m. The (block, row) pair advances by tb elements a step.
  {
    const long long e0 = g0 * m;
    const int ne = nb * m;
    const int step_b = tb / m, step_r = tb % m;
    int bt = t / m, br = t - (t / m) * m;
    for (int e = t; e < ne; e += tb) {
      const int s = bt * pitch + br;
      cp_async_elem(s_dl + s, dl + e0 + e);
      cp_async_elem(s_d + s, d + e0 + e);
      cp_async_elem(s_du + s, du + e0 + e);
      cp_async_elem(s_b + s, b + e0 + e);
      bt += step_b;
      br += step_r;
      if (br >= m) {
        br -= m;
        ++bt;
      }
    }
    cp_async_wait_all();
  }
  __syncthreads();

  // 2. The walk: forward elimination, shared factorization; spikes seeded
  // per their RHS, all in place (dhat in d, y in b, v in dl, w in du).
  if (t < nb) {
    T* pdl = s_dl + t * pitch;
    T* pd = s_d + t * pitch;
    T* pdu = s_du + t * pitch;
    T* pb = s_b + t * pitch;
    T dhat = pd[0];
    T yc = pb[0];
    T vc = (zero_ends && (g0 + t) % bps == 0) ? T(0) : pdl[0];
    pdl[0] = vc;
    for (int i = 1; i < mi; ++i) {
      const T wgt = pdl[i] / dhat;
      dhat = pd[i] - wgt * pdu[i - 1];
      yc = pb[i] - wgt * yc;
      vc = -wgt * vc;
      pd[i] = dhat;
      pb[i] = yc;
      pdl[i] = vc;
    }
    // Backward substitution, all three spikes per step.
    const int last = mi - 1;
    yc = yc / dhat;
    vc = vc / dhat;
    // The w spike's forward image is du[m-2] e_last, so its seed is direct.
    T wc = pdu[last] / dhat;
    pb[last] = yc;
    pdl[last] = vc;
    pdu[last] = wc;
    for (int i = last - 1; i >= 0; --i) {
      const T du_i = pdu[i];
      const T dhat_i = pd[i];
      yc = (pb[i] - du_i * yc) / dhat_i;
      vc = (pdl[i] - du_i * vc) / dhat_i;
      wc = (T(0) - du_i * wc) / dhat_i;
      pb[i] = yc;
      pdl[i] = vc;
      pdu[i] = wc;
    }
  }
  __syncthreads();

  // 4. Reduced rows from shared memory: the block's last row (row
  // m-1, untouched by the walk), its last spike row, and the next block's
  // first spike row, which the halo provides at the span's end.
  if (t < nown) {
    const long long g = g0 + t;
    const int o = t * pitch;
    const bool last = (g % bps) + 1 == bps;
    T y_nf = T(0), v_nf = T(0), w_nf = T(0);
    if (!last) {
      const int on = o + pitch;
      y_nf = s_b[on];
      v_nf = s_dl[on];
      w_nf = s_du[on];
    }
    const T cL = (zero_ends && last) ? T(0) : s_du[o + mi];
    reduced_row(s_dl[o + mi], s_d[o + mi], cL, s_b[o + mi], s_b[o + mi - 1], s_dl[o + mi - 1],
                s_du[o + mi - 1], y_nf, v_nf, w_nf, red_dl, red_d, red_du, red_b, g, bps,
                red_ss);
  }

  // 3. Coalesced stores of the owned blocks' spikes: element e is interior
  // row e % (m-1) of block e / (m-1).
  {
    const long long e0 = g0 * mi;
    const int ne = nown * mi;
    const int step_b = tb / mi, step_r = tb % mi;
    int bt = t / mi, br = t - (t / mi) * mi;
    for (int e = t; e < ne; e += tb) {
      const int s = bt * pitch + br;
      y[e0 + e] = s_b[s];
      v[e0 + e] = s_dl[s];
      w[e0 + e] = s_du[s];
      bt += step_b;
      br += step_r;
      if (br >= mi) {
        br -= mi;
        ++bt;
      }
    }
  }
}

// Blocks of more than kMaxTileM rows: one thread per block walks its rows
// straight from device memory, the modified diagonal in w's slots until the
// backward sweep overwrites it.
template <typename T>
__global__ void stage1_direct_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                                     const T* __restrict__ du, const T* __restrict__ b,
                                     T* __restrict__ y, T* __restrict__ v, T* __restrict__ w,
                                     long long nblocks, long long bps, int m, bool zero_ends) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= nblocks) return;
  const int mi = m - 1;
  const T* dlp = dl + g * m;
  const T* dp = d + g * m;
  const T* dup = du + g * m;
  const T* bp = b + g * m;
  T* yp = y + g * mi;
  T* vp = v + g * mi;
  T* wp = w + g * mi;

  T dhat = dp[0];
  T yc = bp[0];
  T vc = (zero_ends && g % bps == 0) ? T(0) : dlp[0];
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
  const int last = mi - 1;
  yc = yc / dhat;
  vc = vc / dhat;
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

// The reduced rows of blocks walked from device memory: one thread per
// block reads its last row, its last spike row and the next block's first
// spike row back.
template <typename T>
__global__ void stage1_reduced_kernel(const T* __restrict__ dl, const T* __restrict__ d,
                                      const T* __restrict__ du, const T* __restrict__ b,
                                      const T* __restrict__ y, const T* __restrict__ v,
                                      const T* __restrict__ w, T* __restrict__ red_dl,
                                      T* __restrict__ red_d, T* __restrict__ red_du,
                                      T* __restrict__ red_b, long long nblocks,
                                      long long bps, long long red_ss, int m, bool zero_ends) {
  const long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= nblocks) return;
  const int mi = m - 1;
  const long long row = g * m + mi;  // the block's last (interface) row
  const long long lastk = g * mi + (mi - 1);
  const bool last = (g % bps) + 1 == bps;
  T y_nf = T(0), v_nf = T(0), w_nf = T(0);
  if (!last) {
    const long long first = (g + 1) * mi;
    y_nf = y[first];
    v_nf = v[first];
    w_nf = w[first];
  }
  const T cL = (zero_ends && last) ? T(0) : du[row];
  reduced_row(dl[row], d[row], cL, b[row], y[lastk], v[lastk], w[lastk], y_nf, v_nf, w_nf,
              red_dl, red_d, red_du, red_b, g, bps, red_ss);
}

template <typename T>
static cudaError_t launch_tiles(const T* dl, const T* d, const T* du, const T* b, T* y, T* v,
                                T* w, T* red_dl, T* red_d, T* red_du, T* red_b,
                                long long nblocks, long long bps, long long red_ss, int m,
                                bool zero_ends, cudaStream_t s) {
  const int tb = span_blocks(m, static_cast<int>(sizeof(T)));
  const size_t smem = 4ull * tb * row_pitch(m) * sizeof(T);
  // Above 48 KB of dynamic shared memory needs the attribute (per device,
  // so it is set at every such launch).
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(stage1_tile_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const long long spans = (nblocks + tb - 2) / (tb - 1);  // tb - 1 owned blocks a span
  stage1_tile_kernel<T><<<static_cast<unsigned int>(spans), tb, smem, s>>>(
      dl, d, du, b, y, v, w, red_dl, red_d, red_du, red_b, nblocks, bps, red_ss, m, zero_ends);
  return cudaGetLastError();
}

template <typename T>
static int launch_stage1(const void* dl_, const void* d_, const void* du_, const void* b_,
                         void* y_, void* v_, void* w_, void* red_dl_, void* red_d_,
                         void* red_du_, void* red_b_, long long nsys, long long bps,
                         long long red_ss, int m, int zero_ends_, void* stream) {
  const bool zero_ends = zero_ends_ != 0;
  const long long nblocks = nsys * bps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nblocks == 0) return static_cast<int>(cudaGetLastError());
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
  if (m <= kMaxTileM) {
    return static_cast<int>(launch_tiles<T>(dl, d, du, b, y, v, w, red_dl, red_d, red_du, red_b,
                                            nblocks, bps, red_ss, m, zero_ends, s));
  }
  stage1_direct_kernel<T><<<repro_grid(nblocks), REPRO_THREADS, 0, s>>>(
      dl, d, du, b, y, v, w, nblocks, bps, m, zero_ends);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  stage1_reduced_kernel<T><<<repro_grid(nblocks), REPRO_THREADS, 0, s>>>(
      dl, d, du, b, y, v, w, red_dl, red_d, red_du, red_b, nblocks, bps, red_ss, m, zero_ends);
  return static_cast<int>(cudaGetLastError());
}

// bps: partition blocks per system; red_ss: the reduced rows' system
// stride (>= bps); zero_ends: read each system's dl[0] and du[n-1] as zero.
extern "C" int partition_stage1_f32(const void* dl, const void* d, const void* du,
                                    const void* b, void* y, void* v, void* w,
                                    void* red_dl, void* red_d, void* red_du, void* red_b,
                                    long long nsys, long long bps, long long red_ss, int m,
                                    int zero_ends, void* stream) {
  return launch_stage1<float>(dl, d, du, b, y, v, w, red_dl, red_d, red_du, red_b, nsys, bps,
                              red_ss, m, zero_ends, stream);
}

extern "C" int partition_stage1_f64(const void* dl, const void* d, const void* du,
                                    const void* b, void* y, void* v, void* w,
                                    void* red_dl, void* red_d, void* red_du, void* red_b,
                                    long long nsys, long long bps, long long red_ss, int m,
                                    int zero_ends, void* stream) {
  return launch_stage1<double>(dl, d, du, b, y, v, w, red_dl, red_d, red_du, red_b, nsys,
                               bps, red_ss, m, zero_ends, stream);
}

// Partition blocks per CUDA block (span) for blocks of m rows of es bytes;
// 0 where the blocks are walked from device memory.
extern "C" int partition_stage1_span_blocks(int m, int es) {
  return m <= kMaxTileM ? span_blocks(m, es) : 0;
}
