// SSD Stage 1 (the intra-chunk stage of Mamba-2's chunked scan), fp32 in
// and out, on the tensor cores in split TF32 ("3xTF32").
//
// Replaces the TPU kernel src/repro/kernels/ssd_stage1/ssd1.py (_ssd1_kernel,
// through ssd1_tiled, from ops.py::ssd_scan_pallas). For each cell g (one
// chunk of one sequence, G = batch * chunks) of Q steps:
//
//   cum[q, h]       = sum_{t <= q} dac[t, h]
//   S[q, k]         = C_q . B_k                                  (k <= q)
//   y[q, h, :]      = sum_{k <= q} S[q, k] * exp(cum[q,h] - cum[k,h]) * u[k, h, :]
//   state[h, :, n]  = sum_k exp(cum[Q-1,h] - cum[k,h]) * u[k, h, :] * B[k, n]
//
// Inputs u [G, Q, H, P], dac [G, Q, H], b and c [G, Q, N]; outputs y
// [G, Q, H, P] and state [G, H, P, N]; scratch scores [G, Q, ld] with
// ld = Q rounded up to a multiple of 4 (16-byte rows). 1 <= Q <= 1024.
//
// Bound: operations. Per cell the causal half of Q*Q*N + H*Q*Q*P plus
// H*Q*P*N multiply-adds against about 4*(2*Q*H*P + H*P*N + 2*Q*N) bytes,
// ~200 multiply-adds a byte at mamba2-1.3b's widths (Q = 256, H = 64,
// P = 64, N = 128). On an H100 SXM that work (8.74 GFLOP at G = 16) takes
// at least 0.130 ms as fp32 FMAs on the CUDA cores (67 TFLOP/s), and at
// least 0.053 ms as the three TF32 products of split TF32 on the tensor
// cores (3 x 8.74 GFLOP at the data sheet's 495 TFLOP/s, which only wgmma
// reaches; mma.sync, used here, peaks lower on an H100: PERF.md).
//
// Precision. Every operand x of a product is split as x = hi + lo with
// hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi) (x - hi is exact; a
// NaN or an infinity makes hi NaN: ssd_tf32.cuh), and the product is taken
// as lo*hi + hi*lo + hi*hi with fp32 accumulation in mma.sync.m16n8k8
// (TF32 in, fp32 out). That keeps about 22 of fp32's 24
// significand bits, and the result holds the fp32 tolerance ladder (rtol
// 1e-5, atol 1e-4) against the plain version. One TF32 product alone keeps
// 11 bits, about three decimal digits, and misses it
// (tests/test_torch_ssd_split.py emulates both on the CPU).
//
// Design: three kernels on the caller's stream, one C entry.
//   1. ssd_scores_kernel: S = C . B^T per cell, one block per 64 x 64 tile
//      on or below the diagonal (the tiles above it are never read), K = N
//      in double-buffered cp.async slices of 32, into the scratch, where
//      the heads of a cell read it back from L2 (4 MB at G = 16). A variant
//      that computed each block's 64-row score strip into shared memory and
//      walked a group of 8 heads over it, with no score kernel, measured
//      slower on an H100 (PERF.md).
//   2. ssd_state_kernel: state = (u o dend)^T . B for two heads of a cell
//      a block (each B fragment is split once for both), 64 x 128 outputs a
//      head, k slices of 32 double-buffered with cp.async; the decay
//      dend = exp(cum_last - cum_k) is applied as the u fragment is read.
//   3. ssd_y_kernel: one block per (cell, head, 64 columns of P) walks the
//      (64-row q tile, 32-step k tile) pairs on or below the diagonal, the
//      next pair's S and u tiles in flight (cp.async) while the current one
//      is multiplied; four warps take 32 x 32 quarters. The decay is applied
//      in fp32 to S as its A fragments are read, before they are split: a
//      k tile that ends before the q tile starts uses three factors, each
//      at most 1 for non-positive dac, precomputed once a block; a tile
//      that meets the diagonal uses exp2 of (cum_q - cum_k) * log2(e) and
//      never evaluates k > q.
//   Fragments are split as they are read from shared memory. Row pitches
//   are chosen per access pattern so that every fragment load is free of
//   bank conflicts (4 mod 32 words where a lane's row follows its group,
//   8 mod 32 where it follows its index in the group). Tails of Q, P and N
//   are zero-filled by the copies and masked at the stores; outputs go out
//   as 8-byte pairs where aligned. At Q = 1024 the result is nearer an fp64
//   reference than the plain version on the card is, whose fp32 cumsum of
//   the decays errs more than this kernel's scan (PERF.md).
#include "common.cuh"
#include "ssd_tf32.cuh"

namespace {

constexpr int kMaxQ = 1024;
constexpr int kT = 64;         // q and k tile of the scores and of y
constexpr int kPT = 64;        // P columns per block
constexpr int kSK = 32;        // K slice of the scores (over N) and of the state (over Q)
constexpr int kNT = 128;       // N columns per state pass

// Row pitches (in floats): fragment loads conflict-free, rows 16-byte aligned.
constexpr int kPitchSK = kSK + 4;     // [row][k] tiles read as A or B^T: 4 mod 32
constexpr int kPitchU = kPT + 8;      // u [k][p], read as B [k][n] or A^T: 8 mod 32
constexpr int kPitchBN = kNT + 8;     // B [k][n] of the state: 8 mod 32

// ---------------------------------------------------------------- scores --
struct ScoreSmem {
  float c[2][kT * kPitchSK];  // C slice, [q][n]
  float b[2][kT * kPitchSK];  // B slice, [k][n]
};

__global__ void __launch_bounds__(kThreads)
ssd_scores_kernel(const float* __restrict__ b, const float* __restrict__ c,
                  float* __restrict__ scores, int Q, int N, int ld, bool vec) {
  const int kt = blockIdx.x, qt = blockIdx.y;
  if (kt > qt) return;  // strictly above the diagonal: never read
  const long long g = blockIdx.z;
  const int q0 = qt * kT, k0 = kt * kT;
  __shared__ __align__(16) ScoreSmem sm;
  const float* cg = c + (g * Q + q0) * N;
  const float* bg = b + (g * Q + k0) * N;
  const int warp = threadIdx.x / 32, wm = (warp / 2) * 32, wn = (warp % 2) * 32;
  const int gid = threadIdx.x % 32 / 4, tig = threadIdx.x % 4;
  float acc[2][4][4];
  zero_acc(acc);
  const int slices = (N + kSK - 1) / kSK;
  load_tile<kT, kSK>(sm.c[0], kPitchSK, cg, N, Q - q0, N, vec);
  load_tile<kT, kSK>(sm.b[0], kPitchSK, bg, N, Q - k0, N, vec);
  cp_async_commit();
  for (int s = 0; s < slices; ++s) {
    const int buf = s & 1;
    if (s + 1 < slices) {
      const int n1 = (s + 1) * kSK;
      load_tile<kT, kSK>(sm.c[buf ^ 1], kPitchSK, cg + n1, N, Q - q0, N - n1, vec);
      load_tile<kT, kSK>(sm.b[buf ^ 1], kPitchSK, bg + n1, N, Q - k0, N - n1, vec);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sc = sm.c[buf] + wm * kPitchSK;
    const float* sb = sm.b[buf] + wn * kPitchSK;
#pragma unroll
    for (int kk = 0; kk < kSK; kk += 8)
      mma_k8_3xtf32(
          acc,
          [&](int i, int h, int c) { return sc[(i * 16 + gid + 8 * h) * kPitchSK + kk + tig + 4 * c]; },
          [&](int j, int r) { return sb[(j * 8 + gid) * kPitchSK + kk + tig + 4 * r]; });
    __syncthreads();
  }
  float* sg = scores + (g * Q + q0) * ld + k0;
  store_acc(acc, [&](int r, int col, float v0, float v1) {
    const int q = wm + r, k = wn + col;
    if (q0 + q < Q) store_pair(sg + static_cast<long long>(q) * ld + k, Q - k0 - k, v0, v1, true);
  });
}

// --------------------------------------------------------------- the scan --
// cum[0..Q) = inclusive prefix sum of dac[g, :, h] into shared memory.
__device__ __forceinline__ void scan_cum(const float* __restrict__ dac, long long g, int h, int Q,
                                         int H, float* cum, float* warp_tot) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float carry = 0.f;
  for (int base = 0; base < Q; base += kThreads) {
    const int q = base + tid;
    float v = (q < Q) ? dac[(g * Q + q) * H + h] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off *= 2) {
      const float t = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += t;
    }
    if (lane == 31) warp_tot[warp] = v;
    __syncthreads();
    float before = carry;
    for (int w = 0; w < warp; ++w) before += warp_tot[w];
    if (q < Q) cum[q] = before + v;
    __syncthreads();
    carry = cum[min(base + kThreads, Q) - 1];
  }
}

// --------------------------------------------------------------------- y --
// A block per (cell, head, 64 columns of P) walks the (q tile, k tile)
// pairs on or below the diagonal; its four warps take 32 x 32 quarters of
// each 64 x 64 output tile.

// Shared memory of ssd_y_kernel: the tiles, then cum, rowf and colf of
// y_steps(Q) floats each and the scan's warp totals.
struct YTiles {
  float s[2][kT * kPitchSK];  // S tile, [q][k], 64 x 32
  float u[2][kSK * kPitchU];  // u tile, [k][p], 32 x 64
};

__host__ __device__ constexpr int y_steps(int Q) { return (Q + kSK - 1) / kSK * kSK; }

__host__ __device__ constexpr int y_smem_bytes(int Q) {
  return static_cast<int>(sizeof(YTiles)) + (3 * y_steps(Q) + kThreads / 32) * 4;
}

// The k tiles (of kSK) that q tile qt reaches: those that start at or
// before its last row.
__device__ __forceinline__ int k_tiles(int qt, int Q) {
  return (min(qt * kT + kT, Q) - 1) / kSK + 1;
}

__global__ void __launch_bounds__(kThreads)
ssd_y_kernel(const float* __restrict__ u, const float* __restrict__ dac,
             const float* __restrict__ scores, float* __restrict__ y, int Q, int H, int P,
             int ld, bool vec_u, bool vec_y) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  YTiles& sm = *reinterpret_cast<YTiles*>(smem_raw);
  float* cum = reinterpret_cast<float*>(smem_raw + sizeof(YTiles));
  float* rowf = cum + y_steps(Q);  // exp(cum_q - cum at the end of the q tile before q's)
  float* colf = rowf + y_steps(Q);  // exp(cum at the end of k's tile - cum_k)
  const long long g = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int p0 = blockIdx.y * kPT;
  const int tid = threadIdx.x, warp = tid / 32, gid = tid % 32 / 4, tig = tid % 4;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 32;

  scan_cum(dac, g, h, Q, H, cum, colf + y_steps(Q));
  // The decay of a k tile that ends before the q tile starts factors into
  // three terms, each at most 1 for non-positive dac (Mamba's dt * A):
  // exp(cum_q - cum_k) = rowf[q] * exp(cum[q0 - 1] - cum[kend]) * colf[k],
  // with q0 the q tile's first row and kend the k tile's last. Tiles that
  // meet the diagonal take exp(cum_q - cum_k) directly, as exp2 of the
  // difference times log2(e).
  for (int q = tid; q < Q; q += kThreads) {
    const int q0 = q / kT * kT, kend = q / kSK * kSK + kSK - 1;
    rowf[q] = q0 > 0 ? expf(cum[q] - cum[q0 - 1]) : 0.f;
    colf[q] = kend < Q ? expf(cum[kend] - cum[q]) : 0.f;
  }

  const long long hp = static_cast<long long>(H) * P;
  const float* ug = u + (g * Q * H + h) * static_cast<long long>(P) + p0;
  float* yg = y + (g * Q * H + h) * static_cast<long long>(P) + p0;
  const float* sg = scores + g * Q * static_cast<long long>(ld);
  const int p_lim = P - p0;
  const int qtiles = (Q + kT - 1) / kT;

  // y[q, p] = sum_{k <= q} S[q, k] * exp(cum_q - cum_k) * u[k, p]: the
  // (q tile, k tile) pairs in order, the next pair's copies in flight
  // while the current one is multiplied.
  auto issue = [&](int i, int qt, int kt) {
    const int q0 = qt * kT, k0 = kt * kSK;
    load_tile<kT, kSK>(sm.s[i & 1], kPitchSK, sg + static_cast<long long>(q0) * ld + k0, ld,
                       Q - q0, Q - k0, true);
    load_tile<kSK, kPT>(sm.u[i & 1], kPitchU, ug + k0 * hp, hp, Q - k0, p_lim, vec_u);
    cp_async_commit();
  };
  float acc[2][4][4];
  int qt = 0, kt = 0, nk = k_tiles(0, Q);
  __syncthreads();  // cum, rowf and colf complete
  issue(0, 0, 0);
  for (int i = 0; qt < qtiles; ++i) {
    int qn = qt, kn = kt + 1, nkn = nk;
    if (kn == nk) {
      qn = qt + 1;
      kn = 0;
      nkn = qn < qtiles ? k_tiles(qn, Q) : 0;
    }
    if (qn < qtiles) {
      issue(i + 1, qn, kn);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = qt * kT, k0 = kt * kSK;
    if (kt == 0) zero_acc(acc);
    const float* sa = sm.s[i & 1] + wm * kPitchSK;
    const float* su = sm.u[i & 1] + wn;
    auto b_at = [&](int kk) {
      return [=](int j, int r) { return su[(kk + tig + 4 * r) * kPitchU + j * 8 + gid]; };
    };
    // S o L in fp32 as the A fragments are read; k > q and rows past Q
    // are zero and never evaluated.
    if (k0 + kSK <= q0) {
      const float t = expf(cum[q0 - 1] - cum[k0 + kSK - 1]);
      float rf[2][2];
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int q = q0 + wm + a * 16 + gid + 8 * hh;
          rf[a][hh] = q < Q ? rowf[q] * t : 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < kSK; kk += 8) {
        const float cf[2] = {colf[k0 + kk + tig], colf[k0 + kk + tig + 4]};
        mma_k8_3xtf32(acc,
                      [&](int a, int hh, int c) {
                        return sa[(a * 16 + gid + 8 * hh) * kPitchSK + kk + tig + 4 * c] *
                               rf[a][hh] * cf[c];
                      },
                      b_at(kk));
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < kSK; kk += 8)
        mma_k8_3xtf32(acc,
                      [&](int a, int hh, int c) {
                        const int r = a * 16 + gid + 8 * hh, col = kk + tig + 4 * c;
                        const int q = q0 + wm + r, k = k0 + col;
                        return (q < Q && k <= q)
                                   ? sa[r * kPitchSK + col] * exp2f((cum[q] - cum[k]) * kLog2e)
                                   : 0.f;
                      },
                      b_at(kk));
    }
    if (kt + 1 == nk) {
      store_acc(acc, [&](int r, int col, float v0, float v1) {
        const int q = q0 + wm + r, p = wn + col;
        if (q < Q) store_pair(yg + q * hp + p, p_lim - p, v0, v1, vec_y);
      });
    }
    __syncthreads();  // this pair's buffers are the next issue's target
    qt = qn;
    kt = kn;
    nk = nkn;
  }
}

// ----------------------------------------------------------------- state --
constexpr int kSH = 2;  // heads a state block: they share its B slices

struct StateSmem {
  float u[2][kSH][kSK * kPitchU];  // u slices, [k][p], one a head
  float b[2][kSK * kPitchBN];      // B slice, [k][n]
  float cum[kMaxQ];
  float dend[kSH][kMaxQ];
  float warp_tot[kThreads / 32];
};

// state[h, p, n] = sum_k u[k, h, p] * dend_h[k] * B[k, n] for one (cell,
// kSH heads, 64 columns of P, 128 columns of N), in k slices of kSK; each
// B fragment is split once for both heads.
__global__ void __launch_bounds__(kThreads)
ssd_state_kernel(const float* __restrict__ u, const float* __restrict__ dac,
                 const float* __restrict__ b, float* __restrict__ state, int Q, int H, int P,
                 int N, bool vec_u, bool vec_b, bool vec_st) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  StateSmem& sm = *reinterpret_cast<StateSmem*>(smem_raw);
  const int hblocks = (H + kSH - 1) / kSH;
  const long long g = blockIdx.x / hblocks;
  const int h0 = blockIdx.x % hblocks * kSH, nh = min(kSH, H - h0);
  const int p0 = blockIdx.y * kPT, n0 = blockIdx.z * kNT;
  const int warp = threadIdx.x / 32, gid = threadIdx.x % 32 / 4, tig = threadIdx.x % 4;

  // dend past Q (and of a missing second head) is zero, so the zero-filled
  // tail of a u slice stays zero.
  const int q_pad = (Q + kSK - 1) / kSK * kSK;
  for (int j = 0; j < kSH; ++j) {
    if (j < nh) scan_cum(dac, g, h0 + j, Q, H, sm.cum, sm.warp_tot);
    const float cum_last = sm.cum[Q - 1];
    for (int q = threadIdx.x; q < q_pad; q += kThreads)
      sm.dend[j][q] = (j < nh && q < Q) ? expf(cum_last - sm.cum[q]) : 0.f;
    __syncthreads();  // before the next scan overwrites cum
  }

  const long long hp = static_cast<long long>(H) * P;
  const float* ug = u + (g * Q * H + h0) * static_cast<long long>(P) + p0;
  const float* bg = b + g * Q * static_cast<long long>(N) + n0;
  const int p_lim = P - p0;
  const int slices = (Q + kSK - 1) / kSK;
  const int wm = (warp / 2) * 32, wn = (warp % 2) * 64;
  auto issue = [&](int s) {
    const int k0 = s * kSK;
    for (int j = 0; j < nh; ++j)
      load_tile<kSK, kPT>(sm.u[s & 1][j], kPitchU, ug + k0 * hp + j * P, hp, Q - k0, p_lim,
                          vec_u);
    load_tile<kSK, kNT>(sm.b[s & 1], kPitchBN, bg + static_cast<long long>(k0) * N, N, Q - k0,
                        N - n0, vec_b);
    cp_async_commit();
  };
  float acc[kSH][2][8][4];
#pragma unroll
  for (int j = 0; j < kSH; ++j) zero_acc(acc[j]);
  issue(0);
  for (int s = 0; s < slices; ++s) {
    if (s + 1 < slices) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* sb = sm.b[s & 1] + wn;
#pragma unroll
    for (int kk = 0; kk < kSK; kk += 8) {
      uint32_t bhi[8][2], blo[8][2];
      split_b(bhi, blo, [&](int j, int r) { return sb[(kk + tig + 4 * r) * kPitchBN + j * 8 + gid]; });
#pragma unroll
      for (int j = 0; j < kSH; ++j) {
        const float* su = sm.u[s & 1][j] + wm;
        const float* de = sm.dend[j] + s * kSK + kk;
        uint32_t ahi[2][4], alo[2][4];
        split_a(ahi, alo, [&](int a, int h, int c) {
          return su[(kk + tig + 4 * c) * kPitchU + a * 16 + gid + 8 * h] * de[tig + 4 * c];
        });
        mma_3xtf32(acc[j], ahi, alo, bhi, blo);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kSH; ++j) {
    if (j >= nh) break;
    float* stg = state + ((g * H + h0 + j) * P + p0) * static_cast<long long>(N) + n0;
    store_acc(acc[j], [&](int r, int col, float v0, float v1) {
      const int p = wm + r, n = wn + col;
      if (p < p_lim) store_pair(stg + static_cast<long long>(p) * N + n, N - n0 - n, v0, v1, vec_st);
    });
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

extern "C" int ssd_stage1_f32(const void* u, const void* dac, const void* b, const void* c,
                              void* y, void* state, void* scores, long long G, int Q, int H,
                              int P, int N, void* stream) {
  if (G == 0 || H == 0 || P == 0) return static_cast<int>(cudaGetLastError());
  if (Q < 1 || Q > kMaxQ || N < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(scores)) return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ld = (Q + 3) / 4 * 4;
  const bool vec_bc = aligned16(b) && aligned16(c) && N % 4 == 0;
  const bool vec_u = aligned16(u) && P % 4 == 0;
  const bool vec_y = P % 2 == 0 && (reinterpret_cast<uintptr_t>(y) & 7) == 0;
  const bool vec_st = N % 2 == 0 && (reinterpret_cast<uintptr_t>(state) & 7) == 0;
  // Both kernels take more than 48 KB of dynamic shared memory. The
  // attribute is per device, so it is set at every launch.
  int err = set_smem(ssd_y_kernel, y_smem_bytes(kMaxQ));
  if (err == 0) err = set_smem(ssd_state_kernel, sizeof(StateSmem));
  if (err != 0) return err;
  const int qtiles = (Q + kT - 1) / kT;
  const unsigned cells = static_cast<unsigned>(G * H), pblocks = (P + kPT - 1) / kPT;
  const unsigned pairs = static_cast<unsigned>(G * ((H + kSH - 1) / kSH));
  ssd_scores_kernel<<<dim3(qtiles, qtiles, static_cast<unsigned>(G)), kThreads, 0, s>>>(
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(scores), Q, N, ld, vec_bc);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  ssd_state_kernel<<<dim3(pairs, pblocks, (N + kNT - 1) / kNT), kThreads, sizeof(StateSmem),
                     s>>>(static_cast<const float*>(u), static_cast<const float*>(dac),
                          static_cast<const float*>(b), static_cast<float*>(state), Q, H, P, N,
                          vec_u, vec_bc, vec_st);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  ssd_y_kernel<<<dim3(cells, pblocks), kThreads, y_smem_bytes(Q), s>>>(
      static_cast<const float*>(u), static_cast<const float*>(dac),
      static_cast<const float*>(scores), static_cast<float*>(y), Q, H, P, ld, vec_u, vec_y);
  return static_cast<int>(cudaGetLastError());
}
