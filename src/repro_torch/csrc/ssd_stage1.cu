// SSD Stage 1 (the intra-chunk stage of Mamba-2's chunked scan), fp32.
//
// Replaces the TPU kernel src/repro/kernels/ssd_stage1/ssd1.py (_ssd1_kernel,
// through ssd1_tiled, from ops.py::ssd_scan_pallas). For each cell g (one
// chunk of one sequence, G = batch * chunks) of Q steps:
//
//   cum[q, h]       = sum_{t <= q} dac[t, h]
//   y[q, h, :]      = sum_{k <= q} (C_q . B_k) * exp(cum[q,h] - cum[k,h]) * u[k, h, :]
//   state[h, :, n]  = sum_k exp(cum[Q-1,h] - cum[k,h]) * u[k, h, :] * B[k, n]
//
// Inputs u [G, Q, H, P], dac [G, Q, H], b and c [G, Q, N]; outputs y
// [G, Q, H, P] and state [G, H, P, N]; scratch scores [G, Q, Q]. Q <= 1024.
//
// Bound: operations. Per cell the causal half of Q*Q*N + H*Q*Q*P plus
// H*Q*P*N multiply-adds against about 4*(2*Q*H*P + H*P*N + 2*Q*N) bytes; at
// mamba2-1.3b's widths (Q = 256, H = 64, P = 64, N = 128) that is ~200
// multiply-adds a byte, far above the card's fp32 balance (67 TFLOP/s over
// 3.35 TB/s = 20 flops a byte).
//
// Design. The TPU kernel holds one whole cell in VMEM and walks the heads;
// at Q = 256 the Q x Q score matrix alone is 256 KB, more than a block's
// 227 KB of shared memory, so the cell is split:
//   1. ssd_scores_kernel: scores = C . B^T per cell, 64 x 64 tiles on or
//      below the diagonal only (the tiles above it are never read).
//   2. ssd_intra_kernel: one block per (cell, head, 64 columns of P). It
//      scans dac into cum in shared memory (warp shuffles), then
//      (a) walks the q rows in tiles of 64 and the k <= q columns in tiles
//      of 32, building score * decay tiles on the fly (k > q is skipped, so
//      nothing above the diagonal is evaluated and cum_q - cum_k <= 0 never
//      overflows) and multiplying them into u's tile, 4 x 4 outputs a
//      thread; (b) forms state = (u * exp(cum_last - cum))^T . B in 64 x 128
//      tiles, 4 x 8 outputs a thread.
// Plain fp32 FMA throughout, no TF32: tensor cores and TMA are later work.
#include "common.cuh"

namespace {

constexpr int kMaxQ = 1024;
constexpr int kTile = 64;   // q rows (and score tiles) per pass
constexpr int kKT = 32;     // k steps per shared-memory tile
constexpr int kPT = 64;     // P columns per block
constexpr int kNT = 128;    // N columns per state pass
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
ssd_scores_kernel(const float* __restrict__ b, const float* __restrict__ c,
                  float* __restrict__ scores, int Q, int N) {
  const int kt = blockIdx.x, qt = blockIdx.y;
  if (kt > qt) return;  // strictly above the diagonal: never read
  const long long g = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = qt * kTile, k0 = kt * kTile;
  __shared__ float cs[kKT][kTile + 1];  // [n][q]
  __shared__ float bs[kKT][kTile + 1];  // [n][k]
  const float* cg = c + g * Q * N;
  const float* bg = b + g * Q * N;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += kKT) {
    for (int r = 0; r < (kTile * kKT) / kThreads; ++r) {
      const int nn = tid % kKT, rr = tid / kKT + r * (kThreads / kKT);
      const int n = n0 + nn, q = q0 + rr, k = k0 + rr;
      cs[nn][rr] = (q < Q && n < N) ? cg[(long long)q * N + n] : 0.f;
      bs[nn][rr] = (k < Q && n < N) ? bg[(long long)k * N + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int nn = 0; nn < kKT; ++nn) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = cs[nn][ty * 4 + i];
        bv[i] = bs[nn][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  float* sg = scores + g * Q * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q = q0 + ty * 4 + i;
    if (q >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx * 4 + j;
      if (k < Q) sg[(long long)q * Q + k] = acc[i][j];
    }
  }
}

// Shared memory of ssd_intra_kernel's two passes, which run one after the
// other and share the space.
struct DiagTiles {
  float s[kTile][kKT + 1];  // score * decay, [q][k]
  float u[kKT][kPT];        // u, [k][p]
};
struct StateTiles {
  float ud[kKT][kPT];       // u * exp(cum_last - cum), [k][p]
  float b[kKT][kNT];        // B, [k][n]
};
union IntraTiles {
  DiagTiles diag;
  StateTiles state;
};

__global__ void __launch_bounds__(kThreads)
ssd_intra_kernel(const float* __restrict__ u, const float* __restrict__ dac,
                 const float* __restrict__ b, const float* __restrict__ scores,
                 float* __restrict__ y, float* __restrict__ state, int Q, int H, int P,
                 int N) {
  const long long g = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int p0 = blockIdx.y * kPT;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;
  __shared__ float cum[kMaxQ];
  __shared__ float dend[kMaxQ];
  __shared__ float warp_tot[kThreads / 32];
  __shared__ IntraTiles tiles;

  // cum = inclusive prefix sum of dac[g, :, h], 256 steps at a time.
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
  const float cum_last = cum[Q - 1];
  for (int q = tid; q < Q; q += kThreads) dend[q] = expf(cum_last - cum[q]);
  __syncthreads();

  // u[g, k, h, p] = ug[k * H * P + p]; y has the same layout.
  const long long hp = (long long)H * P;
  const float* ug = u + (g * Q * H + h) * (long long)P;
  float* yg = y + (g * Q * H + h) * (long long)P;
  const float* sg = scores + g * Q * Q;
  DiagTiles& dt = tiles.diag;

  // (a) y[q, p] = sum_{k <= q} scores[q, k] * exp(cum_q - cum_k) * u[k, p].
  for (int q0 = 0; q0 < Q; q0 += kTile) {
    const int q_end = min(q0 + kTile, Q);
    float acc[4][4] = {};
    for (int k0 = 0; k0 < q_end; k0 += kKT) {
      for (int r = 0; r < (kTile * kKT) / kThreads; ++r) {
        const int kk = tid % kKT, qq = tid / kKT + r * (kThreads / kKT);
        const int q = q0 + qq, k = k0 + kk;
        float v = 0.f;
        if (q < Q && k <= q) v = sg[(long long)q * Q + k] * expf(cum[q] - cum[k]);
        dt.s[qq][kk] = v;
      }
      for (int r = 0; r < (kKT * kPT) / kThreads; ++r) {
        const int pp = tid % kPT, kk = tid / kPT + r * (kThreads / kPT);
        const int k = k0 + kk, p = p0 + pp;
        dt.u[kk][pp] = (k < Q && p < P) ? ug[k * hp + p] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKT; ++kk) {
        float a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = dt.s[ty * 4 + i][kk];
        const float4 bv = *reinterpret_cast<const float4*>(&dt.u[kk][tx * 4]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(a[i], bv.x, acc[i][0]);
          acc[i][1] = fmaf(a[i], bv.y, acc[i][1]);
          acc[i][2] = fmaf(a[i], bv.z, acc[i][2]);
          acc[i][3] = fmaf(a[i], bv.w, acc[i][3]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = q0 + ty * 4 + i;
      if (q >= Q) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = p0 + tx * 4 + j;
        if (p < P) yg[q * hp + p] = acc[i][j];
      }
    }
  }

  // (b) state[p, n] = sum_k u[k, p] * exp(cum_last - cum_k) * B[k, n].
  const float* bg = b + g * Q * N;
  float* stg = state + ((g * H + h) * P) * (long long)N;
  StateTiles& st = tiles.state;
  for (int n0 = 0; n0 < N; n0 += kNT) {
    float acc[4][8] = {};
    for (int k0 = 0; k0 < Q; k0 += kKT) {
      for (int r = 0; r < (kKT * kPT) / kThreads; ++r) {
        const int pp = tid % kPT, kk = tid / kPT + r * (kThreads / kPT);
        const int k = k0 + kk, p = p0 + pp;
        st.ud[kk][pp] = (k < Q && p < P) ? ug[k * hp + p] * dend[k] : 0.f;
      }
      for (int r = 0; r < (kKT * kNT) / kThreads; ++r) {
        const int nn = tid % kNT, kk = tid / kNT + r * (kThreads / kNT);
        const int k = k0 + kk, n = n0 + nn;
        st.b[kk][nn] = (k < Q && n < N) ? bg[(long long)k * N + n] : 0.f;
      }
      __syncthreads();
#pragma unroll 4
      for (int kk = 0; kk < kKT; ++kk) {
        const float4 av = *reinterpret_cast<const float4*>(&st.ud[kk][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&st.b[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&st.b[kk][64 + tx * 4]);
        const float a[4] = {av.x, av.y, av.z, av.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + ty * 4 + i;
      if (p >= P) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
        if (n < N) stg[(long long)p * N + n] = acc[i][j];
      }
    }
  }
}

}  // namespace

extern "C" int ssd_stage1_f32(const void* u, const void* dac, const void* b, const void* c,
                              void* y, void* state, void* scores, long long G, int Q, int H,
                              int P, int N, void* stream) {
  if (G == 0 || H == 0 || P == 0) return static_cast<int>(cudaGetLastError());
  if (Q < 1 || Q > kMaxQ) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int qtiles = (Q + kTile - 1) / kTile;
  ssd_scores_kernel<<<dim3(qtiles, qtiles, static_cast<unsigned>(G)), kThreads, 0, s>>>(
      static_cast<const float*>(b), static_cast<const float*>(c),
      static_cast<float*>(scores), Q, N);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  ssd_intra_kernel<<<dim3(static_cast<unsigned>(G * H), (P + kPT - 1) / kPT), kThreads, 0,
                     s>>>(static_cast<const float*>(u), static_cast<const float*>(dac),
                          static_cast<const float*>(b), static_cast<const float*>(scores),
                          static_cast<float*>(y), static_cast<float*>(state), Q, H, P, N);
  return static_cast<int>(cudaGetLastError());
}
