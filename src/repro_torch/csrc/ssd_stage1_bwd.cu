// The gradient of SSD Stage 1 (the intra-chunk stage of Mamba-2's chunked
// scan), fp32 in and out, on the CUDA cores.
//
// It replaces no TPU kernel: the Pallas kernel _ssd1_kernel
// (src/repro/kernels/ssd_stage1/ssd1.py) has no backward, and the reference's
// training takes this gradient from jax autodiff of its plain Stage 1
// (src/repro/models/layers/ssm.py, ssd_scan). The port's training runs the
// forward through csrc/ssd_stage1.cu, so its backward is this kernel, behind
// SSDStage1Function (kernels/ssd_stage1/ops.py); the plain version is
// ssd_stage1_backward (models/layers/ssm.py).
//
// For each cell g (one chunk of one sequence) and head h, with
// cum = cumsum(dac), L[q,k] = exp(cum_q - cum_k) (k <= q), S = C.B^T,
// M = S o L, e_k = exp(cum_{Q-1} - cum_k), W[q,k] = dy[q].u[k] and the
// incoming gradients dy [Q,H,P] and ds [H,P,N]:
//
//   du[k]   = sum_{q>=k} M[q,k] dy[q] + e_k (ds.B_k)
//   dS      = sum_h L o W,  dC = dS.B,  dB = dS^T.C + sum_h e_k u[k]^T.ds
//   G       = M o W,  r_k = e_k u[k].(ds.B_k)
//   dcum[q] = sum_k G[q,k] - sum_q' G[q',q] - r_q  (+ sum_k r_k at q = Q-1)
//   ddac[k] = sum_{q>=k} dcum[q]
//
// Inputs u, dy [G, Q, H, P], dac [G, Q, H], b, c [G, Q, N], ds [G, H, P, N];
// outputs du, ddac, db, dc of the inputs' shapes; scratch cum and e
// [G, Q, H], scores and dscores [G, Q, Q], dspart [G, HS, Q, Q], rowpart
// and colpart [G, T, Q, H] (T = ceil(Q / 64)), r [G, Q, H] and dbpart
// [G, JS, Q, N], where HS groups of heads share the dS work and JS slices
// of H*P share the state term of dB (the wrapper picks both). 1 <= Q <= 1024.
//
// Bound: operations. Per cell the causal half of Q*Q*N (scores) + H*Q*Q*P
// (W) + H*Q*Q*P (the dy term of du) + 2*Q*Q*N (dC, dS^T.C), and H*Q*P*N
// twice (ds.B and u^T.ds) multiply-adds against 4*(3*Q*H*P + 2*Q*H +
// 4*Q*N + H*P*N) bytes: at mamba2-1.3b's widths (Q = 256, H = 64, P = 64,
// N = 128) 17.6 GFLOP at G = 16, at least 0.263 ms as fp32 FMAs on the
// CUDA cores (67 TFLOP/s on an H100 SXM), while its 245 MB take 0.073 ms
// at 3.35 TB/s.
//
// Design: a simple kernel that is right first. Seven kernels on the
// caller's stream behind one C entry, every product a 64 x 64 output tile a
// block of 256 threads (4 x 4 outputs a thread, fp32 FMAs), its operands
// staged through shared memory in slices of 16 along the contraction, with
// zero fill past every edge. Nothing is summed with atomics: each sum is
// taken in a fixed order, so the result is the same bits at every run.
//   1. bwd_cum_kernel: cum and e, one thread a (cell, head).
//   2. bwd_scores_kernel: one block a (cell, q tile, k tile <= q tile, group
//      of heads) computes its S tile (kept in registers; the first group
//      stores it), then walks its heads: W = dy_h.u_h^T, adds L o W to its
//      dS tile (dspart), and writes the row and column sums of G over the
//      tile (rowpart, colpart) for each head.
//   3. bwd_dsum_kernel: dS, the groups' dS tiles summed in order.
//   4. bwd_du_kernel: one block a (cell, head, k tile): du and r.
//   5. bwd_dbstate_kernel: one block a (cell, k tile, 64 columns of N, slice
//      of H*P): its slice's part of sum_h e_k u[k]^T.ds (dbpart).
//   6. bwd_bc_kernel: one block a (cell, row tile, 64 columns of N): dC, and
//      dB = dS^T.C plus the slices' parts in order.
//   7. bwd_dac_kernel: one block a (cell, head) sums the partial row and
//      column sums with r into dcum and takes the reverse cumulative sum.
// (2) and (5) split their heads and their H*P contraction over blocks:
// one block a tile would give 160 and 128 blocks at mamba2-1.3b's G = 16,
// about one a streaming multiprocessor (132 on an H100), too few warps to
// hide the loads' latency.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxQ = 1024;
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each
constexpr int kT = 64;         // output tile (rows and columns)
constexpr int kK = 16;         // contraction slice
constexpr int kLd = kT + 4;    // row pitch of a staged slice: 16-byte rows

struct Tiles {
  float a[kK][kLd];  // a[kk][r]: the left operand, row r of the tile
  float b[kK][kLd];  // b[kk][c]: the right operand, column c of the tile
};

// dst[kk][r] = f(kk, r), consecutive threads on consecutive r (sources
// contiguous along the tile's rows or columns).
template <typename F>
__device__ __forceinline__ void fill_by_col(float (*dst)[kLd], F f) {
  for (int i = threadIdx.x; i < kK * kT; i += kThreads) {
    const int kk = i / kT, r = i % kT;
    dst[kk][r] = f(kk, r);
  }
}

// The same, consecutive threads on consecutive kk (sources contiguous along
// the contraction).
template <typename F>
__device__ __forceinline__ void fill_by_row(float (*dst)[kLd], F f) {
  for (int i = threadIdx.x; i < kK * kT; i += kThreads) {
    const int r = i / kK, kk = i % kK;
    dst[kk][r] = f(kk, r);
  }
}

// acc[i][j] += sum_kk a[kk][4 ty + i] * b[kk][4 tx + j].
__device__ __forceinline__ void tile_fma(float acc[4][4], const Tiles& t) {
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    const float4 a = *reinterpret_cast<const float4*>(&t.a[kk][ty * 4]);
    const float4 b = *reinterpret_cast<const float4*>(&t.b[kk][tx * 4]);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
}

// The sum over the 16 threads of a row (same ty, lanes of one half warp),
// in a fixed butterfly order.
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, 16);
  return v;
}

__global__ void __launch_bounds__(kThreads)
bwd_cum_kernel(const float* __restrict__ dac, float* __restrict__ cum, float* __restrict__ e,
               long long GH, int Q, int H) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (idx >= GH) return;
  const long long g = idx / H;
  const int h = static_cast<int>(idx % H);
  const long long base = g * Q * H + h;
  float acc = 0.f;
  for (int q = 0; q < Q; ++q) {
    acc += dac[base + static_cast<long long>(q) * H];
    cum[base + static_cast<long long>(q) * H] = acc;
  }
  for (int q = 0; q < Q; ++q) {
    const long long o = base + static_cast<long long>(q) * H;
    e[o] = expf(acc - cum[o]);
  }
}

__global__ void __launch_bounds__(kThreads)
bwd_scores_kernel(const float* __restrict__ u, const float* __restrict__ cum,
                  const float* __restrict__ b, const float* __restrict__ c,
                  const float* __restrict__ dy, float* __restrict__ scores,
                  float* __restrict__ dspart, float* __restrict__ rowpart,
                  float* __restrict__ colpart, int Q, int H, int P, int N, int HS) {
  const int kt = blockIdx.x, qt = blockIdx.y;
  if (kt > qt) return;  // above the diagonal: never read
  const long long g = blockIdx.z / HS;
  const int hs = static_cast<int>(blockIdx.z % HS);
  const int hpb = (H + HS - 1) / HS;
  const int h_begin = hs * hpb, h_end = min(H, h_begin + hpb);
  const int T = gridDim.x;
  const int q0 = qt * kT, k0 = kt * kT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long HP = static_cast<long long>(H) * P;
  __shared__ __align__(16) Tiles sm;
  __shared__ float cq[kT], ck[kT];
  __shared__ float colred[16][kT];

  const float* bg = b + g * Q * N;
  const float* cg = c + g * Q * N;
  float sacc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += kK) {
    fill_by_row(sm.a, [&](int kk, int r) {
      const int q = q0 + r, n = n0 + kk;
      return (q < Q && n < N) ? cg[static_cast<long long>(q) * N + n] : 0.f;
    });
    fill_by_row(sm.b, [&](int kk, int r) {
      const int k = k0 + r, n = n0 + kk;
      return (k < Q && n < N) ? bg[static_cast<long long>(k) * N + n] : 0.f;
    });
    __syncthreads();
    tile_fma(sacc, sm);
    __syncthreads();
  }
  if (hs == 0) {
    float* sg = scores + g * Q * Q;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + ty * 4 + i, k = k0 + tx * 4 + j;
        if (q < Q && k < Q) sg[static_cast<long long>(q) * Q + k] = sacc[i][j];
      }
    }
  }

  float dsacc[4][4] = {};
  for (int h = h_begin; h < h_end; ++h) {
    if (threadIdx.x < kT) {
      const int q = q0 + threadIdx.x;
      cq[threadIdx.x] = q < Q ? cum[(g * Q + q) * H + h] : 0.f;
    } else if (threadIdx.x < 2 * kT) {
      const int k = k0 + threadIdx.x - kT;
      ck[threadIdx.x - kT] = k < Q ? cum[(g * Q + k) * H + h] : 0.f;
    }
    float w[4][4] = {};
    for (int p0 = 0; p0 < P; p0 += kK) {
      fill_by_row(sm.a, [&](int kk, int r) {
        const int q = q0 + r, p = p0 + kk;
        return (q < Q && p < P) ? dy[(g * Q + q) * HP + static_cast<long long>(h) * P + p] : 0.f;
      });
      fill_by_row(sm.b, [&](int kk, int r) {
        const int k = k0 + r, p = p0 + kk;
        return (k < Q && p < P) ? u[(g * Q + k) * HP + static_cast<long long>(h) * P + p] : 0.f;
      });
      __syncthreads();
      tile_fma(w, sm);
      __syncthreads();
    }
    float rows[4] = {}, cols[4] = {};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = q0 + ty * 4 + i, k = k0 + tx * 4 + j;
        const float l = (q < Q && k <= q) ? expf(cq[ty * 4 + i] - ck[tx * 4 + j]) : 0.f;
        const float lw = l * w[i][j];
        dsacc[i][j] += lw;
        const float gv = sacc[i][j] * lw;
        rows[i] += gv;
        cols[j] += gv;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = sum16(rows[i]);
      const int q = q0 + ty * 4 + i;
      if (tx == 0 && q < Q) rowpart[((g * T + kt) * Q + q) * H + h] = v;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) colred[ty][tx * 4 + j] = cols[j];
    __syncthreads();
    if (threadIdx.x < kT) {
      float v = 0.f;
      for (int y = 0; y < 16; ++y) v += colred[y][threadIdx.x];
      const int k = k0 + threadIdx.x;
      if (k < Q) colpart[((g * T + qt) * Q + k) * H + h] = v;
    }
    __syncthreads();
  }
  float* dsg = dspart + (g * HS + hs) * Q * Q;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = q0 + ty * 4 + i, k = k0 + tx * 4 + j;
      if (q < Q && k < Q) dsg[static_cast<long long>(q) * Q + k] = dsacc[i][j];
    }
  }
}

// dS[g, q, k] = sum over the head groups of dspart, for k <= q (the rest
// is never read).
__global__ void __launch_bounds__(kThreads)
bwd_dsum_kernel(const float* __restrict__ dspart, float* __restrict__ dscores, long long G,
                int Q, int HS) {
  const long long idx = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long QQ = static_cast<long long>(Q) * Q;
  if (idx >= G * QQ) return;
  const long long g = idx / QQ, qk = idx % QQ;
  if (qk % Q > qk / Q) return;
  float v = 0.f;
  for (int s = 0; s < HS; ++s) v += dspart[(g * HS + s) * QQ + qk];
  dscores[idx] = v;
}

__global__ void __launch_bounds__(kThreads)
bwd_du_kernel(const float* __restrict__ u, const float* __restrict__ cum,
              const float* __restrict__ e, const float* __restrict__ b,
              const float* __restrict__ dy, const float* __restrict__ ds,
              const float* __restrict__ scores, float* __restrict__ du, float* __restrict__ r,
              int Q, int H, int P, int N) {
  const int kt = blockIdx.x, h = blockIdx.y;
  const long long g = blockIdx.z;
  const int k0 = kt * kT;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long HP = static_cast<long long>(H) * P;
  __shared__ __align__(16) Tiles sm;
  __shared__ float ck[kT], ek[kT];
  if (threadIdx.x < kT) {
    const int k = k0 + threadIdx.x;
    ck[threadIdx.x] = k < Q ? cum[(g * Q + k) * H + h] : 0.f;
    ek[threadIdx.x] = k < Q ? e[(g * Q + k) * H + h] : 0.f;
  }
  __syncthreads();
  const float* sg = scores + g * Q * Q;
  const float* dsh = ds + (g * H + h) * static_cast<long long>(P) * N;
  float rsum[4] = {};
  for (int pc = 0; pc < P; pc += kT) {
    float acc[4][4] = {}, acc2[4][4] = {};
    // sum_{q >= k} M[q,k] dy[q, pc + c]
    for (int q0 = k0; q0 < Q; q0 += kK) {
      fill_by_col(sm.a, [&](int kk, int rr) {
        const int q = q0 + kk, k = k0 + rr;
        if (q >= Q || k > q) return 0.f;
        return sg[static_cast<long long>(q) * Q + k] * expf(cum[(g * Q + q) * H + h] - ck[rr]);
      });
      fill_by_col(sm.b, [&](int kk, int cc) {
        const int q = q0 + kk, p = pc + cc;
        return (q < Q && p < P) ? dy[(g * Q + q) * HP + static_cast<long long>(h) * P + p] : 0.f;
      });
      __syncthreads();
      tile_fma(acc, sm);
      __syncthreads();
    }
    // (ds.B_k)[pc + c] = sum_n B[k,n] ds[pc + c, n]
    for (int n0 = 0; n0 < N; n0 += kK) {
      fill_by_row(sm.a, [&](int kk, int rr) {
        const int k = k0 + rr, n = n0 + kk;
        return (k < Q && n < N) ? b[(g * Q + k) * N + n] : 0.f;
      });
      fill_by_row(sm.b, [&](int kk, int cc) {
        const int p = pc + cc, n = n0 + kk;
        return (p < P && n < N) ? dsh[static_cast<long long>(p) * N + n] : 0.f;
      });
      __syncthreads();
      tile_fma(acc2, sm);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = k0 + ty * 4 + i, p = pc + tx * 4 + j;
        if (k < Q && p < P) {
          const float t2 = ek[ty * 4 + i] * acc2[i][j];
          const long long o = (g * Q + k) * HP + static_cast<long long>(h) * P + p;
          du[o] = acc[i][j] + t2;
          rsum[i] += u[o] * t2;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float v = sum16(rsum[i]);
    const int k = k0 + ty * 4 + i;
    if (tx == 0 && k < Q) r[(g * Q + k) * H + h] = v;
  }
}

// dbpart[g, s, k, n] = sum over slice s of j = (h, p) of e_h[k] u[k, j] ds[j, n].
__global__ void __launch_bounds__(kThreads)
bwd_dbstate_kernel(const float* __restrict__ u, const float* __restrict__ e,
                   const float* __restrict__ ds, float* __restrict__ dbpart, int Q, int H,
                   int P, int N, int JS) {
  const int r0 = blockIdx.x * kT, n0 = blockIdx.y * kT;
  const long long g = blockIdx.z / JS;
  const int js = static_cast<int>(blockIdx.z % JS);
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const long long HP = static_cast<long long>(H) * P;
  const long long jl = (HP + JS - 1) / JS;
  const long long j_begin = js * jl, j_end = min(HP, j_begin + jl);
  __shared__ __align__(16) Tiles sm;
  const float* dsg = ds + g * HP * N;
  float acc[4][4] = {};
  for (long long j0 = j_begin; j0 < j_end; j0 += kK) {
    fill_by_row(sm.a, [&](int kk, int rr) {
      const long long j = j0 + kk;
      const int k = r0 + rr;
      if (k >= Q || j >= j_end) return 0.f;
      return e[(g * Q + k) * H + j / P] * u[(g * Q + k) * HP + j];
    });
    fill_by_col(sm.b, [&](int kk, int cc) {
      const long long j = j0 + kk;
      const int n = n0 + cc;
      return (j < j_end && n < N) ? dsg[j * N + n] : 0.f;
    });
    __syncthreads();
    tile_fma(acc, sm);
    __syncthreads();
  }
  float* out = dbpart + (g * JS + js) * Q * static_cast<long long>(N);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = r0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (k < Q && n < N) out[static_cast<long long>(k) * N + n] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
bwd_bc_kernel(const float* __restrict__ b, const float* __restrict__ c,
              const float* __restrict__ dscores, const float* __restrict__ dbpart,
              float* __restrict__ db, float* __restrict__ dc, int Q, int N, int JS) {
  const int r0 = blockIdx.x * kT, n0 = blockIdx.y * kT;
  const long long g = blockIdx.z;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  __shared__ __align__(16) Tiles sm;
  const float* dsg = dscores + g * Q * Q;
  const float* bg = b + g * Q * N;
  const float* cg = c + g * Q * N;

  // dC[q, n] = sum_{k <= q} dS[q,k] B[k,n], q in this row tile.
  float acc[4][4] = {};
  const int kend = min(r0 + kT, Q);
  for (int k0 = 0; k0 < kend; k0 += kK) {
    fill_by_row(sm.a, [&](int kk, int rr) {
      const int q = r0 + rr, k = k0 + kk;
      return (q < Q && k <= q) ? dsg[static_cast<long long>(q) * Q + k] : 0.f;
    });
    fill_by_col(sm.b, [&](int kk, int cc) {
      const int k = k0 + kk, n = n0 + cc;
      return (k < Q && n < N) ? bg[static_cast<long long>(k) * N + n] : 0.f;
    });
    __syncthreads();
    tile_fma(acc, sm);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int q = r0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (q < Q && n < N) dc[(g * Q + q) * N + n] = acc[i][j];
    }
  }

  // dB[k, n] = sum_{q >= k} dS[q,k] C[q,n] + the slices' state terms,
  // k in this row tile.
  float acc2[4][4] = {};
  for (int q0 = r0; q0 < Q; q0 += kK) {
    fill_by_col(sm.a, [&](int kk, int rr) {
      const int q = q0 + kk, k = r0 + rr;
      return (q < Q && k <= q) ? dsg[static_cast<long long>(q) * Q + k] : 0.f;
    });
    fill_by_col(sm.b, [&](int kk, int cc) {
      const int q = q0 + kk, n = n0 + cc;
      return (q < Q && n < N) ? cg[static_cast<long long>(q) * N + n] : 0.f;
    });
    __syncthreads();
    tile_fma(acc2, sm);
    __syncthreads();
  }
  const long long QN = static_cast<long long>(Q) * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = r0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (k < Q && n < N) {
        float v = acc2[i][j];
        for (int s2 = 0; s2 < JS; ++s2) v += dbpart[(g * JS + s2) * QN + static_cast<long long>(k) * N + n];
        db[(g * Q + k) * N + n] = v;
      }
    }
  }
}

// One block a (cell, head): each thread sums the partial row and column
// sums with r into dcum for its rows q, then the block takes the reverse
// cumulative sum over q in shared memory (a fixed order).
__global__ void __launch_bounds__(kThreads)
bwd_dac_kernel(const float* __restrict__ rowpart, const float* __restrict__ colpart,
               const float* __restrict__ r, float* __restrict__ ddac, int Q, int H, int T) {
  const long long g = blockIdx.x / H;
  const int h = static_cast<int>(blockIdx.x % H);
  const long long base = g * Q * H + h;
  __shared__ float dcum[kMaxQ];
  __shared__ float red[kThreads];
  // sum_k r[k], first as each thread's share, then over the block
  float rt = 0.f;
  for (int q = threadIdx.x; q < Q; q += kThreads) rt += r[base + static_cast<long long>(q) * H];
  red[threadIdx.x] = rt;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  rt = red[0];
  for (int q = threadIdx.x; q < Q; q += kThreads) {
    const int tq = q / kT;
    float d = -r[base + static_cast<long long>(q) * H];
    if (q == Q - 1) d += rt;
    for (int t = 0; t <= tq; ++t) d += rowpart[((g * T + t) * Q + q) * H + h];
    for (int t = tq; t < T; ++t) d -= colpart[((g * T + t) * Q + q) * H + h];
    dcum[q] = d;
  }
  __syncthreads();
  // Reverse inclusive scan: each thread sums a run of rows from its end,
  // the runs' totals are scanned in order, then added back.
  constexpr int kRun = kMaxQ / kThreads;
  const int lo = threadIdx.x * kRun, hi = min(Q, lo + kRun);
  float acc = 0.f;
  for (int q = hi - 1; q >= lo; --q) {
    acc += dcum[q];
    dcum[q] = acc;
  }
  __syncthreads();
  red[threadIdx.x] = lo < Q ? dcum[lo] : 0.f;  // each run's total
  __syncthreads();
  if (threadIdx.x == 0) {
    float tail = 0.f;  // the runs after each run, summed from the end
    for (int i = kThreads - 1; i >= 0; --i) {
      const float total = red[i];
      red[i] = tail;
      tail += total;
    }
  }
  __syncthreads();
  for (int q = lo; q < hi; ++q) ddac[base + static_cast<long long>(q) * H] = dcum[q] + red[threadIdx.x];
}

}  // namespace

extern "C" int ssd_stage1_bwd_f32(const void* u, const void* dac, const void* b, const void* c,
                                  const void* dy, const void* ds, void* du, void* ddac, void* db,
                                  void* dc, void* cum, void* e, void* scores, void* dscores,
                                  void* dspart, void* rowpart, void* colpart, void* r,
                                  void* dbpart, long long G, int Q, int H, int P, int N, int HS,
                                  int JS, void* stream) {
  if (G == 0) return static_cast<int>(cudaGetLastError());
  if (Q < 1 || Q > kMaxQ || N < 1 || H < 0 || P < 0 || HS < 1 || JS < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H == 0 || P == 0) {  // no head: dS and the state's gradient are zero
    const size_t bytes = static_cast<size_t>(G) * Q * N * sizeof(float);
    int err = static_cast<int>(cudaMemsetAsync(db, 0, bytes, s));
    if (err == 0) err = static_cast<int>(cudaMemsetAsync(dc, 0, bytes, s));
    return err;
  }
  const int T = (Q + kT - 1) / kT;
  const unsigned NT = static_cast<unsigned>((N + kT - 1) / kT);
  const long long GH = G * H;
  const unsigned gz = static_cast<unsigned>(G);
  const unsigned gh_blocks = static_cast<unsigned>((GH + kThreads - 1) / kThreads);
  const float* uf = static_cast<const float*>(u);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  const float* dyf = static_cast<const float*>(dy);
  const float* dsf = static_cast<const float*>(ds);
  float* cumf = static_cast<float*>(cum);
  float* ef = static_cast<float*>(e);
  float* sf = static_cast<float*>(scores);
  float* dsc = static_cast<float*>(dscores);
  float* dsp = static_cast<float*>(dspart);
  float* rp = static_cast<float*>(rowpart);
  float* cp = static_cast<float*>(colpart);
  float* rf = static_cast<float*>(r);
  float* dbp = static_cast<float*>(dbpart);

  bwd_cum_kernel<<<gh_blocks, kThreads, 0, s>>>(static_cast<const float*>(dac), cumf, ef, GH, Q, H);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bwd_scores_kernel<<<dim3(T, T, gz * HS), kThreads, 0, s>>>(uf, cumf, bf, cf, dyf, sf, dsp, rp,
                                                             cp, Q, H, P, N, HS);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  const long long gqq = G * Q * static_cast<long long>(Q);
  bwd_dsum_kernel<<<static_cast<unsigned>((gqq + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      dsp, dsc, G, Q, HS);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bwd_du_kernel<<<dim3(T, H, gz), kThreads, 0, s>>>(uf, cumf, ef, bf, dyf, dsf, sf,
                                                    static_cast<float*>(du), rf, Q, H, P, N);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bwd_dbstate_kernel<<<dim3(T, NT, gz * JS), kThreads, 0, s>>>(uf, ef, dsf, dbp, Q, H, P, N, JS);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bwd_bc_kernel<<<dim3(T, NT, gz), kThreads, 0, s>>>(bf, cf, dsc, dbp, static_cast<float*>(db),
                                                     static_cast<float*>(dc), Q, N, JS);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bwd_dac_kernel<<<static_cast<unsigned>(GH), kThreads, 0, s>>>(rp, cp, rf,
                                                                static_cast<float*>(ddac), Q, H, T);
  return static_cast<int>(cudaGetLastError());
}
