// The gradient of SSD Stage 1 (the intra-chunk stage of Mamba-2's chunked
// scan), fp32 in and out, on the tensor cores in split TF32.
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
// outputs du, ddac, db, dc of the inputs' shapes. Scratch (the wrapper
// allocates it): cum and e [G, Q, H]; scores and dscores [G, Q, ld] and
// dspart [G, HS, Q, ld], rows of ld = Q rounded up to a multiple of 4 (16
// bytes); rowpart and colpart [G, 2T, H, Q] (T = ceil(Q / 64)); r [G, Q, H];
// dbpart [G, JS, Q, N]. HS groups of at most 8 heads share the dS work and
// JS groups of heads the state term of dB (the wrapper picks both).
// 1 <= Q <= 1024.
//
// Bound: operations. Per cell the causal half of Q*Q*N (scores) + H*Q*Q*P
// (W) + H*Q*Q*P (the dy term of du) + 2*Q*Q*N (dC, dS^T.C), and H*Q*P*N
// twice (ds.B and u^T.ds) multiply-adds against 4*(3*Q*H*P + 2*Q*H +
// 4*Q*N + H*P*N) bytes: at mamba2-1.3b's widths (Q = 256, H = 64, P = 64,
// N = 128) 17.6 GFLOP at G = 16. As the three TF32 products of split TF32
// on the tensor cores that takes at least 0.107 ms (3 x 17.6 GFLOP at the
// data sheet's 495 TFLOP/s, which only wgmma reaches; mma.sync, used here,
// peaks lower on an H100: PERF.md), as fp32 FMAs on the CUDA cores 0.263 ms
// (67 TFLOP/s); its 245 MB take 0.073 ms at 3.35 TB/s.
//
// Precision. Every product with a contraction of 64 or more runs on
// mma.sync.m16n8k8 in split TF32, as the forward's do (ssd_tf32.cuh): each
// operand x is split as hi = cvt.rna.tf32(x), lo = cvt.rna.tf32(x - hi) and
// the product is lo*hi + hi*lo + hi*hi with fp32 accumulation. The decays
// L and e are applied in fp32 to the operand as its fragment is read,
// before the split; a k > q entry is zero before it is split. G, its row
// and column sums, dcum and the reverse scan stay in fp32: d cum takes
// differences of large sums, and its error follows their magnitude.
//
// Design: three kernels on the caller's stream behind one C entry. Every
// product is a 64 x 64 output tile a block of four warps (32 x 32 a warp),
// its operands staged by cp.async in 16-byte copies, slices of 32 along the
// contraction double-buffered (the next slice in flight while the current
// one multiplies), zero-filled past every edge. Row pitches keep every
// fragment load free of bank conflicts (4 mod 32 words for [row][k]
// tiles, 8 mod 32 for [k][col] tiles). Nothing is summed with atomics:
// each sum is taken in a fixed order, so two calls give the same bits.
//   1. bwd_scores_kernel: one block a (cell, q tile, k tile <= q tile,
//      group of heads). It scans cum for its heads over the whole chunk in
//      the same order as every other block (the block of the first tiles
//      writes cum and e for the later kernels), computes its S tile (kept
//      in registers; the first group stores it), then walks its heads:
//      W = dy_h.u_h^T, adds L o W to its dS tile (dspart), and writes the
//      row and column sums of G over each warp's half of the tile
//      (rowpart, colpart) straight from the accumulator fragments: shuffles
//      within a quad give the row sums, across the eight groups the column
//      sums.
//   2. bwd_mid_kernel, three kinds of block: (a) one a (cell, head, k tile):
//      e o (B.ds_h^T) and r's terms, then M^T.dy added in the same
//      accumulator (M from the S tile and cum in shared memory), and r;
//      (b) one a (cell, k tile, 64 columns of N, group of heads): its
//      group's part of sum_h e_k u[k]^T.ds (dbpart); (c) one a (cell,
//      q tile, k tile): dS, the groups' dS tiles summed in order.
//   3. bwd_out_kernel, three kinds of block: (a) dC = dS.B and (b)
//      dB = dS^T.C plus the groups' parts in order, one a (cell, row tile,
//      64 columns of N); (c) one a (cell, head): dcum from the partial row
//      and column sums and r, then the reverse cumulative sum.
// Rounding the split on the integer unit instead of with cvt took 11 % off
// (the FMA that keeps a NaN in hi gives 4 % back, cvt for hi alone 6 %);
// three stages of copies, more blocks an SM, fragments loaded a k step
// ahead, decays factored off the diagonal and groups of 16 heads measured
// no faster on an H100 (PERF.md).
#include "common.cuh"
#include "ssd_tf32.cuh"

namespace {

constexpr int kMaxQ = 1024;
constexpr int kT = 64;   // q and k tiles; columns of P or N a block writes
constexpr int kSK = 32;  // contraction slice
constexpr int kHG = 8;   // most heads a scores block walks (_HEADS_PER_GROUP in ops.py)
// Row pitches (in floats): fragment loads conflict-free, rows 16-byte aligned.
constexpr int kPitchRK = kSK + 4;  // [row][k] tiles, 64 x 32, read as A or B^T: 4 mod 32
constexpr int kPitchKC = kT + 8;   // [k][col] tiles, 32 x 64, read as B or A^T: 8 mod 32
constexpr int kTile = kT * kPitchRK;
static_assert(kT * kPitchRK == kSK * kPitchKC, "both tile shapes fill one buffer");

// The two operand tiles of a step, for two steps.
struct Stages {
  float a[2][kTile];
  float b[2][kTile];
};

// The position of a thread in the m16n8k8 fragments of its warp's 32 x 32
// quarter of a 64 x 64 output tile.
struct Lane {
  int wm, wn, gid, tig;
  __device__ Lane()
      : wm(threadIdx.x / 64 * 32), wn(threadIdx.x / 32 % 2 * 32), gid(threadIdx.x % 32 / 4),
        tig(threadIdx.x % 4) {}
};

// A double-buffered pipeline of `steps` steps: issue(i) starts step i's
// copies into buffer i & 1, compute(i) reads them once they have landed,
// while step i + 1's copies are in flight. One barrier a step: it makes
// step i's tiles visible to every thread, and it follows every thread's
// compute(i - 1), whose buffer the issue after it refills.
template <typename Issue, typename Compute>
__device__ __forceinline__ void pipeline(int steps, Issue issue, Compute compute) {
  if (steps <= 0) return;
  issue(0);
  cp_async_commit();
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < steps) {
      issue(i + 1);
      cp_async_commit();
    }
    compute(i);
  }
}

// The fragment readers of one k step (kk) of a 32-wide slice: A from a
// [row][k] tile or, transposed, from a [k][row] tile; B from a [k][col]
// tile or, transposed, from a [col][k] tile. f(row, k, v) may scale or mask
// the A value v at the tile's row and slice column before it is split.
template <typename F>
__device__ __forceinline__ auto a_rows(const float* s, const Lane& l, int kk, F f) {
  return [=](int i, int h, int c) {
    const int row = l.wm + i * 16 + l.gid + 8 * h, k = kk + l.tig + 4 * c;
    return f(row, k, s[row * kPitchRK + k]);
  };
}

template <typename F>
__device__ __forceinline__ auto a_cols(const float* s, const Lane& l, int kk, F f) {
  return [=](int i, int h, int c) {
    const int row = l.wm + i * 16 + l.gid + 8 * h, k = kk + l.tig + 4 * c;
    return f(row, k, s[k * kPitchKC + row]);
  };
}

__device__ __forceinline__ auto b_rows(const float* s, const Lane& l, int kk) {
  return [=](int j, int r) { return s[(kk + l.tig + 4 * r) * kPitchKC + l.wn + j * 8 + l.gid]; };
}

__device__ __forceinline__ auto b_cols(const float* s, const Lane& l, int kk) {
  return [=](int j, int r) { return s[(l.wn + j * 8 + l.gid) * kPitchRK + kk + l.tig + 4 * r]; };
}

struct Plain {
  __device__ float operator()(int, int, float v) const { return v; }
};

// acc += A.B over one staged 32-wide slice.
template <typename ALoad, typename BLoad>
__device__ __forceinline__ void mma_slice(float (&acc)[2][4][4], ALoad a_at, BLoad b_at) {
#pragma unroll
  for (int kk = 0; kk < kSK; kk += 8) mma_k8_3xtf32(acc, a_at(kk), b_at(kk));
}

// The sum over the four lanes of a quad (the row sums of a fragment) and
// over the eight groups (the column sums), in a fixed butterfly order.
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  return v + __shfl_xor_sync(0xffffffffu, v, 16);
}

// ---------------------------------------------------------------- scores --
__global__ void __launch_bounds__(kThreads)
bwd_scores_kernel(const float* __restrict__ u, const float* __restrict__ dac,
                  const float* __restrict__ b, const float* __restrict__ c,
                  const float* __restrict__ dy, float* __restrict__ cum_out,
                  float* __restrict__ e_out, float* __restrict__ scores,
                  float* __restrict__ dspart, float* __restrict__ rowpart,
                  float* __restrict__ colpart, int Q, int H, int P, int N, int HS, int ld,
                  bool vec_u, bool vec_bc) {
  const int T = gridDim.y, qt = blockIdx.y, kt = blockIdx.z;
  if (kt > qt) return;  // above the diagonal: never read
  const long long g = blockIdx.x / HS;
  const int hs = static_cast<int>(blockIdx.x % HS);
  const int hpb = (H + HS - 1) / HS;
  const int h0 = hs * hpb, nh = max(0, min(H, h0 + hpb) - h0);
  const int q0 = qt * kT, k0 = kt * kT;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const Lane l;
  const long long HP = static_cast<long long>(H) * P;
  __shared__ __align__(16) Stages st;
  __shared__ float cq[kHG][kT], ck[kHG][kT];  // cum of the group's heads on the q and k tiles

  // cum of each head of the group over the whole chunk, a warp a head: a
  // scan of 32 steps at a time plus the carry, the same order in every
  // block. Rows past Q are never read.
  const bool writer = qt == 0 && kt == 0;
  for (int hl = warp; hl < nh; hl += kThreads / 32) {
    const int h = h0 + hl;
    float carry = 0.f;
    for (int base = 0; base < Q; base += 32) {
      const int q = base + lane;
      float v = q < Q ? dac[(g * Q + q) * H + h] : 0.f;
#pragma unroll
      for (int off = 1; off < 32; off *= 2) {
        const float t = __shfl_up_sync(0xffffffffu, v, off);
        if (lane >= off) v += t;
      }
      v += carry;
      carry = __shfl_sync(0xffffffffu, v, 31);
      if (q >= q0 && q < q0 + kT) cq[hl][q - q0] = v;
      if (q >= k0 && q < k0 + kT) ck[hl][q - k0] = v;
      if (writer && q < Q) cum_out[(g * Q + q) * H + h] = v;
    }
    if (writer) {  // carry is cum at Q - 1
      for (int q = lane; q < Q; q += 32) {
        const long long o = (g * Q + q) * H + h;
        e_out[o] = expf(carry - cum_out[o]);
      }
    }
  }

  // Steps: the N slices of S = C.B^T, then the P slices of each head's W.
  const int NS = (N + kSK - 1) / kSK, PS = (P + kSK - 1) / kSK;
  const float* cg = c + (g * Q + q0) * N;
  const float* bg = b + (g * Q + k0) * N;
  const float* dyg = dy + (g * Q + q0) * HP;
  const float* ug = u + (g * Q + k0) * HP;
  auto issue = [&](int i) {
    float* sa = st.a[i & 1];
    float* sb = st.b[i & 1];
    if (i < NS) {
      const int n0 = i * kSK;
      load_tile<kT, kSK>(sa, kPitchRK, cg + n0, N, Q - q0, N - n0, vec_bc);
      load_tile<kT, kSK>(sb, kPitchRK, bg + n0, N, Q - k0, N - n0, vec_bc);
    } else {
      const int p0 = (i - NS) % PS * kSK;
      const long long off = static_cast<long long>(h0 + (i - NS) / PS) * P + p0;
      load_tile<kT, kSK>(sa, kPitchRK, dyg + off, HP, Q - q0, P - p0, vec_u);
      load_tile<kT, kSK>(sb, kPitchRK, ug + off, HP, Q - k0, P - p0, vec_u);
    }
  };

  float sacc[2][4][4], wacc[2][4][4], dsacc[2][4][4];
  zero_acc(sacc);
  zero_acc(dsacc);
  auto compute = [&](int i) {
    const float* sa = st.a[i & 1];
    const float* sb = st.b[i & 1];
    auto a_at = [&](int kk) { return a_rows(sa, l, kk, Plain()); };
    auto b_at = [&](int kk) { return b_cols(sb, l, kk); };
    if (i < NS) {
      mma_slice(sacc, a_at, b_at);
      return;
    }
    const int hl = (i - NS) / PS, ps = (i - NS) % PS;
    if (ps == 0) zero_acc(wacc);
    mma_slice(wacc, a_at, b_at);
    if (ps + 1 < PS) return;
    // Head hl is complete: L o W into dS, and G = S o L o W's sums.
    float rsum[2][2] = {}, csum[4][2] = {};
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int row = l.wm + a * 16 + l.gid + 8 * (r >> 1);
          const int col = l.wn + j * 8 + 2 * l.tig + (r & 1);
          const int q = q0 + row, k = k0 + col;
          const float lv =
              (q < Q && k <= q) ? exp2f((cq[hl][row] - ck[hl][col]) * kLog2e) : 0.f;
          const float lw = lv * wacc[a][j][r];
          dsacc[a][j][r] += lw;
          const float gv = sacc[a][j][r] * lw;
          rsum[a][r >> 1] += gv;
          csum[j][r & 1] += gv;
        }
    const long long h = h0 + hl;
    float* rp = rowpart + ((g * 2 * T + 2 * kt + warp % 2) * H + h) * Q;
    float* cp = colpart + ((g * 2 * T + 2 * qt + warp / 2) * H + h) * Q;
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float v = quad_sum(rsum[a][hh]);
        const int q = q0 + l.wm + a * 16 + l.gid + 8 * hh;
        if (l.tig == 0 && q < Q) rp[q] = v;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float v = group_sum(csum[j][e]);
        const int k = k0 + l.wn + j * 8 + 2 * l.tig + e;
        if (l.gid == 0 && k < Q) cp[k] = v;
      }
  };
  pipeline(NS + nh * PS, issue, compute);

  // The tiles go out with their padding columns up to ld (zeros in dS).
  const long long QL = static_cast<long long>(Q) * ld;
  const long long at = static_cast<long long>(q0) * ld + k0;
  auto store = [&](float* dst) {
    return [=](int r, int col, float v0, float v1) {
      const int q = l.wm + r, k = l.wn + col;
      if (q0 + q < Q) store_pair(dst + static_cast<long long>(q) * ld + k, ld - k0 - k, v0, v1, true);
    };
  };
  store_acc(dsacc, store(dspart + (g * HS + hs) * QL + at));
  if (hs == 0) store_acc(sacc, store(scores + g * QL + at));
}

// ------------------------------------------------------------------- mid --
struct MidSmem {
  Stages st;
  float cum[kMaxQ];    // (a): cum of the head from the k tile on
  float ek[kT];        // (a): e on the k tile
  float rred[2][kT];   // (a): r's halves
  float erow[2][kT];   // (b): e of the step's head on the k tile
};

// (a) du[k, :] for one (cell, head, k tile), 64 columns of P a pass, and r.
__device__ __forceinline__ void du_block(MidSmem& sm, const float* __restrict__ u,
                                         const float* __restrict__ b,
                                         const float* __restrict__ dy,
                                         const float* __restrict__ ds,
                                         const float* __restrict__ cum,
                                         const float* __restrict__ e,
                                         const float* __restrict__ scores, float* __restrict__ du,
                                         float* __restrict__ r, long long g, int h, int kt, int Q,
                                         int H, int P, int N, int ld, bool vec_u, bool vec_b,
                                         bool vec_ds, bool vec_du) {
  const int k0 = kt * kT;
  const Lane l;
  const long long HP = static_cast<long long>(H) * P;
  for (int q = k0 + threadIdx.x; q < Q; q += kThreads) sm.cum[q] = cum[(g * Q + q) * H + h];
  if (threadIdx.x < kT) {
    const int k = k0 + threadIdx.x;
    sm.ek[threadIdx.x] = k < Q ? e[(g * Q + k) * H + h] : 0.f;
  }
  // Steps, for each 64 columns pc of P: the N slices of B.ds_h^T, whose
  // product, scaled by e, then takes the q slices of M^T.dy (q >= k0) in
  // the same accumulator.
  const int QS = (Q - k0 + kSK - 1) / kSK, NS = (N + kSK - 1) / kSK, per = QS + NS;
  const int PT = (P + kT - 1) / kT;
  const float* sg = scores + g * Q * static_cast<long long>(ld);
  const float* dyg = dy + g * Q * HP + static_cast<long long>(h) * P;
  const float* bg = b + (g * Q + k0) * N;
  const float* dsh = ds + (g * H + h) * static_cast<long long>(P) * N;
  auto issue = [&](int i) {
    const int pc = i / per * kT, s = i % per;
    float* sa = sm.st.a[i & 1];
    float* sb = sm.st.b[i & 1];
    if (s < NS) {
      const int n0 = s * kSK;
      load_tile<kT, kSK>(sa, kPitchRK, bg + n0, N, Q - k0, N - n0, vec_b);
      load_tile<kT, kSK>(sb, kPitchRK, dsh + static_cast<long long>(pc) * N + n0, N, P - pc,
                         N - n0, vec_ds);
    } else {
      const int q0 = k0 + (s - NS) * kSK;
      load_tile<kSK, kT>(sa, kPitchKC, sg + static_cast<long long>(q0) * ld + k0, ld, Q - q0,
                         Q - k0, true);
      load_tile<kSK, kT>(sb, kPitchKC, dyg + q0 * HP + pc, HP, Q - q0, P - pc, vec_u);
    }
  };
  float acc[2][4][4], rs[2][2] = {};
  auto compute = [&](int i) {
    const int pc = i / per * kT, s = i % per;
    const float* sa = sm.st.a[i & 1];
    const float* sb = sm.st.b[i & 1];
    if (s == 0) zero_acc(acc);
    if (s < NS) {
      mma_slice(acc, [&](int kk) { return a_rows(sa, l, kk, Plain()); },
                [&](int kk) { return b_cols(sb, l, kk); });
      if (s + 1 < NS) return;
      // acc = e o (B.ds_h^T); r's terms u[k].acc[k] on these columns.
      const float* ugk = u + (g * Q + k0) * HP + static_cast<long long>(h) * P + pc;
#pragma unroll
      for (int a = 0; a < 2; ++a)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int row = l.wm + a * 16 + l.gid + 8 * hh;
          const float ev = sm.ek[row];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = l.wn + j * 8 + 2 * l.tig, lim = k0 + row < Q ? P - pc - col : 0;
            const long long o = row * HP + col;
            float& t0 = acc[a][j][2 * hh];
            float& t1 = acc[a][j][2 * hh + 1];
            t0 *= ev;
            t1 *= ev;
            if (lim >= 1) rs[a][hh] += ugk[o] * t0;
            if (lim >= 2) rs[a][hh] += ugk[o + 1] * t1;
          }
        }
      return;
    }
    // A = M^T: S[q][k] o L in fp32, zero for k > q and past Q.
    const int q0 = k0 + (s - NS) * kSK;
    const float* cs = sm.cum;
    auto m = [=](int row, int col, float v) {
      const int q = q0 + col, k = k0 + row;
      return (q < Q && k <= q) ? v * exp2f((cs[q] - cs[k]) * kLog2e) : 0.f;
    };
    mma_slice(acc, [&](int kk) { return a_cols(sa, l, kk, m); },
              [&](int kk) { return b_rows(sb, l, kk); });
    if (s + 1 < per) return;
    float* dug = du + (g * Q + k0) * HP + static_cast<long long>(h) * P + pc;
    store_acc(acc, [&](int row, int col, float v0, float v1) {
      const int k = l.wm + row, p = l.wn + col;
      if (k0 + k < Q) store_pair(dug + k * HP + p, P - pc - p, v0, v1, vec_du);
    });
  };
  pipeline(PT * per, issue, compute);
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float v = quad_sum(rs[a][hh]);
      if (l.tig == 0) sm.rred[threadIdx.x / 32 % 2][l.wm + a * 16 + l.gid + 8 * hh] = v;
    }
  __syncthreads();
  if (threadIdx.x < kT && k0 + static_cast<int>(threadIdx.x) < Q)
    r[(g * Q + k0 + threadIdx.x) * H + h] = sm.rred[0][threadIdx.x] + sm.rred[1][threadIdx.x];
}

// (b) dbpart[g, js, k, n] = sum over the heads h of group js and p of
// e_h[k] u[k, h, p] ds[h, p, n], for one (k tile, 64 columns of N).
__device__ __forceinline__ void dbstate_block(MidSmem& sm, const float* __restrict__ u,
                                              const float* __restrict__ e,
                                              const float* __restrict__ ds,
                                              float* __restrict__ dbpart, long long g, int kt,
                                              int nt, int js, int Q, int H, int P, int N, int JS,
                                              bool vec_u, bool vec_ds) {
  const int k0 = kt * kT, n0 = nt * kT;
  const Lane l;
  const long long HP = static_cast<long long>(H) * P;
  const int hpj = (H + JS - 1) / JS, hb = js * hpj, nh = max(0, min(H, hb + hpj) - hb);
  const int PS = (P + kSK - 1) / kSK;
  const float* ug = u + (g * Q + k0) * HP;
  auto issue = [&](int i) {
    const int h = hb + i / PS, p0 = i % PS * kSK;
    load_tile<kT, kSK>(sm.st.a[i & 1], kPitchRK, ug + static_cast<long long>(h) * P + p0, HP,
                       Q - k0, P - p0, vec_u);
    load_tile<kSK, kT>(sm.st.b[i & 1], kPitchKC,
                       ds + ((g * H + h) * P + p0) * static_cast<long long>(N) + n0, N, P - p0,
                       N - n0, vec_ds);
    if (threadIdx.x < kT) {
      const int k = k0 + threadIdx.x;
      const float* src = e + (g * Q + k) * H + h;
      cp_async4(&sm.erow[i & 1][threadIdx.x], k < Q ? src : e, k < Q);
    }
  };
  float acc[2][4][4];
  zero_acc(acc);
  auto compute = [&](int i) {
    const float* er = sm.erow[i & 1];
    auto scaled = [=](int row, int, float v) { return v * er[row]; };
    mma_slice(acc, [&](int kk) { return a_rows(sm.st.a[i & 1], l, kk, scaled); },
              [&](int kk) { return b_rows(sm.st.b[i & 1], l, kk); });
  };
  pipeline(nh * PS, issue, compute);
  float* out = dbpart + ((g * JS + js) * Q + k0) * static_cast<long long>(N) + n0;
  store_acc(acc, [&](int row, int col, float v0, float v1) {
    const int k = l.wm + row, n = l.wn + col;
    if (k0 + k < Q) store_pair(out + static_cast<long long>(k) * N + n, N - n0 - n, v0, v1, N % 2 == 0);
  });
}

// (c) dS on one 64 x 64 tile (k tile <= q tile): the HS groups' tiles summed
// in order, padding columns included.
__device__ __forceinline__ void dsum_block(const float* __restrict__ dspart,
                                           float* __restrict__ dscores, long long g, int qt,
                                           int kt, int Q, int HS, int ld) {
  const long long QL = static_cast<long long>(Q) * ld;
  for (int i = threadIdx.x; i < kT * kT / 4; i += kThreads) {
    const int q = qt * kT + i / (kT / 4), k = kt * kT + i % (kT / 4) * 4;
    if (q >= Q || k >= ld) continue;
    const long long o = static_cast<long long>(q) * ld + k;
    float4 v = *reinterpret_cast<const float4*>(dspart + g * HS * QL + o);
    for (int s = 1; s < HS; ++s) {
      const float4 w = *reinterpret_cast<const float4*>(dspart + (g * HS + s) * QL + o);
      v.x += w.x;
      v.y += w.y;
      v.z += w.z;
      v.w += w.w;
    }
    *reinterpret_cast<float4*>(dscores + g * QL + o) = v;
  }
}

__global__ void __launch_bounds__(kThreads)
bwd_mid_kernel(const float* __restrict__ u, const float* __restrict__ b,
               const float* __restrict__ dy, const float* __restrict__ ds,
               const float* __restrict__ cum, const float* __restrict__ e,
               const float* __restrict__ scores, const float* __restrict__ dspart,
               float* __restrict__ du, float* __restrict__ r, float* __restrict__ dbpart,
               float* __restrict__ dscores, long long G, int Q, int H, int P, int N, int HS,
               int JS, int ld, bool vec_u, bool vec_bc, bool vec_ds, bool vec_du) {
  __shared__ __align__(16) MidSmem sm;
  const int T = (Q + kT - 1) / kT, NT = (N + kT - 1) / kT;
  const long long n_du = G * H * T, n_db = G * T * NT * JS;
  long long bid = blockIdx.x;
  if (bid < n_du) {
    const int kt = static_cast<int>(bid % T);
    bid /= T;
    du_block(sm, u, b, dy, ds, cum, e, scores, du, r, bid / H, static_cast<int>(bid % H), kt, Q,
             H, P, N, ld, vec_u, vec_bc, vec_ds, vec_du);
    return;
  }
  bid -= n_du;
  if (bid < n_db) {
    const int js = static_cast<int>(bid % JS);
    bid /= JS;
    const int nt = static_cast<int>(bid % NT);
    bid /= NT;
    dbstate_block(sm, u, e, ds, dbpart, bid / T, static_cast<int>(bid % T), nt, js, Q, H, P, N,
                  JS, vec_u, vec_ds);
    return;
  }
  bid -= n_db;
  const int kt = static_cast<int>(bid % T);
  bid /= T;
  const int qt = static_cast<int>(bid % T);
  if (kt <= qt) dsum_block(dspart, dscores, bid / T, qt, kt, Q, HS, ld);
}

// ------------------------------------------------------------------- out --
// (a) dC[q, n] = sum_{k <= q} dS[q,k] B[k,n] on one (row tile, 64 columns).
__device__ __forceinline__ void dc_block(Stages& st, const float* __restrict__ b,
                                         const float* __restrict__ dscores,
                                         float* __restrict__ dc, long long g, int qt, int nt,
                                         int Q, int N, int ld, bool vec_b, bool vec_out) {
  const int q0 = qt * kT, n0 = nt * kT;
  const Lane l;
  const float* dsg = dscores + (g * Q + q0) * static_cast<long long>(ld);
  const float* bg = b + g * Q * static_cast<long long>(N) + n0;
  auto issue = [&](int i) {
    const int ks = i * kSK;
    load_tile<kT, kSK>(st.a[i & 1], kPitchRK, dsg + ks, ld, Q - q0, Q - ks, true);
    load_tile<kSK, kT>(st.b[i & 1], kPitchKC, bg + static_cast<long long>(ks) * N, N, Q - ks,
                       N - n0, vec_b);
  };
  float acc[2][4][4];
  zero_acc(acc);
  auto compute = [&](int i) {
    const int ks = i * kSK;
    auto causal = [=](int row, int col, float v) {
      const int q = q0 + row, k = ks + col;
      return (q < Q && k <= q) ? v : 0.f;
    };
    mma_slice(acc, [&](int kk) { return a_rows(st.a[i & 1], l, kk, causal); },
              [&](int kk) { return b_rows(st.b[i & 1], l, kk); });
  };
  pipeline((min(q0 + kT, Q) + kSK - 1) / kSK, issue, compute);
  float* out = dc + (g * Q + q0) * static_cast<long long>(N) + n0;
  store_acc(acc, [&](int row, int col, float v0, float v1) {
    const int q = l.wm + row, n = l.wn + col;
    if (q0 + q < Q) store_pair(out + static_cast<long long>(q) * N + n, N - n0 - n, v0, v1, vec_out);
  });
}

// (b) dB[k, n] = sum_{q >= k} dS[q,k] C[q,n] + the JS groups' state terms
// in order, on one (row tile, 64 columns).
__device__ __forceinline__ void db_block(Stages& st, const float* __restrict__ c,
                                         const float* __restrict__ dscores,
                                         const float* __restrict__ dbpart,
                                         float* __restrict__ db, long long g, int kt, int nt,
                                         int Q, int N, int JS, int ld, bool vec_c, bool vec_out) {
  const int k0 = kt * kT, n0 = nt * kT;
  const Lane l;
  const float* dsg = dscores + g * Q * static_cast<long long>(ld) + k0;
  const float* cg = c + g * Q * static_cast<long long>(N) + n0;
  auto issue = [&](int i) {
    const int q0 = k0 + i * kSK;
    load_tile<kSK, kT>(st.a[i & 1], kPitchKC, dsg + static_cast<long long>(q0) * ld, ld, Q - q0,
                       Q - k0, true);
    load_tile<kSK, kT>(st.b[i & 1], kPitchKC, cg + static_cast<long long>(q0) * N, N, Q - q0,
                       N - n0, vec_c);
  };
  float acc[2][4][4];
  zero_acc(acc);
  auto compute = [&](int i) {
    const int q0 = k0 + i * kSK;
    auto causal = [=](int row, int col, float v) {
      const int q = q0 + col, k = k0 + row;
      return (q < Q && k <= q) ? v : 0.f;
    };
    mma_slice(acc, [&](int kk) { return a_cols(st.a[i & 1], l, kk, causal); },
              [&](int kk) { return b_rows(st.b[i & 1], l, kk); });
  };
  pipeline((Q - k0 + kSK - 1) / kSK, issue, compute);
  const long long QN = static_cast<long long>(Q) * N;
  store_acc(acc, [&](int row, int col, float v0, float v1) {
    const int k = k0 + l.wm + row, n = n0 + l.wn + col;
    if (k >= Q || n >= N) return;
    const long long o = static_cast<long long>(k) * N + n;
    for (int s = 0; s < JS; ++s) {
      const float* part = dbpart + (g * JS + s) * QN + o;
      v0 += part[0];
      if (n + 1 < N) v1 += part[1];
    }
    store_pair(db + g * QN + o, N - n, v0, v1, vec_out);
  });
}

// (c) ddac for one (cell, head): each thread sums the partial row and
// column sums with r into dcum for its rows q, then the block takes the
// reverse cumulative sum over q in shared memory (a fixed order).
__device__ __forceinline__ void dac_block(float* dcum, float* red,
                                          const float* __restrict__ rowpart,
                                          const float* __restrict__ colpart,
                                          const float* __restrict__ r, float* __restrict__ ddac,
                                          long long g, int h, int Q, int H, int T) {
  const long long base = g * Q * H + h;
  // sum_k r[k], first as each thread's share, then over the block
  float rt = 0.f;
  for (int q = threadIdx.x; q < Q; q += kThreads) rt += r[base + static_cast<long long>(q) * H];
  red[threadIdx.x] = rt;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (static_cast<int>(threadIdx.x) < w) red[threadIdx.x] += red[threadIdx.x + w];
    __syncthreads();
  }
  rt = red[0];
  // Half-tile t of rowpart (colpart) holds the row (column) sums of G over
  // k tile (q tile) t / 2.
  const float* rp = rowpart + (g * 2 * T * H + h) * static_cast<long long>(Q);
  const float* cp = colpart + (g * 2 * T * H + h) * static_cast<long long>(Q);
  const long long half = static_cast<long long>(H) * Q;
  for (int q = threadIdx.x; q < Q; q += kThreads) {
    const int tq = q / kT;
    float d = -r[base + static_cast<long long>(q) * H];
    if (q == Q - 1) d += rt;
    for (int t = 0; t < 2 * (tq + 1); ++t) d += rp[t * half + q];
    for (int t = 2 * tq; t < 2 * T; ++t) d -= cp[t * half + q];
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

__global__ void __launch_bounds__(kThreads)
bwd_out_kernel(const float* __restrict__ b, const float* __restrict__ c,
               const float* __restrict__ dscores, const float* __restrict__ dbpart,
               const float* __restrict__ rowpart, const float* __restrict__ colpart,
               const float* __restrict__ r, float* __restrict__ db, float* __restrict__ dc,
               float* __restrict__ ddac, long long G, int Q, int H, int N, int JS, int ld,
               bool vec_bc, bool vec_out) {
  __shared__ __align__(16) Stages st;
  static_assert(sizeof(Stages) >= (kMaxQ + kThreads) * sizeof(float), "dac fits the stages");
  const int T = (Q + kT - 1) / kT, NT = (N + kT - 1) / kT;
  long long bid = blockIdx.x;
  const long long n_tiles = G * T * NT;
  if (bid < 2 * n_tiles) {
    const bool is_db = bid >= n_tiles;
    if (is_db) bid -= n_tiles;
    const int nt = static_cast<int>(bid % NT);
    bid /= NT;
    const int t = static_cast<int>(bid % T);
    if (is_db)
      db_block(st, c, dscores, dbpart, db, bid / T, t, nt, Q, N, JS, ld, vec_bc, vec_out);
    else
      dc_block(st, b, dscores, dc, bid / T, t, nt, Q, N, ld, vec_bc, vec_out);
    return;
  }
  bid -= 2 * n_tiles;
  float* dcum = &st.a[0][0];
  dac_block(dcum, dcum + kMaxQ, rowpart, colpart, r, ddac, bid / H, static_cast<int>(bid % H), Q,
            H, T);
}

bool aligned8(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 7) == 0; }

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
  if (H == 0 || P == 0) {  // no head: every gradient but du (empty) is zero
    const size_t bytes = static_cast<size_t>(G) * Q * N * sizeof(float);
    int err = static_cast<int>(cudaMemsetAsync(db, 0, bytes, s));
    if (err == 0) err = static_cast<int>(cudaMemsetAsync(dc, 0, bytes, s));
    if (err == 0)
      err = static_cast<int>(
          cudaMemsetAsync(ddac, 0, static_cast<size_t>(G) * Q * H * sizeof(float), s));
    return err;
  }
  if ((H + HS - 1) / HS > kHG) return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(scores) || !aligned16(dscores) || !aligned16(dspart))
    return static_cast<int>(cudaErrorMisalignedAddress);
  const int T = (Q + kT - 1) / kT, NT = (N + kT - 1) / kT, ld = (Q + 3) / 4 * 4;
  const long long mid_blocks = G * (static_cast<long long>(H) * T + static_cast<long long>(T) * NT * JS + T * T);
  const long long out_blocks = G * (2LL * T * NT + H);
  if (G * HS > 0x7fffffffLL || mid_blocks > 0x7fffffffLL || out_blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const bool vec_u = aligned16(u) && aligned16(dy) && P % 4 == 0;
  const bool vec_bc = aligned16(b) && aligned16(c) && N % 4 == 0;
  const bool vec_ds = aligned16(ds) && N % 4 == 0;
  const bool vec_du = P % 2 == 0 && aligned8(du);
  const bool vec_out = N % 2 == 0 && aligned8(db) && aligned8(dc);
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

  bwd_scores_kernel<<<dim3(static_cast<unsigned>(G * HS), T, T), kThreads, 0, s>>>(
      uf, static_cast<const float*>(dac), bf, cf, dyf, cumf, ef, sf, dsp, rp, cp, Q, H, P, N, HS,
      ld, vec_u, vec_bc);
  int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bwd_mid_kernel<<<static_cast<unsigned>(mid_blocks), kThreads, 0, s>>>(
      uf, bf, dyf, dsf, cumf, ef, sf, dsp, static_cast<float*>(du), rf, dbp, dsc, G, Q, H, P, N,
      HS, JS, ld, vec_u, vec_bc, vec_ds, vec_du);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  bwd_out_kernel<<<static_cast<unsigned>(out_blocks), kThreads, 0, s>>>(
      bf, cf, dsc, dbp, rp, cp, rf, static_cast<float*>(db), static_cast<float*>(dc),
      static_cast<float*>(ddac), G, Q, H, N, JS, ld, vec_bc, vec_out);
  return static_cast<int>(cudaGetLastError());
}
