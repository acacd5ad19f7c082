// Split-TF32 building blocks shared by the SSD Stage 1 kernels
// (ssd_stage1.cu, forward; ssd_stage1_bwd.cu, backward): cp.async staging of
// operand tiles, the split of an fp32 value into a TF32 high part and a TF32
// remainder, mma.sync.m16n8k8 (TF32 in, fp32 out) and the three products of
// split TF32, and the m16n8k8 accumulator's stores. Every block that uses
// them runs kThreads threads.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // four warps a block
constexpr float kLog2e = 1.4426950408889634f;

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = ok ? 16 : 0;  // 0: zero-fill, nothing read
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool ok) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = ok ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copy a rows x cols tile (cols a multiple of 4) of a row-major source with
// row stride `stride` into shared memory at row pitch `pitch`; rows at or
// past row_lim and columns at or past col_lim read as zero. With vec, the
// source rows are 16-byte aligned and each group of 4 columns that starts
// before col_lim is copied whole.
template <int kRows, int kCols>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const float* src,
                                          long long stride, int row_lim, int col_lim, bool vec) {
  constexpr int kC4 = kCols / 4;
  for (int i = threadIdx.x; i < kRows * kC4; i += kThreads) {
    const int r = i / kC4, c = (i % kC4) * 4;
    float* d = dst + r * pitch + c;
    const float* s = src + r * stride + c;
    const bool row_ok = r < row_lim;
    if (vec) {
      const bool ok = row_ok && c < col_lim;
      cp_async16(d, ok ? s : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row_ok && c + e < col_lim;
        cp_async4(d + e, ok ? s + e : src, ok);
      }
    }
  }
}

// The bits of cvt.rna.tf32.f32 for every x but a NaN: adding half of the
// 13 dropped bits' unit to the magnitude and clearing them rounds to
// nearest, ties away from zero. A NaN with its high mantissa bits set
// carries into the sign and comes out as a zero. Two integer operations
// issue faster than cvt, which runs on the conversion unit (PERF.md).
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo with hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi)
// (x - hi is exact) for every finite x. hi also takes x * 0, one FMA on
// the FP32 pipe while the rounding holds the integer pipe: +-0 for a
// finite x, which leaves hi's bits as they are, and NaN for a NaN or an
// infinity. Every term of a split-TF32 product holds one of its operands'
// hi, so a non-finite operand makes the product NaN, as the plain
// version's is NaN or infinite; lo is then of no account.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  const float h = __fmaf_rn(x, 0.f, __uint_as_float(rna_tf32(x)));
  hi = __float_as_uint(h);
  lo = rna_tf32(x - h);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments of m16n8k8 (gid = lane / 4, tig = lane % 4). A register r of
// m tile i holds row i*16 + gid + 8*(r % 2), column tig + 4*(r / 2); B
// register r of n tile j holds row (k) tig + 4*r, column j*8 + gid.
// a(i, h, c) returns A at row i*16 + gid + 8*h, column tig + 4*c, and
// b(j, r) returns B at row tig + 4*r, column j*8 + gid; each value is
// split into its TF32 high part and remainder.
template <int MT, typename ALoad>
__device__ __forceinline__ void split_a(uint32_t (&hi)[MT][4], uint32_t (&lo)[MT][4], ALoad a) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) split_tf32(a(i, r & 1, r >> 1), hi[i][r], lo[i][r]);
}

template <int NT, typename BLoad>
__device__ __forceinline__ void split_b(uint32_t (&hi)[NT][2], uint32_t (&lo)[NT][2], BLoad b) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) split_tf32(b(j, r), hi[j][r], lo[j][r]);
}

// acc += A . B for one k step of 8 in split TF32: lo*hi + hi*lo + hi*hi,
// small terms first. Each pass walks all MT x NT tiles, so that no MMA
// waits on the one just issued.
template <int MT, int NT>
__device__ __forceinline__ void mma_3xtf32(float (&acc)[MT][NT][4], const uint32_t (&ahi)[MT][4],
                                           const uint32_t (&alo)[MT][4],
                                           const uint32_t (&bhi)[NT][2],
                                           const uint32_t (&blo)[NT][2]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], alo[i], bhi[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ahi[i], blo[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ahi[i], bhi[j]);
}

template <int MT, int NT, typename ALoad, typename BLoad>
__device__ __forceinline__ void mma_k8_3xtf32(float (&acc)[MT][NT][4], ALoad a, BLoad b) {
  uint32_t ahi[MT][4], alo[MT][4], bhi[NT][2], blo[NT][2];
  split_a(ahi, alo, a);
  split_b(bhi, blo, b);
  mma_3xtf32(acc, ahi, alo, bhi, blo);
}

// acc[i][j][r] sits at warp-tile row i*16 + gid + 8*(r/2), column
// j*8 + 2*tig + r%2; store(row, col, v0, v1) writes the pair at an even
// column col and col + 1.
template <int MT, int NT, typename Store>
__device__ __forceinline__ void store_acc(const float (&acc)[MT][NT][4], Store store) {
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        store(i * 16 + gid + 8 * h, j * 8 + 2 * tig, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
}

// Write v0, v1 at dst[0], dst[1] where they fall before lim (counted from
// dst), as one 8-byte store when vec (dst 8-byte aligned) and both do.
__device__ __forceinline__ void store_pair(float* dst, int lim, float v0, float v1, bool vec) {
  if (vec && lim >= 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
  } else {
    if (lim >= 1) dst[0] = v0;
    if (lim >= 2) dst[1] = v1;
  }
}

template <int MT, int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;
}

}  // namespace
