// Hopper (sm_90a) pieces of the redesigned kernels (K1, K2, K5, K6, K7's
// forward, K8): 64-row bf16 tiles staged by cp.async in the 128-byte
// swizzle that wgmma reads, wgmma descriptors for those tiles read K-major
// or transposed (MN-major), and the products the kernels run on them.
//
// A tile is 64 rows × D = 64 bf16 (8 KB), row-major, 1024-byte aligned, with
// the 16-byte chunk c of row r stored at chunk c ^ (r mod 8) of its row (the
// layout TMA's SWIZZLE_128B writes).  The same tile serves as a K-major
// operand (rows are M or N, the head dim the reduction: q·kᵀ) and as a
// transposed, MN-major B operand (rows are the reduction, the head dim N:
// e·v, ds·k), so no operand is staged twice.  K8's wide products (the last
// section) stage any bf16 matrix in such tiles, 64 × 64 at a time, as it
// lies in memory, and read each either way through the descriptor.

#pragma once

#include "attention_tiles.cuh"

namespace {

constexpr int WG_THREADS = 128;           // one warpgroup: 4 warps × 16 rows
constexpr int TILE = 64 * D;              // elements of one 64-row tile
constexpr int SMEM_ALIGN = 1024;          // the swizzle repeats every 8 rows

// The forward's row statistics, a (2, B, K, N) f32 tensor that K1 (and K5's
// and K6's forwards) write and the backward kernels read: [0] m, the row max
// of the scaled f32 scores s = q·kᵀ·scale; [1] r = 1 / Σ_j exp(s_j − m).  The
// backward's delta is a (1, B, K, N) tensor of the same indexing.
__device__ __forceinline__ float* stat(float* stats, int which, int B, int K, int N, int b,
                                       int h) {
  return stats + ((static_cast<long long>(which) * B + b) * K + h) * N;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The 1024-byte aligned start of the dynamic shared memory (the launchers
// ask for SMEM_ALIGN bytes more than the kernel uses).
__device__ __forceinline__ bf16* aligned_smem(void* raw) {
  const uint32_t a = smem_u32(raw);
  return reinterpret_cast<bf16*>(static_cast<char*>(raw) + ((SMEM_ALIGN - a % SMEM_ALIGN) % SMEM_ALIGN));
}

// Rows [n0, n0 + 64) of a (rows, D) bf16 operand (row stride sn elements,
// unit head-dim stride, 16-byte aligned rows) into the swizzled tile `dst`,
// 16 bytes per cp.async, 4 per thread.  Rows ≥ N are zero-filled without a
// read.  n0 < N.  `tid` is the thread's index in the warpgroup that copies.
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src, int n0, int N,
                                                long long sn, int tid = threadIdx.x) {
#pragma unroll
  for (int i = 0; i < TILE / 8 / WG_THREADS; ++i) {
    const int c = tid + i * WG_THREADS;
    const int r = c >> 3, ch = c & 7;
    const bool ok = n0 + r < N;
    const bf16* p = src + static_cast<long long>(ok ? n0 + r : n0) * sn + ch * 8;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + r * D + ((ch ^ (r & 7)) << 3))),
                 "l"(p), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

// one f32 by cp.async: src[0], or 0 without a read when !ok
__device__ __forceinline__ void load_f32_async(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// A ring of `Stages` slots of tiles copied by cp.async: step i's tiles land
// in slot i % Stages, issued Stages − 1 steps ahead.  `issue(i)` starts the
// copies of step i (it does not commit).  ring_begin issues the first
// Stages − 1 steps; ring_step(i) waits for step i's copies (every thread's,
// made visible to wgmma, the async proxy), then one barrier — which also
// tells that every thread has finished step i − 1 and so frees its slot —
// and issues step i + Stages − 1 into that slot.  One barrier per step.
template <int Stages, class Issue>
__device__ __forceinline__ void ring_begin(int steps, Issue&& issue) {
#pragma unroll
  for (int i = 0; i < Stages - 1; ++i) {
    if (i < steps) issue(i);
    cp_async_commit();
  }
}

template <int Stages, class Issue>
__device__ __forceinline__ void ring_step(int i, int steps, Issue&& issue) {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Stages - 2) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  if (i + Stages - 1 < steps) issue(i + Stages - 1);
  cp_async_commit();
}

// The element (row, col) of a swizzled tile.
__device__ __forceinline__ int swz(int row, int col) {
  return row * D + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

// wgmma descriptor of a swizzled tile: 128-byte swizzle, 1024 bytes between
// 8-row groups (the stride field).  The leading field is read only by an
// MN-major operand wider than 64 (K8's products): `lbo` bytes between its
// 64-column tiles; elsewhere it is unused and gets 1024 too.  K-major
// operands advance 32 bytes (+2) per 16-deep step; MN-major ones 16 rows,
// 2048 bytes (+128).
__device__ __forceinline__ uint64_t desc(const bf16* tile, uint32_t lbo = 1024) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (uint64_t{64} << 32) | (uint64_t{1} << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}

// After wg_wait: the first `Regs` accumulators are read only from here on.
template <int Regs = 32>
__device__ __forceinline__ void settle(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < Regs; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[0, 8·NB) = a·b over 16 of the reduction: a (64 × 16) and b (16·NB × 16)
// both K-major, from shared memory.  Accumulator layout: warp w holds rows
// 16w + g and 16w + g + 8 (g = lane / 4); d[4j + x] is column 8j + 2t + x % 2
// (t = lane % 4) of row g + 8·(x / 2) — mma.sync's C fragment, per 8 columns.
template <int NB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int scale_d);

template <>
__device__ __forceinline__ void wgmma_ss<1>(float (&d)[32], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_ss<2>(float (&d)[32], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_ss<4>(float (&d)[32], uint64_t da, uint64_t db,
                                                 int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}
// d += a·b over 16 of the reduction: a (64 × 16) the bf16 A fragments in
// registers, b (16 × 64) read transposed (MN-major) from shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// s[0, 16·NB columns) = a·bᵀ over D: a and b K-major tiles (a 64 rows, of
// b its first 16·NB rows).  Issued, not waited for.
template <int NB>
__device__ __forceinline__ void mma_tn(float (&s)[32], const bf16* a, const bf16* b) {
  const uint64_t da = desc(a), db = desc(b);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss<NB>(s, da + 2 * kk, db + 2 * kk, kk > 0);
}

// mma_tn over the 16-column blocks holding a column < N: a tail of at most
// 16 columns (one: 513, 1025) runs 16 wide, any other tile 64 wide, masked
// by the caller.  Two widths and not four: fewer shapes draw fewer of the
// fences ptxas injects around wgmma.
__device__ __forceinline__ void mma_tn_n(float (&s)[32], const bf16* a, const bf16* b, int nb) {
  if (nb == 1)
    mma_tn<1>(s, a, b);
  else
    mma_tn<4>(s, a, b);
}

// Score-shaped accumulators (64 × 64) as the bf16 A fragments of the next
// product, 16 columns per step: the C layout of columns [16kk, 16kk + 16) is
// the A layout of that 16-deep step.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) a[kk][x] = pack(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
}

// d += a·b over the first 16·nk rows of b: a the packed fragments, b a
// 64-row tile read transposed (MN-major: its rows are the reduction, its
// head dim the output columns).  Issued, not waited for.
__device__ __forceinline__ void mma_nn(float (&d)[32], const uint32_t (&a)[4][4], const bf16* b,
                                       int nk) {
  const uint64_t db = desc(b);
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    if (kk < nk) wgmma_rs(d, a[kk], db + 128 * kk, 1);
}

__device__ __forceinline__ void zero32(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) d[i] = 0.f;
}

// Writes this thread's accumulator rows (row0 = 16·warp + g and row0 + 8 of
// the tile starting at n0) as bf16 into `dst` (unit head-dim stride, row
// stride sn), each multiplied by mul[half]; rows ≥ N are not stored.
__device__ __forceinline__ void store_acc_bf16(bf16* dst, long long sn, const float (&d)[32],
                                               int N, int n_first, int t,
                                               const float mul[2]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = n_first + 8 * half;
    if (n >= N) continue;
    bf16* row = dst + n * sn;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + 2 * t) = __floats2bfloat162_rn(
          d[4 * j + 2 * half] * mul[half], d[4 * j + 2 * half + 1] * mul[half]);
  }
}

// ---------------------------------------------------------------------------
// K8's wide products: C = A·Bᵀ by wgmma with both operands in shared memory
// ---------------------------------------------------------------------------

// Rows [r0, r0 + 64) × columns [c0, c0 + 64) of a row-major bf16 matrix
// (row stride ld elements, 16-byte aligned rows) into the swizzled tile
// `dst`, 16 bytes per cp.async, copied by `Threads` threads (`tid` this
// thread's index among them).  Rows ≥ R and 8-column chunks at or past C
// (C % 8 == 0) are zero-filled without a read.
template <int Threads>
__device__ __forceinline__ void load_block_async(bf16* dst, const bf16* src, long long ld,
                                                 int r0, int R, int c0, int C, int tid) {
#pragma unroll
  for (int i = 0; i < TILE / 8 / Threads; ++i) {
    const int c = tid + i * Threads;
    const int r = c >> 3, ch = c & 7;
    const bool ok = r0 + r < R && c0 + ch * 8 < C;
    const bf16* p = ok ? src + static_cast<long long>(r0 + r) * ld + c0 + ch * 8 : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst + r * D + ((ch ^ (r & 7)) << 3))),
                 "l"(p), "r"(ok ? 16 : 0)
                 : "memory");
  }
}

// d += a·b over 16 of the reduction, m64nNk16 with N = 192 or 256: a
// (64 × 16) and b (N × 16) from shared memory, each K-major (TA, TB = 0) or
// transposed, MN-major (1).  Accumulator layout as wgmma_ss's, N / 8 groups
// of 4.  Issued, not waited for.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, %96, %97, p, 1, 1, %99, %100;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_wide(float (&d)[N / 2], uint64_t da, uint64_t db) {
  static_assert(N == 192 || N == 256, "K8's products run n192 and n256");
  if constexpr (N == 192)
    wgmma_n192<TA, TB>(d, da, db);
  else
    wgmma_n256<TA, TB>(d, da, db);
}

}  // namespace
