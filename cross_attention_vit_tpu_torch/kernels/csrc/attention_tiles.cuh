// Shared pieces of the attention kernels (flash_attention_fwd.cu, K1, and
// flash_attention_bwd.cu, K2): the tile sizes, the bf16 tensor-core product
// and the 16-byte staging of 64-row operand tiles through registers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int BQ = 64;             // query rows per tile
constexpr int BK = 64;             // keys per tile
constexpr int D = 64;              // head dim (1024/16, 768/12, 192/3: every
                                   // configuration of the repo)
constexpr int MMA_THREADS = 128;   // bf16 kernels: 4 warps × 16 rows
constexpr int PADH = 8;            // bf16 row pad: conflict-free fragment loads

// c += a·b for one 16×8 tile: a is 16×16 (row-major fragment), b 16×8.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// exp(a − m), 0 where a is −inf (masked), guarding −inf − −inf.
__device__ __forceinline__ float exp_shift(float a, float m) {
  return a == -INFINITY ? 0.f : expf(a - m);
}

// One 64-row tile of a (rows, D) bf16 operand held in registers as 16-byte
// chunks, so a tile's loads can be in flight while the tensor cores work.
// Needs a unit head-dim stride and 16-byte aligned rows (the wrappers
// check).  Rows ≥ N load as zeros.
struct Tile {
  static constexpr int kChunks = BK * D / 8 / MMA_THREADS;   // per thread
  uint4 v[kChunks];

  // row-major chunk order: a warp reads whole rows (coalesced)
  __device__ __forceinline__ void load_rows(const bf16* src, int n0, int N, long long sn) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = threadIdx.x + i * MMA_THREADS;
      const int n = n0 + c / (D / 8);
      v[i] = n < N ? *reinterpret_cast<const uint4*>(src + n * sn + (c % (D / 8)) * 8)
                   : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void store_rows(bf16* dst, int ld) const {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = threadIdx.x + i * MMA_THREADS;
      *reinterpret_cast<uint4*>(dst + (c / (D / 8)) * ld + (c % (D / 8)) * 8) = v[i];
    }
  }
  // column chunk order: a warp covers 32 rows of one 8-wide column chunk, so
  // the transposed scalar stores below hit 32 consecutive addresses
  __device__ __forceinline__ void load_cols(const bf16* src, int n0, int N, long long sn) {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = threadIdx.x + i * MMA_THREADS;
      const int n = n0 + c % BK;
      v[i] = n < N ? *reinterpret_cast<const uint4*>(src + n * sn + (c / BK) * 8)
                   : make_uint4(0, 0, 0, 0);
    }
  }
  __device__ __forceinline__ void store_transposed(bf16* dst, int ld) const {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = threadIdx.x + i * MMA_THREADS;
      const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
      for (int j = 0; j < 8; ++j) dst[((c / BK) * 8 + j) * ld + c % BK] = e[j];
    }
  }
  // transposed, each row multiplied by row_scale[row] in f32 and rounded
  __device__ __forceinline__ void store_transposed_scaled(bf16* dst, int ld,
                                                          const float* row_scale) const {
#pragma unroll
    for (int i = 0; i < kChunks; ++i) {
      const int c = threadIdx.x + i * MMA_THREADS;
      const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
      const float r = row_scale[c % BK];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        dst[((c / BK) * 8 + j) * ld + c % BK] = __float2bfloat16_rn(__bfloat162float(e[j]) * r);
    }
  }
};

}  // namespace
