// Shared pieces of the attention kernels: the tile sizes, the f32 staging
// and register-tile products of the CUDA-core path (K1, K2, K5, K6, K7), and
// the mma.sync products and 16-byte register staging of bf16 tiles that K7's
// backward kernels run (K1, K2, K5, K6, K7's forward and K8 run wgmma:
// hopper_tiles.cuh).

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
constexpr int LD = D + PADH;       // bf16 row-major tiles [row][d]
constexpr int LDV = BK + PADH;     // bf16 transposed tiles [d][row]
constexpr float LOG2E = 1.4426950408889634f;   // exp(x) = exp2(x·log2 e)

// Strides, in elements, of a (B, K, N, D) operand view (the K7 kernels).
struct View {
  long long b, h, n, d;
};

// the (b, h) slice of an operand view
template <typename P>
__device__ __forceinline__ P base(P p, const View& st, int b, int h) {
  return p + b * st.b + h * st.h;
}

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

// two f32 values rounded to bf16 and packed as one A-fragment register
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// exp(a − m), 0 where a is −inf (masked), guarding −inf − −inf.
__device__ __forceinline__ float exp_shift(float a, float m) {
  return a == -INFINITY ? 0.f : expf(a - m);
}

// This warp's 16 rows (from r0 = 16·warp + g) of a row-major [row][LD] tile
// as A fragments.
__device__ __forceinline__ void load_a(uint32_t f[D / 16][4], const bf16* tile, int r0, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* p = tile + r0 * LD + kk * 16 + 2 * t;
    f[kk][0] = ld_pair(p);
    f[kk][1] = ld_pair(p + 8 * LD);
    f[kk][2] = ld_pair(p + 8);
    f[kk][3] = ld_pair(p + 8 * LD + 8);
  }
}

// acc = a·bᵀ over D for this warp's 16 rows and the 64 rows of the row-major
// tile `bs`: 8 tiles of 8 columns; thread (g, t) holds rows g and g+8,
// columns 8j + 2t + {0, 1}.
__device__ __forceinline__ void mma_nt(float acc[BK / 8][4], const uint32_t af[D / 16][4],
                                       const bf16* bs, int g, int t) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[j][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const bf16* p = bs + (j * 8 + g) * LD + kk * 16 + 2 * t;
      mma_bf16(acc[j], af[kk], ld_pair(p), ld_pair(p + 8));
    }
}

// acc[jd] += a·b where a is 16 rows × 16 (the packed chunk) and b the
// transposed tile `bt` [d][row] at rows 16kk..16kk+15
__device__ __forceinline__ void mma_acc(float acc[D / 8][4], const uint32_t a[4],
                                        const bf16* bt, int kk, int g, int t) {
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    const bf16* p = bt + (jd * 8 + g) * LDV + kk * 16 + 2 * t;
    mma_bf16(acc[jd], a, ld_pair(p), ld_pair(p + 8));
  }
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
};

// the two bf16 values of a packed fragment register, as f32
__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs on the CUDA cores (no TF32)
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 256;   // a 16 × 16 grid; each thread owns 4 × 4
constexpr int LDT = BQ + 4;        // k-major tiles [k][row]: the pad spreads
                                   // staging stores over the banks and keeps
                                   // float4 reads 16-byte aligned

// rows [n0, n0 + 64) of one (N, D) f32 operand, transposed to [D][LDT]
__device__ __forceinline__ void stage_t(float* dst, const float* src, int n0, int N,
                                        long long sn, long long sd) {
  for (int i = threadIdx.x; i < BQ * D; i += F32_THREADS) {
    const int r = i / D, d = i % D;
    const int n = n0 + r;
    dst[d * LDT + r] = n < N ? src[n * sn + d * sd] : 0.f;
  }
}

// rows [n0, n0 + 64) of one (N, D) f32 operand, row-major [row][D], each row
// times row_scale[row] when given
__device__ __forceinline__ void stage_rows(float* dst, const float* src, int n0, int N,
                                           long long sn, long long sd,
                                           const float* row_scale = nullptr) {
  for (int i = threadIdx.x; i < BQ * D; i += F32_THREADS) {
    const int r = i / D, d = i % D;
    const int n = n0 + r;
    const float v = n < N ? src[n * sn + d * sd] : 0.f;
    dst[r * D + d] = row_scale ? v * row_scale[r] : v;
  }
}

// acc[i][j] = Σ_k a[k][ty·4 + i] · b[k][tx·4 + j] for two k-major [D][LDT]
// tiles
__device__ __forceinline__ void f32_tn(float acc[4][4], const float* a, const float* b, int tx,
                                       int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int k = 0; k < D; ++k) {
    const float4 av = *reinterpret_cast<const float4*>(&a[k * LDT + ty * 4]);
    const float4 bv = *reinterpret_cast<const float4*>(&b[k * LDT + tx * 4]);
    const float ar[4] = {av.x, av.y, av.z, av.w};
    const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
  }
}

// acc[i][j] += Σ_k p[k][ty·4 + i] · v[k][tx·4 + j], p k-major [k][LDT] and v
// row-major [k][D]
__device__ __forceinline__ void f32_acc(float acc[4][4], const float* p, const float* v, int tx,
                                        int ty) {
#pragma unroll 4
  for (int k = 0; k < BK; ++k) {
    const float4 pv = *reinterpret_cast<const float4*>(&p[k * LDT + ty * 4]);
    const float4 vv = *reinterpret_cast<const float4*>(&v[k * D + tx * 4]);
    const float pr[4] = {pv.x, pv.y, pv.z, pv.w};
    const float vr[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pr[i], vr[j], acc[i][j]);
  }
}

}  // namespace
