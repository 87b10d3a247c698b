// Shared pieces of the attention kernels: the tile sizes, the (B, K, N, D)
// operand views, bf16 packing, and the f32 staging and register-tile
// products of the CUDA-core path (K1, K2, K5, K6, K7).  The bf16 kernels run
// wgmma: hopper_tiles.cuh.

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
constexpr float LOG2E = 1.4426950408889634f;   // exp(x) = exp2(x·log2 e)

// Strides, in elements, of a (B, K, N, D) operand view.
struct View {
  long long b, h, n, d;
};

// the (b, h) slice of an operand view
template <typename P>
__device__ __forceinline__ P base(P p, const View& st, int b, int h) {
  return p + b * st.b + h * st.h;
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
