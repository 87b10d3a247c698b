// Backward of the fused QKV projection + self-attention (K8), for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cross_attention_vit_tpu/kernels/flash_attention.py
// ::_fused_qkv_bwd_kernel (defined at :879, launched by pallas_call at :943 in
// _fused_qkv_bwd), the backward rule of fused_qkv_attention when
// FUSED_QKV_GRADS is on (bf16, N ≤ 1040).  For x (B, N, H), the projection
// weight W (H, 3, K, D), the saved qkv and output and the output's cotangent:
//
//     dq, dk, dv = K2's _tn_bwd_math with the saved o, rounded to bf16 (dsb)
//     dx[b]      = Σ_h dqkv_h · W_hᵀ      f32 accumulation, cast once to x's dtype
//     dW_h       = Σ_b x[b]ᵀ · dqkv_h     f32 accumulation, written f32
//
// Four kernels launched back to back on the caller's stream:
//
//   1, 2  the dq and dk/dv kernels of attention_bwd.cuh (K2's, instantiated
//         here), which write dqkv as a contiguous (B, N, 3, K, D) bf16
//         scratch — the (B·N, 3·K·D) matrix the contractions read;
//   3     dx = dqkv · Wᵀ, a (B·N) × H × 3KD product;
//   4     dW = xᵀ · dqkv, an H × 3KD × (B·N) product.
//
// The contractions are the hand-written tile product below, never cuBLAS.
// Each 128 × 128 output tile belongs to one block, which runs the whole
// reduction itself in a fixed order: there are no atomics, and two identical
// calls give identical bits (the TPU kernel accumulated dx over the serial
// head axis and dW over the serial batch axis in VMEM scratch; on Hopper the
// blocks run in parallel, so the sums become whole-reduction products).
//
// Distance from the TPU design.  There dqkv never reached HBM: each (b, h)
// program contracted its dq/dk/dv in VMEM at once.  Here dqkv is written
// once (25.2 MB at the live shape) and read twice, by the two products.
//
// Bound.  JAX's own count (:960), 2·B·K·N·(5·N·D + 6·D·H) FLOPs = 73.2 GFLOP
// at the live shape (B=8, N=513, K=16, D=64, H=1024): 74 us at 989 TFLOP/s.
// The bytes (qkv, o, do, x and W read once, dx bf16 and dW f32 written once,
// about 78 MB) take 23 us at 3.35 TB/s, so operations bound it.
//
// The product kernel: 256 threads (8 warps, 2 × 4, each 64 × 32 of the
// tile), mma.sync m16n8k16 bf16 → f32, 32-deep k tiles staged through
// registers into shared memory ([row][k], padded), the next tile's loads in
// flight during this tile's products.  An operand contiguous along k moves
// as 16-byte chunks stored as they are; one contiguous along its rows (x and
// dqkv in dW, the transposed Linear weight in dx) as 16-byte chunks of 8 rows
// stored transposed.
//
// Not yet done (later work): wgmma, TMA, a deeper pipeline, and keeping dqkv
// out of HBM.

#include "attention_bwd.cuh"

namespace {

constexpr int GM = 128, GN = 128, GK = 32;   // output tile and reduction step
constexpr int GTHREADS = 256;
constexpr int LDK = GK + 8;                  // [row][k] staging, padded

// A 128-row × 32-k tile of a bf16 operand whose element (r, k) lives at
// p[r·sr + k·sk]: two 16-byte chunks per thread.  kKContig: sk = 1, chunks
// run along k; else sr = 1, chunks run along the rows.  Out-of-range chunks
// load as zeros (rows ≥ R; k ≥ Kd), which needs Kd % 8 == 0 (kKContig) or
// R % 8 == 0 (else).
template <bool kKContig>
struct GTile {
  uint4 v[2];

  __device__ __forceinline__ void load(const bf16* p, int r0, int R, int k0, int Kd,
                                       long long sr, long long sk) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = threadIdx.x + i * GTHREADS;
      int r, k;
      if constexpr (kKContig) {
        r = r0 + c / (GK / 8);
        k = k0 + (c % (GK / 8)) * 8;
      } else {
        r = r0 + (c / GK) * 8;
        k = k0 + c % GK;
      }
      v[i] = r < R && k < Kd ? *reinterpret_cast<const uint4*>(p + r * sr + k * sk)
                             : make_uint4(0, 0, 0, 0);
    }
  }

  __device__ __forceinline__ void store(bf16* s) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = threadIdx.x + i * GTHREADS;
      if constexpr (kKContig) {
        *reinterpret_cast<uint4*>(s + (c / (GK / 8)) * LDK + (c % (GK / 8)) * 8) = v[i];
      } else {
        const bf16* e = reinterpret_cast<const bf16*>(&v[i]);
#pragma unroll
        for (int j = 0; j < 8; ++j) s[((c / GK) * 8 + j) * LDK + c % GK] = e[j];
      }
    }
  }
};

__device__ __forceinline__ void put(bf16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }

// C[m][n] = Σ_k A[m][k]·B[n][k] over k < Kd, f32 accumulation, one block per
// 128 × 128 tile of C.  A (m, k) at a[m·sam + k·sak], B (n, k) at
// b[n·sbn + k·sbk], C (m, n) at c[m·scm + n·scn].
template <bool kAK, bool kBK, typename OutT>
__global__ void __launch_bounds__(GTHREADS)
gemm_nt_kernel(const bf16* __restrict__ a, const bf16* __restrict__ b, OutT* __restrict__ c,
               int M, int Nc, int Kd, long long sam, long long sak, long long sbn,
               long long sbk, long long scm, long long scn) {
  __shared__ __align__(16) bf16 as[GM * LDK];
  __shared__ __align__(16) bf16 bs[GN * LDK];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;     // this warp's 64 × 32 of the tile
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * GN;

  float acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x) acc[mi][ni][x] = 0.f;

  GTile<kAK> ta;
  GTile<kBK> tb;
  ta.load(a, m0, M, 0, Kd, sam, sak);
  tb.load(b, n0, Nc, 0, Kd, sbn, sbk);
  const int steps = (Kd + GK - 1) / GK;
  for (int step = 0; step < steps; ++step) {
    __syncthreads();
    ta.store(as);
    tb.store(bs);
    __syncthreads();
    if (step + 1 < steps) {                    // in flight during the products
      ta.load(a, m0, M, (step + 1) * GK, Kd, sam, sak);
      tb.load(b, n0, Nc, (step + 1) * GK, Kd, sbn, sbk);
    }
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk) {
      uint32_t af[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const bf16* p = as + (wm * 64 + mi * 16 + g) * LDK + kk * 16 + 2 * t;
        af[mi][0] = ld_pair(p);
        af[mi][1] = ld_pair(p + 8 * LDK);
        af[mi][2] = ld_pair(p + 8);
        af[mi][3] = ld_pair(p + 8 * LDK + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const bf16* p = bs + (wn * 32 + ni * 8 + g) * LDK + kk * 16 + 2 * t;
        const uint32_t b0 = ld_pair(p), b1 = ld_pair(p + 8);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][ni], af[mi], b0, b1);
      }
    }
  }

#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int m = m0 + wm * 64 + mi * 16 + g + (x >> 1) * 8;
        const int n = n0 + wn * 32 + ni * 8 + 2 * t + (x & 1);
        if (m < M && n < Nc) put(c + m * scm + n * scn, acc[mi][ni][x]);
      }
}

template <bool kAK, bool kBK, typename OutT>
cudaError_t launch_gemm(const bf16* a, const bf16* b, OutT* c, int M, int Nc, int Kd,
                        long long sam, long long sak, long long sbn, long long sbk,
                        long long scm, long long scn, cudaStream_t stream) {
  const dim3 grid((Nc + GN - 1) / GN, (M + GM - 1) / GM);
  gemm_nt_kernel<kAK, kBK, OutT><<<grid, GTHREADS, 0, stream>>>(a, b, c, M, Nc, Kd, sam, sak,
                                                                 sbn, sbk, scm, scn);
  return cudaGetLastError();
}

}  // namespace

// Kernels 1 and 2: K2's dq and dk/dv kernels (bf16) writing the contiguous
// (B, N, 3, K, D) dqkv scratch, from qkv (B, N, 3, K, D) and the saved output
// and its cotangent (B, N, K, D), strides in elements (unit head-dim stride,
// 16-byte rows); stats is K1's (2, B, K, N) f32 row statistics and delta a
// (B, K, N) f32 scratch.  Run dq first.
#define FUSED_ATTN_PARAMS                                                                      \
  const void *qkv, const void *o, const void *dout, void *dqkv, const void *stats,             \
      void *delta, int B, int N, int K, int head_dim, long long sb, long long sn, long long ss, \
      long long sh, long long sd, long long ob, long long on, long long oh, long long od,      \
      long long gb, long long gn, long long gh, long long gd, float scale, void *stream,       \
      int device

namespace {

BwdCall fused_attn_call(FUSED_ATTN_PARAMS) {
  const bf16* q = static_cast<const bf16*>(qkv);
  bf16* dq = static_cast<bf16*>(dqkv);
  const long long slab = static_cast<long long>(K) * D;
  (void)head_dim;
  (void)device;
  return BwdCall{q, q + ss, q + 2 * ss, o, dout, dq, dq + slab, dq + 2 * slab,
                 static_cast<const float*>(stats), static_cast<float*>(delta), B, N, K,
                 stacked_views(N, K, sb, sn, sh, sd, ob, on, oh, od, gb, gn, gh, gd), scale,
                 static_cast<cudaStream_t>(stream)};
}

}  // namespace

#define FUSED_ATTN_ARGS                                                                        \
  qkv, o, dout, dqkv, stats, delta, B, N, K, head_dim, sb, sn, ss, sh, sd, ob, on, oh, od, gb, \
      gn, gh, gd, scale, stream, device

extern "C" int fused_qkv_bwd_dq(FUSED_ATTN_PARAMS) {
  if (head_dim != D) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_bwd_dq<bf16>(fused_attn_call(FUSED_ATTN_ARGS), WG_THREADS, BF16_DQ_SMEM,
                             attn_bwd_dq_bf16_kernel<false>);
}

extern "C" int fused_qkv_bwd_dkdv(FUSED_ATTN_PARAMS) {
  if (head_dim != D) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_bwd_dkdv<bf16>(fused_attn_call(FUSED_ATTN_ARGS), WG_THREADS, BF16_DKDV_SMEM,
                               attn_bwd_dkdv_bf16_kernel);
}

// Kernel 3: dx (M, H) bf16 = dqkv (M, J) · Wᵀ, with M = B·N and J = 3·K·D;
// dqkv is contiguous, W (H, J) has strides (swh, swj) of which one is 1,
// dx is contiguous.  J and H must be multiples of 8.
extern "C" int fused_qkv_bwd_dx(const void* dqkv, const void* w, void* dx, int M, int H, int J,
                                long long swh, long long swj, void* stream, int device) {
  if (J % 8 || H % 8 || (swh != 1 && swj != 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bf16* a = static_cast<const bf16*>(dqkv);
  const bf16* b = static_cast<const bf16*>(w);
  bf16* c = static_cast<bf16*>(dx);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (swj == 1)
    return launch_gemm<true, true, bf16>(a, b, c, M, H, J, J, 1, swh, 1, H, 1, s);
  return launch_gemm<true, false, bf16>(a, b, c, M, H, J, J, 1, 1, swj, H, 1, s);
}

// Kernel 4: dW (H, J) f32 = xᵀ · dqkv, x (M, H) with row stride sx and unit
// column stride, dqkv (M, J) contiguous, dW contiguous.  H and J must be
// multiples of 8.
extern "C" int fused_qkv_bwd_dw(const void* x, const void* dqkv, void* dw, int M, int H, int J,
                                long long sx, void* stream, int device) {
  if (J % 8 || H % 8) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_gemm<false, false, float>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dqkv), static_cast<float*>(dw), H,
      J, M, 1, sx, 1, J, J, 1, static_cast<cudaStream_t>(stream));
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
