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
// The contractions are the hand-written wgmma products below, never cuBLAS.
// Each output tile belongs to one block, which runs the whole reduction
// itself in a fixed order: there are no atomics, and two identical calls
// give identical bits (the TPU kernel accumulated dx over the serial head
// axis and dW over the serial batch axis in VMEM scratch; on Hopper the
// blocks run in parallel, so the sums become whole-reduction products).
//
// Distance from the TPU design.  There dqkv never reached HBM: each (b, h)
// program contracted its dq/dk/dv in VMEM at once.  Here dqkv is written
// once (25.2 MB at the live shape) and read twice, by the two products.
//
// Bound.  JAX's own count (:960), 2·B·K·N·(5·N·D + 6·D·H) FLOPs = 73.2 GFLOP
// at the live shape (B=8, N=513, K=16, D=64, H=1024): 74 us at 989 TFLOP/s.
// The bytes (qkv, o, do, x and W read once, dx bf16 and dW f32 written once,
// about 78 MB) take 23 us at 3.35 TB/s, so operations bound it.  The two
// products are 25.8 GFLOP each (M = B·N = 4104, H = 1024, J = 3·K·D =
// 3072): 26 us each at the peak.
//
// The products (kernels 3 and 4).  C = A·Bᵀ, one block per 128 × BN tile
// of C: two warpgroups, each owning 64 rows, run m64nBNk16 wgmma with both
// operands in shared memory and the sum in registers (BN / 2 f32 a thread).
// The operands move by cp.async, 16 bytes a copy, in 64 × 64 tiles in the
// 128-byte swizzle (hopper_tiles.cuh), 64 deep a ring step, into a ring of
// gemm_stages(BN) slots, S − 2 steps ahead of the products; one barrier a
// step, and one step's products stay in flight across it (wgmma wait_group
// 1), so a slot is refilled only once the products two steps back have read
// it.  Every operand is staged as it lies in memory, whichever of its
// dimensions is contiguous, and wgmma reads it K-major or transposed
// (MN-major) through its descriptor: dqkv is K-major in dx (A) and
// transposed in dW (B); x is transposed in dW (A); W is K-major in dx when
// contiguous (swj == 1) and transposed when it is the model's view of the
// Linear weight (swh == 1).  A wide block tile is the answer to L2: a
// 128 × BN tile reads (128 + BN)·64·2 bytes a step for 2·128·BN·64 FLOPs,
// 85 FLOP/byte at BN = 256.  dx (4104 × 1024) runs BN = DX_TILE_N and dW
// (1024 × 3072) BN = DW_TILE_N, for whole waves on 132 SMs (dx 33 × 4 = 132
// tiles, dW 8 × 16 = 128).
//
// Rounding.  wgmma's f32 sum does not round to nearest, and its error grows
// with the steps summed into one accumulator: cuBLAS's bf16 GEMM, summed the
// same way, is about 1e-5 (normalised) from an f32 product of the same
// operands in dW at M = 8200 on an H100 (chip_smoke.py, phase kernels_k8).
// So dW, whose reduction is the long one (B·N), sums DW_PROMOTE ring steps
// (1024 rows) at a time in wgmma and adds these partials with f32 adds;
// dx's reduction is 3072 deep and its result is rounded to bf16, so it sums
// in wgmma alone.  Tails: rows and columns past an operand's ends and the
// reduction's last partial step are zero-filled without a read (M = 4104 =
// 64·64 + 8: dx's last row tile holds 8 rows, dW's last step 8), and no
// store leaves C.  dx is rounded once to bf16, dW written in f32.
//
// Not yet done (later work): keeping dqkv out of HBM (the TPU design), TMA
// with a producer warp, and a persistent block that overlaps one tile's
// stores with the next tile's loads.

#include "attention_bwd.cuh"

namespace {

constexpr int GM = 128;                       // rows of C a block: 2 warpgroups × 64
constexpr int GK = 64;                        // reduction per ring step
constexpr int GTHREADS = 2 * WG_THREADS;
constexpr int DX_TILE_N = 256;                // columns of C a block, dx and dW
constexpr int DW_TILE_N = 192;
constexpr int DX_PROMOTE = 0;                 // ring steps a wgmma sum spans (0: all)
constexpr int DW_PROMOTE = 16;

// Ring slots for a BN-wide tile: as many (128 + BN) × 64 stages as fit in
// the 227 KB a block may use (4 at BN = 256, 5 at 192).
__host__ __device__ constexpr int gemm_stages(int bn) {
  return (227 * 1024 - SMEM_ALIGN) / ((GM + bn) * GK * 2);
}
constexpr size_t gemm_smem(int bn) {
  return SMEM_ALIGN + static_cast<size_t>(gemm_stages(bn)) * (GM + bn) * GK * sizeof(bf16);
}

// One operand of C = A·Bᵀ: its element (i, k) — i a row of C for A, a
// column of C for B; k the reduction — at p[i·ld + k] (K-major) or
// p[k·ld + i] (MN-major).
struct Operand {
  const bf16* p;
  long long ld;
};

__device__ __forceinline__ void put2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void put2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

// C (M × Nc, row stride Nc) = A·Bᵀ over Kd, f32 accumulation; kTA / kTB:
// A / B is MN-major.  Nc and each operand's contiguous extent must be
// multiples of 8.  kPromote > 0: wgmma sums kPromote ring steps at a time
// into registers of their own, each partial then added to the block's sum
// by f32 adds that round to nearest (wgmma's own f32 sum does not: its
// error grows with the number of steps summed into one accumulator).
template <bool kTA, bool kTB, int BN, int kPromote, typename OutT>
__device__ __forceinline__ void gemm_body(Operand a, Operand b, OutT* __restrict__ c, int M,
                                          int Nc, int Kd) {
  constexpr int UNITS = 2 + BN / 64;           // 64 × 64 tiles a step: A's two, then B's
  constexpr int S = gemm_stages(BN);
  extern __shared__ float4 smem4[];
  bf16* ring = aligned_smem(smem4);
  const int wg = threadIdx.x / WG_THREADS;
  const int m0 = blockIdx.y * GM, n0 = blockIdx.x * BN;
  const int steps = (Kd + GK - 1) / GK;

  // step i's tiles, each a 64 × 64 block of an operand with rows and
  // columns as it lies in memory (K-major: rows i, columns k; MN-major:
  // rows k, columns i)
  auto issue = [&](int i) {
    bf16* stage = ring + (i % S) * UNITS * TILE;
    const int k0 = i * GK;
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const bool is_a = u < 2;
      const Operand op = is_a ? a : b;
      const int i0 = is_a ? m0 + 64 * u : n0 + 64 * (u - 2), extent = is_a ? M : Nc;
      if (is_a ? kTA : kTB)
        load_block_async<GTHREADS>(stage + u * TILE, op.p, op.ld, k0, Kd, i0, extent,
                                   threadIdx.x);
      else
        load_block_async<GTHREADS>(stage + u * TILE, op.p, op.ld, i0, extent, k0, Kd,
                                   threadIdx.x);
    }
  };

  float d[BN / 2], sum[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) d[i] = sum[i] = 0.f;
#pragma unroll
  for (int i = 0; i < S - 2; ++i) {
    if (i < steps) issue(i);
    cp_async_commit();
  }
  for (int i = 0; i < steps; ++i) {
    // step i's copies have landed (S − 3 later groups may be pending); the
    // barrier also tells that every thread's products of step i − 2 are done
    // (wait_group 1 below), so their slot takes step i + S − 2
    asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 3) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (i + S - 2 < steps) issue(i + S - 2);
    cp_async_commit();
    const bf16* stage = ring + (i % S) * UNITS * TILE;
    // A: this warpgroup's 64-row tile; B: BN / 64 tiles, which an MN-major
    // B reads 8 KB apart (its leading offset)
    const uint64_t da = desc(stage + wg * TILE);
    const uint64_t db = desc(stage + 2 * TILE, kTB ? TILE * sizeof(bf16) : 1024);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < GK / 16; ++kk)
      wgmma_wide<BN, kTA, kTB>(d, da + (kTA ? 128 : 2) * kk, db + (kTB ? 128 : 2) * kk);
    wg_commit();
    if constexpr (kPromote > 0) {
      if ((i + 1) % kPromote == 0 || i + 1 == steps) {
        wg_wait<0>();
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          asm volatile("" : "+f"(d[j])::"memory");
          sum[j] += d[j];
          d[j] = 0.f;
        }
        continue;
      }
    }
    wg_wait<1>();
  }
  wg_wait<0>();
  if constexpr (kPromote == 0) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      asm volatile("" : "+f"(d[i])::"memory");
      sum[i] = d[i];
    }
  }

  // d[4j + x]: row 16·warp + lane / 4 + 8·(x / 2) of this warpgroup's 64,
  // column 8j + 2·(lane % 4) + x % 2
  const int lane = threadIdx.x & 31;
  const int row = m0 + 64 * wg + 16 * ((threadIdx.x % WG_THREADS) >> 5) + (lane >> 2);
  const int col = n0 + 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = row + 8 * half, n = col + 8 * j;
      if (m < M && n < Nc)
        put2(c + static_cast<long long>(m) * Nc + n, sum[4 * j + 2 * half],
             sum[4 * j + 2 * half + 1]);
    }
}

// dx and dW under names of their own, so that a profile books them apart.
template <bool kTB>
__global__ void __launch_bounds__(GTHREADS, 1)
qkv_grad_dx_kernel(Operand a, Operand b, bf16* c, int M, int Nc, int Kd) {
  gemm_body<false, kTB, DX_TILE_N, DX_PROMOTE, bf16>(a, b, c, M, Nc, Kd);
}
__global__ void __launch_bounds__(GTHREADS, 1)
qkv_grad_dw_kernel(Operand a, Operand b, float* c, int M, int Nc, int Kd) {
  gemm_body<true, true, DW_TILE_N, DW_PROMOTE, float>(a, b, c, M, Nc, Kd);
}

template <typename OutT>
cudaError_t launch_gemm(void (*kernel)(Operand, Operand, OutT*, int, int, int), int bn,
                        Operand a, Operand b, OutT* c, int M, int Nc, int Kd, void* stream) {
  const size_t smem = gemm_smem(bn);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((Nc + bn - 1) / bn, (M + GM - 1) / GM);
  kernel<<<grid, GTHREADS, smem, static_cast<cudaStream_t>(stream)>>>(a, b, c, M, Nc, Kd);
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
// dqkv is contiguous, W (H, J) has strides (swh, swj) of which one is 1 and
// the other a multiple of 8, dx is contiguous.  J and H must be multiples of
// 8; every pointer 16-byte aligned.
extern "C" int fused_qkv_bwd_dx(const void* dqkv, const void* w, void* dx, int M, int H, int J,
                                long long swh, long long swj, void* stream, int device) {
  if (J % 8 || H % 8 || (swh != 1 && swj != 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Operand a{static_cast<const bf16*>(dqkv), J};
  bf16* c = static_cast<bf16*>(dx);
  if (swj == 1)   // W contiguous along J: K-major
    return launch_gemm<bf16>(qkv_grad_dx_kernel<false>, DX_TILE_N, a,
                             Operand{static_cast<const bf16*>(w), swh}, c, M, H, J, stream);
  return launch_gemm<bf16>(qkv_grad_dx_kernel<true>, DX_TILE_N, a,
                           Operand{static_cast<const bf16*>(w), swj}, c, M, H, J, stream);
}

// Kernel 4: dW (H, J) f32 = xᵀ · dqkv, x (M, H) with row stride sx (a
// multiple of 8) and unit column stride, dqkv (M, J) contiguous, dW
// contiguous.  H and J must be multiples of 8; every pointer 16-byte
// aligned.
extern "C" int fused_qkv_bwd_dw(const void* x, const void* dqkv, void* dw, int M, int H, int J,
                                long long sx, void* stream, int device) {
  if (J % 8 || H % 8) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_gemm<float>(qkv_grad_dw_kernel, DW_TILE_N,
                            Operand{static_cast<const bf16*>(x), sx},
                            Operand{static_cast<const bf16*>(dqkv), J}, static_cast<float*>(dw),
                            H, J, M, stream);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
