// Backward of the fused self-attention on one stacked qkv operand, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cross_attention_vit_tpu/kernels/flash_attention.py
// ::_attn_bwd_kernel_qkv_tn (defined at :768, launched by pallas_call at :835
// in _qkv_tn_bwd).  It computes that kernel's function (_tn_bwd_math with the
// saved output o, :628-692) for every (batch b, head h):
//
//     s     = q·kᵀ · scale;  m = rowmax(s);  e = exp(s − m);  r = 1 / Σ_j e
//     delta = rowsum(do ⊙ o)                        f32, from the saved o
//     dv    = (do·r cast to the operand dtype)ᵀ · (e cast to the operand dtype)
//     dp    = do·vᵀ
//     ds    = e · ((dp − delta) · (r · scale))      cast to the operand dtype
//     dq    = ds·k;   dk = dsᵀ·q                    f32 accumulation everywhere
//
// and writes dq, dk, dv as one stacked dqkv.  Head dim D = 64, as in K1.
//
// Layout.  qkv is read as (B, N, 3, K, D) and o, do as (B, N, K, D), all
// through strides (in elements); dqkv is written contiguous (B, N, 3, K, D),
// the layout of the QKV projection's output, so the dx and dW GEMMs that
// follow read it as a (B·N, 3H) matrix.
//
// Bound.  At the training path's shape (B=8, K=16, D=64, N=513, bf16) one
// call must read qkv, o and do and write dqkv: 8·B·N·K·D·2 B = 67.2 MB, 20.1 us
// at 3.35 TB/s.  Its five products (s recomputed, dv, dp, dq, dk) are
// 10·B·K·N²·D = 21.6 GFLOP, 21.8 us at the 989 TFLOP/s bf16 tensor-core peak.
// So the bound is about 22 us (operations).
//
// Design.  The 513×513 f32 score and gradient planes do not fit in shared
// memory, so the TPU's one-block-per-(b, h) program is split FlashAttention-2
// style into two kernels launched back to back on the caller's stream:
//
//   dq kernel:   one block per 64-row query tile.  Pass 1 over the key tiles
//                finds each row's max and sum (as K1 does) and the block
//                writes the row statistics (m, r, delta) to a (3, B, K, N) f32
//                scratch.  Pass 2 recomputes s and dp tile by tile, forms ds
//                in registers and accumulates dq = ds·k.
//   dk/dv kernel: one block per 64-key tile loops over the query tiles, reads
//                the row statistics, recomputes sᵀ and dpᵀ and accumulates
//                dv = ebᵀ·do_r and dk = dsᵀ·q.
//
// Every block owns its outputs, so nothing is accumulated across blocks and
// no atomics are needed.  The ragged last tile (513 = 8·64 + 1) is masked: in
// the dq kernel key columns ≥ N score −inf; in the dk/dv kernel query rows
// ≥ N get a row max of +inf, so their e, and with it their ds, is 0.  Rows ≥ N
// of every operand are staged as zeros and nothing outside [0, N) is stored.
//
//   bf16 (the training path): 4 warps, each owning 16 rows of the block's
//   tile, run all five products on the tensor cores with mma.sync m16n8k16
//   (bf16 in, f32 accumulate).  The score-shaped accumulators are re-packed
//   in registers as the A operand of the next product (e for dv, ds for dq
//   and dk), so no N×N plane touches shared memory.  Tiles move in 16-byte
//   chunks.  Needs a unit head-dim stride and 16-byte aligned rows (the
//   wrapper checks).  As in K1, exp(scale·(s − m)) is one FMA and an exp2.
//   f32: scalar f32 FMAs on the CUDA cores (256 threads, 4×4 register
//   tiles), element-wise staging, any strides; full f32, no TF32.
//
// Not yet done (later work): prefetching the next tile during the products
// (K1 does), wgmma and TMA, and K1 writing the row statistics so that the dq
// kernel's first pass goes.

#include "attention_tiles.cuh"

namespace {

struct Strides {
  long long b, n, s, h, d;      // qkv (B, N, 3, K, D)
  long long ob, on, oh, od;     // o   (B, N, K, D)
  long long gb, gn, gh, gd;     // do  (B, N, K, D)
};

// Row statistics scratch (3, B, K, N) f32: [0] the row max (bf16: of the
// unscaled scores times scale·log2 e; f32: of the scaled scores), [1] r,
// [2] delta.
__device__ __forceinline__ float* stat(float* stats, int which, int B, int K, int N, int b,
                                       int h) {
  return stats + ((static_cast<long long>(which) * B + b) * K + h) * N;
}

// dqkv (B, N, 3, K, D), contiguous: row n of slab s (0 = q, 1 = k, 2 = v)
template <typename T>
__device__ __forceinline__ T* drow(T* dqkv, int N, int K, int b, int n, int s, int h) {
  return dqkv + (((static_cast<long long>(b) * N + n) * 3 + s) * K + h) * D;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

// Writes this warp's 16 rows × D of f32 accumulators as bf16 rows of slab s.
__device__ __forceinline__ void store_rows_bf16(bf16* dqkv, const float acc[D / 8][4], int N,
                                                int K, int b, int n_first, int s, int h,
                                                int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = n_first + 8 * half;
    if (n >= N) continue;
    bf16* row = drow(dqkv, N, K, b, n, s, h);
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

__global__ void __launch_bounds__(MMA_THREADS)
attn_bwd_dq_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                        float* __restrict__ stats, int B, int N, int K, Strides st,
                        float scale) {
  extern __shared__ float4 smem4[];
  bf16* rs = reinterpret_cast<bf16*>(smem4);   // [BQ][LD]  q, then do (fragments)
  bf16* ks = rs + BQ * LD;                     // [BK][LD]  k tile
  bf16* vs = ks + BK * LD;                     // [BK][LD]  v tile
  bf16* kt = vs + BK * LD;                     // [D][LDV]  k tile, transposed

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = qkv + b * st.b + h * st.h;
  const bf16* kb = qb + st.s;
  const bf16* vb = qb + 2 * st.s;
  const bf16* ob = o + b * st.ob + h * st.oh;
  const bf16* gb = dout + b * st.gb + h * st.gh;
  const int tiles = (N + BK - 1) / BK;
  const float c = scale * LOG2E;   // exp(scale·x) = exp2(c·x)
  const int r0 = warp * 16 + g;

  Tile tl, tv;
  uint32_t qf[D / 16][4], df[D / 16][4];
  tl.load_rows(qb, q0, N, st.n);
  tl.store_rows(rs, LD);
  __syncthreads();
  load_a(qf, rs, r0, t);
  __syncthreads();
  tl.load_rows(gb, q0, N, st.gn);
  tl.store_rows(rs, LD);
  __syncthreads();
  load_a(df, rs, r0, t);

  // pass 1: row max and sum (online); a quad of threads shares a row
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    tl.load_rows(kb, k0, N, st.n);
    __syncthreads();
    tl.store_rows(ks, LD);
    __syncthreads();
    float s[BK / 8][4];
    mma_nt(s, qf, ks, g, t);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + j * 8 + 2 * t + e < N) mx = fmaxf(mx, s[j][2 * half + e]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[half], mx);      // finite: key k0 < N is valid
      const float cm = c * mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + j * 8 + 2 * t + e < N) sum += exp2f(fmaf(s[j][2 * half + e], c, -cm));
      l[half] = l[half] * exp2f(fmaf(m[half], c, -cm)) + sum;
      m[half] = mn;
    }
  }

  // row statistics: cm = c·m, r = 1/Σe, delta = Σ_d do·o (thread t sums
  // d in [16t, 16t + 16), then the quad adds)
  float cm[2], rr[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    cm[half] = c * m[half];
    rr[half] = 1.f / l[half];
    const int n = q0 + r0 + 8 * half;
    float dd = 0.f;
    if (n < N) {
#pragma unroll
      for (int part = 0; part < 2; ++part) {
        const uint4 gv = *reinterpret_cast<const uint4*>(gb + n * st.gn + 16 * t + 8 * part);
        const uint4 ov = *reinterpret_cast<const uint4*>(ob + n * st.on + 16 * t + 8 * part);
        const bf16* ge = reinterpret_cast<const bf16*>(&gv);
        const bf16* oe = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
        for (int j = 0; j < 8; ++j) dd = fmaf(__bfloat162float(ge[j]), __bfloat162float(oe[j]), dd);
      }
    }
    dd += __shfl_xor_sync(0xffffffffu, dd, 1);
    dd += __shfl_xor_sync(0xffffffffu, dd, 2);
    delta[half] = dd;
    if (t == 0 && n < N) {
      stat(stats, 0, B, K, N, b, h)[n] = cm[half];
      stat(stats, 1, B, K, N, b, h)[n] = rr[half];
      stat(stats, 2, B, K, N, b, h)[n] = dd;
    }
  }

  // pass 2: ds = e·((dp − delta)·(r·scale)) in registers, dq += ds·k
  float dq[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;
  const float rsc[2] = {rr[0] * scale, rr[1] * scale};
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    tl.load_rows(kb, k0, N, st.n);
    tl.store_rows(ks, LD);
    tv.load_rows(vb, k0, N, st.n);
    tv.store_rows(vs, LD);
    tl.load_cols(kb, k0, N, st.n);
    tl.store_transposed(kt, LDV);
    __syncthreads();
    float s[BK / 8][4], dp[BK / 8][4];
    mma_nt(s, qf, ks, g, t);
    mma_nt(dp, df, vs, g, t);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const bool valid = k0 + j * 8 + 2 * t + (e & 1) < N;
        const float ex = valid ? exp2f(fmaf(s[j][e], c, -cm[half])) : 0.f;
        s[j][e] = ex * ((dp[j][e] - delta[half]) * rsc[half]);     // ds
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_acc(dq, a, kt, kk, g, t);
    }
  }
  store_rows_bf16(dqkv, dq, N, K, b, q0 + r0, 0, h, t);
}

__global__ void __launch_bounds__(MMA_THREADS)
attn_bwd_dkdv_bf16_kernel(const bf16* __restrict__ qkv, const bf16* __restrict__ dout,
                          bf16* __restrict__ dqkv, const float* __restrict__ stats, int B,
                          int N, int K, Strides st, float scale) {
  extern __shared__ float4 smem4[];
  bf16* rs = reinterpret_cast<bf16*>(smem4);   // [BK][LD]  k, then v (fragments)
  bf16* qs = rs + BK * LD;                     // [BQ][LD]  q tile
  bf16* gs = qs + BQ * LD;                     // [BQ][LD]  do tile
  bf16* qt = gs + BQ * LD;                     // [D][LDV]  q tile, transposed
  bf16* gt = qt + D * LDV;                     // [D][LDV]  do·r, transposed
  __shared__ float s_cm[BQ], s_r[BQ], s_rs[BQ], s_delta[BQ];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = qkv + b * st.b + h * st.h;
  const bf16* kb = qb + st.s;
  const bf16* vb = qb + 2 * st.s;
  const bf16* gb = dout + b * st.gb + h * st.gh;
  const int tiles = (N + BQ - 1) / BQ;
  const float c = scale * LOG2E;
  const int r0 = warp * 16 + g;
  const float* st_cm = stat(const_cast<float*>(stats), 0, B, K, N, b, h);
  const float* st_r = stat(const_cast<float*>(stats), 1, B, K, N, b, h);
  const float* st_delta = stat(const_cast<float*>(stats), 2, B, K, N, b, h);

  Tile tl;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  tl.load_rows(kb, k0, N, st.n);
  tl.store_rows(rs, LD);
  __syncthreads();
  load_a(kf, rs, r0, t);
  __syncthreads();
  tl.load_rows(vb, k0, N, st.n);
  tl.store_rows(rs, LD);
  __syncthreads();
  load_a(vf, rs, r0, t);

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    const int q0 = tile * BQ;
    __syncthreads();
    if (threadIdx.x < BQ) {
      // query rows ≥ N: a row max of +inf makes e = exp2(c·s − inf) = 0
      const int n = q0 + threadIdx.x;
      const bool valid = n < N;
      s_cm[threadIdx.x] = valid ? st_cm[n] : INFINITY;
      s_r[threadIdx.x] = valid ? st_r[n] : 0.f;
      s_rs[threadIdx.x] = valid ? st_r[n] * scale : 0.f;
      s_delta[threadIdx.x] = valid ? st_delta[n] : 0.f;
    }
    tl.load_rows(qb, q0, N, st.n);
    tl.store_rows(qs, LD);
    tl.load_rows(gb, q0, N, st.gn);
    tl.store_rows(gs, LD);
    tl.load_cols(qb, q0, N, st.n);
    tl.store_transposed(qt, LDV);
    tl.load_cols(gb, q0, N, st.gn);
    __syncthreads();                           // s_r is read below
    tl.store_transposed_scaled(gt, LDV, s_r);
    __syncthreads();

    float s[BQ / 8][4], dp[BQ / 8][4];
    mma_nt(s, kf, qs, g, t);                   // sᵀ: rows keys, columns queries
    mma_nt(dp, vf, gs, g, t);                  // dpᵀ
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      float e[2][4], ds[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int j = 2 * kk + jj;
          const int q = j * 8 + 2 * t + (x & 1);
          e[jj][x] = exp2f(fmaf(s[j][x], c, -s_cm[q]));
          ds[jj][x] = e[jj][x] * ((dp[j][x] - s_delta[q]) * s_rs[q]);
        }
      const uint32_t ae[4] = {pack(e[0][0], e[0][1]), pack(e[0][2], e[0][3]),
                              pack(e[1][0], e[1][1]), pack(e[1][2], e[1][3])};
      const uint32_t ad[4] = {pack(ds[0][0], ds[0][1]), pack(ds[0][2], ds[0][3]),
                              pack(ds[1][0], ds[1][1]), pack(ds[1][2], ds[1][3])};
      mma_acc(dv, ae, gt, kk, g, t);
      mma_acc(dk, ad, qt, kk, g, t);
    }
  }
  store_rows_bf16(dqkv, dk, N, K, b, k0 + r0, 1, h, t);
  store_rows_bf16(dqkv, dv, N, K, b, k0 + r0, 2, h, t);
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs on the CUDA cores (no TF32)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store_rows_f32(float* dqkv, const float acc[4][4], int N, int K,
                                               int b, int n0, int s, int h, int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= N) continue;
    float* row = drow(dqkv, N, K, b, n, s, h);
#pragma unroll
    for (int j = 0; j < 4; ++j) row[tx * 4 + j] = acc[i][j];
  }
}

__global__ void __launch_bounds__(F32_THREADS)
attn_bwd_dq_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ o,
                       const float* __restrict__ dout, float* __restrict__ dqkv,
                       float* __restrict__ stats, int B, int N, int K, Strides st, float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][LDT]  q, transposed
  float* gt = qt + D * LDT;                      // [D][LDT]  do, transposed
  float* kt = gt + D * LDT;                      // [D][LDT]  k tile, transposed
  float* vt = kt + D * LDT;                      // [D][LDT]  v tile, transposed
  float* ks = vt + D * LDT;                      // [BK][D]   k tile
  float* dst = ks + BK * D;                      // [BK][LDT] ds, transposed
  __shared__ float row_m[BQ], row_r[BQ], row_delta[BQ];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = qkv + b * st.b + h * st.h;
  const float* kb = qb + st.s;
  const float* vb = qb + 2 * st.s;
  const float* ob = o + b * st.ob + h * st.oh;
  const float* gb = dout + b * st.gb + h * st.gh;
  const int tiles = (N + BK - 1) / BK;

  stage_t(qt, qb, q0, N, st.n, st.d);
  stage_t(gt, gb, q0, N, st.gn, st.gd);

  // pass 1: each thread keeps (max, sum) over its own columns, online
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    stage_t(kt, kb, k0, N, st.n, st.d);
    __syncthreads();
    float s[4][4];
    f32_tn(s, qt, kt, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = k0 + tx * 4 + j < N ? s[i][j] * scale : -INFINITY;
      const float mn = fmaxf(m[i], fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
      if (mn == -INFINITY) continue;             // every column so far masked
      float sum = exp_shift(m[i], mn) * l[i];
#pragma unroll
      for (int j = 0; j < 4; ++j) sum += exp_shift(s[i][j], mn);
      m[i] = mn;
      l[i] = sum;
    }
  }
  // combine over the 16 threads (lanes differing in bits 0-3) sharing a row
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      const float mn = fmaxf(m[i], mo);
      if (mn != -INFINITY) l[i] = exp_shift(m[i], mn) * l[i] + exp_shift(mo, mn) * lo;
      m[i] = mn;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) { row_m[ty * 4 + i] = m[i]; row_r[ty * 4 + i] = 1.f / l[i]; }
  }
  if (threadIdx.x < BQ) {
    const int r = threadIdx.x, n = q0 + r;
    float dd = 0.f;
    if (n < N)
      for (int d = 0; d < D; ++d) dd = fmaf(gt[d * LDT + r], ob[n * st.on + d * st.od], dd);
    row_delta[r] = dd;
  }
  __syncthreads();
  if (threadIdx.x < BQ && q0 + threadIdx.x < N) {
    const int r = threadIdx.x, n = q0 + r;
    stat(stats, 0, B, K, N, b, h)[n] = row_m[r];
    stat(stats, 1, B, K, N, b, h)[n] = row_r[r];
    stat(stats, 2, B, K, N, b, h)[n] = row_delta[r];
  }

  // pass 2: ds, then dq += ds·k
  float dq[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[i][j] = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    stage_t(kt, kb, k0, N, st.n, st.d);
    stage_t(vt, vb, k0, N, st.n, st.d);
    stage_rows(ks, kb, k0, N, st.n, st.d);
    __syncthreads();
    float s[4][4], dp[4][4];
    f32_tn(s, qt, kt, tx, ty);
    f32_tn(dp, gt, vt, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = k0 + tx * 4 + j < N ? expf(s[i][j] * scale - row_m[r]) : 0.f;
        dst[(tx * 4 + j) * LDT + r] = e * ((dp[i][j] - row_delta[r]) * (row_r[r] * scale));
      }
    }
    __syncthreads();
    f32_acc(dq, dst, ks, tx, ty);
  }
  store_rows_f32(dqkv, dq, N, K, b, q0, 0, h, tx, ty);
}

__global__ void __launch_bounds__(F32_THREADS)
attn_bwd_dkdv_f32_kernel(const float* __restrict__ qkv, const float* __restrict__ dout,
                         float* __restrict__ dqkv, const float* __restrict__ stats, int B,
                         int N, int K, Strides st, float scale) {
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);   // [D][LDT]  k tile, transposed
  float* vt = kt + D * LDT;                      // [D][LDT]  v tile, transposed
  float* qt = vt + D * LDT;                      // [D][LDT]  q tile, transposed
  float* gt = qt + D * LDT;                      // [D][LDT]  do tile, transposed
  float* qs = gt + D * LDT;                      // [BQ][D]   q tile
  float* gs = qs + BQ * D;                       // [BQ][D]   do·r tile
  float* es = gs + BQ * D;                       // [BQ][LDT] e  [query][key]
  float* dss = es + BQ * LDT;                    // [BQ][LDT] ds [query][key]
  __shared__ float s_m[BQ], s_r[BQ], s_delta[BQ];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const float* qb = qkv + b * st.b + h * st.h;
  const float* kb = qb + st.s;
  const float* vb = qb + 2 * st.s;
  const float* gb = dout + b * st.gb + h * st.gh;
  const int tiles = (N + BQ - 1) / BQ;
  const float* st_m = stat(const_cast<float*>(stats), 0, B, K, N, b, h);
  const float* st_r = stat(const_cast<float*>(stats), 1, B, K, N, b, h);
  const float* st_delta = stat(const_cast<float*>(stats), 2, B, K, N, b, h);

  stage_t(kt, kb, k0, N, st.n, st.d);
  stage_t(vt, vb, k0, N, st.n, st.d);
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    const int q0 = tile * BQ;
    __syncthreads();
    if (threadIdx.x < BQ) {
      // query rows ≥ N: a row max of +inf makes e = exp(s − inf) = 0
      const int n = q0 + threadIdx.x;
      const bool valid = n < N;
      s_m[threadIdx.x] = valid ? st_m[n] : INFINITY;
      s_r[threadIdx.x] = valid ? st_r[n] : 0.f;
      s_delta[threadIdx.x] = valid ? st_delta[n] : 0.f;
    }
    stage_t(qt, qb, q0, N, st.n, st.d);
    stage_t(gt, gb, q0, N, st.gn, st.gd);
    stage_rows(qs, qb, q0, N, st.n, st.d);
    __syncthreads();                             // s_r is read below
    stage_rows(gs, gb, q0, N, st.gn, st.gd, s_r);
    float s[4][4], dp[4][4];
    f32_tn(s, kt, qt, tx, ty);                   // sᵀ: rows keys, columns queries
    f32_tn(dp, vt, gt, tx, ty);                  // dpᵀ
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = tx * 4 + j;
        const float e = expf(s[i][j] * scale - s_m[q]);
        es[q * LDT + key] = e;
        dss[q * LDT + key] = e * ((dp[i][j] - s_delta[q]) * (s_r[q] * scale));
      }
    }
    __syncthreads();
    f32_acc(dv, es, gs, tx, ty);
    f32_acc(dk, dss, qs, tx, ty);
  }
  store_rows_f32(dqkv, dk, N, K, b, k0, 1, h, tx, ty);
  store_rows_f32(dqkv, dv, N, K, b, k0, 2, h, tx, ty);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr size_t BF16_DQ_SMEM = (BQ * LD + 2 * BK * LD + D * LDV) * sizeof(bf16);
constexpr size_t BF16_DKDV_SMEM = (BK * LD + 2 * BQ * LD + 2 * D * LDV) * sizeof(bf16);
constexpr size_t F32_DQ_SMEM = (4 * D * LDT + BK * D + BK * LDT) * sizeof(float);
constexpr size_t F32_DKDV_SMEM = (4 * D * LDT + 2 * BQ * D + 2 * BQ * LDT) * sizeof(float);

template <typename F>
cudaError_t allow_smem(F kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
cudaError_t launch(void (*dq_kernel)(const T*, const T*, const T*, T*, float*, int, int, int,
                                     Strides, float),
                   void (*dkdv_kernel)(const T*, const T*, T*, const float*, int, int, int,
                                       Strides, float),
                   int threads, size_t dq_smem, size_t dkdv_smem, const void* qkv,
                   const void* o, const void* dout, void* dqkv, float* stats, int B, int N,
                   int K, const Strides& st, float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(dq_kernel, dq_smem);
  if (err == cudaSuccess) err = allow_smem(dkdv_kernel, dkdv_smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, K, B);
  const T* q = static_cast<const T*>(qkv);
  const T* g = static_cast<const T*>(dout);
  T* dst = static_cast<T*>(dqkv);
  dq_kernel<<<grid, threads, dq_smem, stream>>>(q, static_cast<const T*>(o), g, dst, stats, B,
                                                N, K, st, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dkdv_kernel<<<grid, threads, dkdv_smem, stream>>>(q, g, dst, stats, B, N, K, st, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 64.  Strides are in elements;
// dqkv is contiguous (B, N, 3, K, D) and stats a (3, B, K, N) f32 scratch.
// Returns a cudaError_t (0 on success); the launches do not synchronise.
extern "C" int flash_attention_qkv_bwd(const void* qkv, const void* o, const void* dout,
                                       void* dqkv, void* stats, int dtype, int B, int N, int K,
                                       int head_dim, long long sb, long long sn, long long ss,
                                       long long sh, long long sd, long long ob, long long on,
                                       long long oh, long long od, long long gb, long long gn,
                                       long long gh, long long gd, float scale, void* stream,
                                       int device) {
  if (head_dim != D || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Strides st{sb, sn, ss, sh, sd, ob, on, oh, od, gb, gn, gh, gd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sp = static_cast<float*>(stats);
  if (dtype == 0)
    return launch<float>(attn_bwd_dq_f32_kernel, attn_bwd_dkdv_f32_kernel, F32_THREADS,
                         F32_DQ_SMEM, F32_DKDV_SMEM, qkv, o, dout, dqkv, sp, B, N, K, st, scale,
                         s);
  return launch<bf16>(attn_bwd_dq_bf16_kernel, attn_bwd_dkdv_bf16_kernel, MMA_THREADS,
                      BF16_DQ_SMEM, BF16_DKDV_SMEM, qkv, o, dout, dqkv, sp, B, N, K, st, scale, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
