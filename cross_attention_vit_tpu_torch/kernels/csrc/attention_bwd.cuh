// The backward kernels of the "tn" attention (K2, K6 and K8's first two
// kernels): the function of _tn_bwd_math
// (cross_attention_vit_tpu/kernels/flash_attention.py:628-692) for every
// (batch b, head h):
//
//     s     = q·kᵀ · scale;  m = rowmax(s);  e = exp(s − m);  r = 1 / Σ_j e
//     delta = rowsum(do ⊙ o)                        f32
//     dv    = (e cast to the operand dtype)ᵀ · (do·r cast to the operand dtype)
//     dp    = do·vᵀ
//     ds    = e · ((dp − delta) · (r · scale))      cast to the operand dtype
//     dq    = ds·k;   dk = dsᵀ·q                    f32 accumulation everywhere
//
// with o either the SAVED forward output (kRecompute = false: K2, K8) or
// recomputed, o = (e cast to the operand dtype)·v · r in f32 and never
// rounded (kRecompute = true: K6, _tn_bwd_math with o=None).  Head dim D = 64.
//
// Layout.  Every operand is a (B, K, N, D) view given by its pointer and its
// (b, h, n, d) strides in elements (View): K2 and K8 read q, k, v as views of
// the stacked (B, N, 3, K, D) qkv and write dq, dk, dv as views of a stacked
// dqkv; K6 reads separate tensors of any strides.  The outputs need a unit
// head-dim stride (the wrappers allocate them so).
//
// Design.  The 513×513 f32 score and gradient planes do not fit in shared
// memory, so the TPU's one-block-per-(b, h) program is split FlashAttention-2
// style into two kernels launched back to back on the caller's stream:
//
//   dq kernel:   one block per 64-row query tile.  Pass 1 over the key tiles
//                finds each row's max and sum; with kRecompute a second pass
//                accumulates e·v in f32 registers for o.  The block writes the
//                row statistics (m, r, delta) to a (3, B, K, N) f32 scratch.
//                The last pass recomputes s and dp tile by tile, forms ds in
//                registers and accumulates dq = ds·k.
//   dk/dv kernel: one block per 64-key tile loops over the query tiles, reads
//                the row statistics, recomputes sᵀ and dpᵀ and accumulates
//                dv = ebᵀ·do_r and dk = dsᵀ·q.
//
// Every block owns its outputs, so nothing is accumulated across blocks and
// no atomics are needed.  The ragged last tile (513 = 8·64 + 1) is masked: in
// the dq kernel key columns ≥ N contribute e = 0; in the dk/dv kernel query
// rows ≥ N get a row max of +inf, so their e, and with it their ds, is 0.
// Rows ≥ N of every operand are staged as zeros and nothing outside [0, N) is
// stored.
//
//   bf16: 4 warps, each owning 16 rows of the block's tile, run every product
//   on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate).
//   The score-shaped accumulators are re-packed in registers as the A operand
//   of the next product (e for o and dv, ds for dq and dk), so no N×N plane
//   touches shared memory.  Tiles move in 16-byte chunks (Tile) or element by
//   element (TileAny, any strides).  exp(scale·(s − m)) is one FMA and an
//   exp2.  Without kRecompute the saved o and do are read as 16-byte chunks.
//   f32: scalar f32 FMAs on the CUDA cores (256 threads, 4×4 register
//   tiles), element-wise staging, any strides; full f32, no TF32.

#pragma once

#include "attention_tiles.cuh"

namespace {

struct BwdViews {
  View q, k, v, o, g, dq, dk, dv;   // g: the output's cotangent dO; o unused with kRecompute
};

// Row statistics scratch (3, B, K, N) f32: [0] the row max (bf16: of the
// unscaled scores times scale·log2 e; f32: of the scaled scores), [1] r,
// [2] delta.
__device__ __forceinline__ float* stat(float* stats, int which, int B, int K, int N, int b,
                                       int h) {
  return stats + ((static_cast<long long>(which) * B + b) * K + h) * N;
}

__device__ __forceinline__ void zero(float acc[D / 8][4]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

// Writes this warp's 16 rows × D of f32 accumulators as bf16 rows n_first and
// n_first + 8 of the (b, h) slice `dst` (unit head-dim stride, row stride sn).
__device__ __forceinline__ void store_rows_bf16(bf16* dst, long long sn,
                                                const float acc[D / 8][4], int N, int n_first,
                                                int t) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = n_first + 8 * half;
    if (n >= N) continue;
    bf16* row = dst + n * sn;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + j * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[j][2 * half], acc[j][2 * half + 1]);
  }
}

template <class TileT, bool kRecompute>
__global__ void __launch_bounds__(MMA_THREADS)
attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ o,
                        const bf16* __restrict__ dout, bf16* __restrict__ dq,
                        float* __restrict__ stats, int B, int N, int K, BwdViews st,
                        float scale) {
  extern __shared__ float4 smem4[];
  bf16* rs = reinterpret_cast<bf16*>(smem4);   // [BQ][LD]  q, then do (fragments)
  bf16* ks = rs + BQ * LD;                     // [BK][LD]  k tile
  bf16* vs = ks + BK * LD;                     // [BK][LD]  v tile
  bf16* kt = vs + BK * LD;                     // [D][LDV]  k (or, for o, v) tile, transposed

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = base(q, st.q, b, h);
  const bf16* kb = base(k, st.k, b, h);
  const bf16* vb = base(v, st.v, b, h);
  const bf16* gb = base(dout, st.g, b, h);
  const int tiles = (N + BK - 1) / BK;
  const float c = scale * LOG2E;   // exp(scale·x) = exp2(c·x)
  const int r0 = warp * 16 + g;

  TileT tl, tv;
  uint32_t qf[D / 16][4], df[D / 16][4];
  tl.load_rows(qb, q0, N, st.q.n, st.q.d);
  tl.store_rows(rs, LD);
  __syncthreads();
  load_a(qf, rs, r0, t);
  __syncthreads();
  tl.load_rows(gb, q0, N, st.g.n, st.g.d);
  tl.store_rows(rs, LD);
  __syncthreads();
  load_a(df, rs, r0, t);

  // pass 1: row max and sum (online); a quad of threads shares a row
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    tl.load_rows(kb, k0, N, st.k.n, st.k.d);
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

  float cm[2], rr[2], delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    cm[half] = c * m[half];
    rr[half] = 1.f / l[half];
  }

  if constexpr (kRecompute) {
    // pass 2: o = (eb·v)·r in f32, eb = bf16(exp(s − m)); then
    // delta = Σ_d f32(do)·o, with do from this warp's A fragments: fragment
    // register (j % 2)·2 + half of column block kk = j / 2 holds the two
    // columns 8j + 2t + {0, 1} of row r0 + 8·half, as o's C fragment does
    float acc[D / 8][4];
    zero(acc);
    for (int tile = 0; tile < tiles; ++tile) {
      const int k0 = tile * BK;
      __syncthreads();
      tl.load_rows(kb, k0, N, st.k.n, st.k.d);
      tl.store_rows(ks, LD);
      tv.load_cols(vb, k0, N, st.v.n, st.v.d);
      tv.store_transposed(kt, LDV);
      __syncthreads();
      float s[BK / 8][4];
      mma_nt(s, qf, ks, g, t);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = k0 + j * 8 + 2 * t + (e & 1) < N ? exp2f(fmaf(s[j][e], c, -cm[e >> 1])) : 0.f;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                               pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        mma_acc(acc, a, kt, kk, g, t);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float dd = 0.f;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 gv = unpack(df[j / 2][(j % 2) * 2 + half]);
        dd = fmaf(gv.x, acc[j][2 * half] * rr[half], dd);
        dd = fmaf(gv.y, acc[j][2 * half + 1] * rr[half], dd);
      }
      dd += __shfl_xor_sync(0xffffffffu, dd, 1);
      dd += __shfl_xor_sync(0xffffffffu, dd, 2);
      delta[half] = dd;
    }
  } else {
    // delta = Σ_d do·o from the saved o (thread t sums d in [16t, 16t + 16),
    // then the quad adds)
    const bf16* ob = base(o, st.o, b, h);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = q0 + r0 + 8 * half;
      float dd = 0.f;
      if (n < N) {
#pragma unroll
        for (int part = 0; part < 2; ++part) {
          const uint4 gv = *reinterpret_cast<const uint4*>(gb + n * st.g.n + 16 * t + 8 * part);
          const uint4 ov = *reinterpret_cast<const uint4*>(ob + n * st.o.n + 16 * t + 8 * part);
          const bf16* ge = reinterpret_cast<const bf16*>(&gv);
          const bf16* oe = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
          for (int j = 0; j < 8; ++j)
            dd = fmaf(__bfloat162float(ge[j]), __bfloat162float(oe[j]), dd);
        }
      }
      dd += __shfl_xor_sync(0xffffffffu, dd, 1);
      dd += __shfl_xor_sync(0xffffffffu, dd, 2);
      delta[half] = dd;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = q0 + r0 + 8 * half;
    if (t == 0 && n < N) {
      stat(stats, 0, B, K, N, b, h)[n] = cm[half];
      stat(stats, 1, B, K, N, b, h)[n] = rr[half];
      stat(stats, 2, B, K, N, b, h)[n] = delta[half];
    }
  }

  // last pass: ds = e·((dp − delta)·(r·scale)) in registers, dq += ds·k
  float dqa[D / 8][4];
  zero(dqa);
  const float rsc[2] = {rr[0] * scale, rr[1] * scale};
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    tl.load_rows(kb, k0, N, st.k.n, st.k.d);
    tl.store_rows(ks, LD);
    tv.load_rows(vb, k0, N, st.v.n, st.v.d);
    tv.store_rows(vs, LD);
    tl.load_cols(kb, k0, N, st.k.n, st.k.d);
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
      mma_acc(dqa, a, kt, kk, g, t);
    }
  }
  store_rows_bf16(base(dq, st.dq, b, h), st.dq.n, dqa, N, q0 + r0, t);
}

template <class TileT>
__global__ void __launch_bounds__(MMA_THREADS)
attn_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ dout,
                          bf16* __restrict__ dk, bf16* __restrict__ dv,
                          const float* __restrict__ stats, int B, int N, int K, BwdViews st,
                          float scale) {
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
  const bf16* qb = base(q, st.q, b, h);
  const bf16* kb = base(k, st.k, b, h);
  const bf16* vb = base(v, st.v, b, h);
  const bf16* gb = base(dout, st.g, b, h);
  const int tiles = (N + BQ - 1) / BQ;
  const float c = scale * LOG2E;
  const int r0 = warp * 16 + g;
  float* const fstats = const_cast<float*>(stats);
  const float* st_cm = stat(fstats, 0, B, K, N, b, h);
  const float* st_r = stat(fstats, 1, B, K, N, b, h);
  const float* st_delta = stat(fstats, 2, B, K, N, b, h);

  TileT tl;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  tl.load_rows(kb, k0, N, st.k.n, st.k.d);
  tl.store_rows(rs, LD);
  __syncthreads();
  load_a(kf, rs, r0, t);
  __syncthreads();
  tl.load_rows(vb, k0, N, st.v.n, st.v.d);
  tl.store_rows(rs, LD);
  __syncthreads();
  load_a(vf, rs, r0, t);

  float dka[D / 8][4], dva[D / 8][4];
  zero(dka);
  zero(dva);

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
    tl.load_rows(qb, q0, N, st.q.n, st.q.d);
    tl.store_rows(qs, LD);
    tl.load_rows(gb, q0, N, st.g.n, st.g.d);
    tl.store_rows(gs, LD);
    tl.load_cols(qb, q0, N, st.q.n, st.q.d);
    tl.store_transposed(qt, LDV);
    tl.load_cols(gb, q0, N, st.g.n, st.g.d);
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
          const int qi = j * 8 + 2 * t + (x & 1);
          e[jj][x] = exp2f(fmaf(s[j][x], c, -s_cm[qi]));
          ds[jj][x] = e[jj][x] * ((dp[j][x] - s_delta[qi]) * s_rs[qi]);
        }
      const uint32_t ae[4] = {pack(e[0][0], e[0][1]), pack(e[0][2], e[0][3]),
                              pack(e[1][0], e[1][1]), pack(e[1][2], e[1][3])};
      const uint32_t ad[4] = {pack(ds[0][0], ds[0][1]), pack(ds[0][2], ds[0][3]),
                              pack(ds[1][0], ds[1][1]), pack(ds[1][2], ds[1][3])};
      mma_acc(dva, ae, gt, kk, g, t);
      mma_acc(dka, ad, qt, kk, g, t);
    }
  }
  store_rows_bf16(base(dk, st.dk, b, h), st.dk.n, dka, N, k0 + r0, t);
  store_rows_bf16(base(dv, st.dv, b, h), st.dv.n, dva, N, k0 + r0, t);
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs on the CUDA cores (no TF32)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store_rows_f32(float* dst, const View& st,
                                               const float acc[4][4], int N, int n0, int tx,
                                               int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = n0 + ty * 4 + i;
    if (n >= N) continue;
    float* row = dst + n * st.n;
#pragma unroll
    for (int j = 0; j < 4; ++j) row[(tx * 4 + j) * st.d] = acc[i][j];
  }
}

__device__ __forceinline__ void zero4(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
}

template <bool kRecompute>
__global__ void __launch_bounds__(F32_THREADS)
attn_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, const float* __restrict__ o,
                       const float* __restrict__ dout, float* __restrict__ dq,
                       float* __restrict__ stats, int B, int N, int K, BwdViews st,
                       float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][LDT]  q, transposed
  float* gt = qt + D * LDT;                      // [D][LDT]  do, transposed
  float* kt = gt + D * LDT;                      // [D][LDT]  k tile, transposed
  float* vt = kt + D * LDT;                      // [D][LDT]  v tile, transposed
  float* ks = vt + D * LDT;                      // [BK][D]   k (or, for o, v) tile
  float* dst = ks + BK * D;                      // [BK][LDT] ds (or e), transposed
  __shared__ float row_m[BQ], row_r[BQ], row_delta[BQ];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = base(q, st.q, b, h);
  const float* kb = base(k, st.k, b, h);
  const float* vb = base(v, st.v, b, h);
  const float* gb = base(dout, st.g, b, h);
  const int tiles = (N + BK - 1) / BK;

  stage_t(qt, qb, q0, N, st.q.n, st.q.d);
  stage_t(gt, gb, q0, N, st.g.n, st.g.d);

  // pass 1: each thread keeps (max, sum) over its own columns, online
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) { m[i] = -INFINITY; l[i] = 0.f; }
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    stage_t(kt, kb, k0, N, st.k.n, st.k.d);
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

  if constexpr (kRecompute) {
    // pass 2: o = (e·v)·r in f32 (the operand dtype is f32: e is not
    // rounded), then delta = Σ_d do·o over this thread's columns, added over
    // the 16 threads of a row
    float acc[4][4];
    zero4(acc);
    for (int tile = 0; tile < tiles; ++tile) {
      const int k0 = tile * BK;
      __syncthreads();
      stage_t(kt, kb, k0, N, st.k.n, st.k.d);
      stage_rows(ks, vb, k0, N, st.v.n, st.v.d);
      __syncthreads();
      float s[4][4];
      f32_tn(s, qt, kt, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          dst[(tx * 4 + j) * LDT + r] =
              k0 + tx * 4 + j < N ? expf(s[i][j] * scale - row_m[r]) : 0.f;
      }
      __syncthreads();
      f32_acc(acc, dst, ks, tx, ty);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      float dd = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) dd = fmaf(gt[(tx * 4 + j) * LDT + r], acc[i][j] * row_r[r], dd);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) dd += __shfl_xor_sync(0xffffffffu, dd, off);
      if (tx == 0) row_delta[r] = dd;
    }
  } else {
    __syncthreads();                             // row_r
    if (threadIdx.x < BQ) {
      const float* ob = base(o, st.o, b, h);
      const int r = threadIdx.x, n = q0 + r;
      float dd = 0.f;
      if (n < N)
        for (int d = 0; d < D; ++d) dd = fmaf(gt[d * LDT + r], ob[n * st.o.n + d * st.o.d], dd);
      row_delta[r] = dd;
    }
  }
  __syncthreads();
  if (threadIdx.x < BQ && q0 + threadIdx.x < N) {
    const int r = threadIdx.x, n = q0 + r;
    stat(stats, 0, B, K, N, b, h)[n] = row_m[r];
    stat(stats, 1, B, K, N, b, h)[n] = row_r[r];
    stat(stats, 2, B, K, N, b, h)[n] = row_delta[r];
  }

  // last pass: ds, then dq += ds·k
  float dqa[4][4];
  zero4(dqa);
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    stage_t(kt, kb, k0, N, st.k.n, st.k.d);
    stage_t(vt, vb, k0, N, st.v.n, st.v.d);
    stage_rows(ks, kb, k0, N, st.k.n, st.k.d);
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
    f32_acc(dqa, dst, ks, tx, ty);
  }
  store_rows_f32(base(dq, st.dq, b, h), st.dq, dqa, N, q0, tx, ty);
}

__global__ void __launch_bounds__(F32_THREADS)
attn_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, const float* __restrict__ dout,
                         float* __restrict__ dk, float* __restrict__ dv,
                         const float* __restrict__ stats, int B, int N, int K, BwdViews st,
                         float scale) {
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
  const float* qb = base(q, st.q, b, h);
  const float* kb = base(k, st.k, b, h);
  const float* vb = base(v, st.v, b, h);
  const float* gb = base(dout, st.g, b, h);
  const int tiles = (N + BQ - 1) / BQ;
  float* const fstats = const_cast<float*>(stats);
  const float* st_m = stat(fstats, 0, B, K, N, b, h);
  const float* st_r = stat(fstats, 1, B, K, N, b, h);
  const float* st_delta = stat(fstats, 2, B, K, N, b, h);

  stage_t(kt, kb, k0, N, st.k.n, st.k.d);
  stage_t(vt, vb, k0, N, st.v.n, st.v.d);
  float dka[4][4], dva[4][4];
  zero4(dka);
  zero4(dva);

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
    stage_t(qt, qb, q0, N, st.q.n, st.q.d);
    stage_t(gt, gb, q0, N, st.g.n, st.g.d);
    stage_rows(qs, qb, q0, N, st.q.n, st.q.d);
    __syncthreads();                             // s_r is read below
    stage_rows(gs, gb, q0, N, st.g.n, st.g.d, s_r);
    float s[4][4], dp[4][4];
    f32_tn(s, kt, qt, tx, ty);                   // sᵀ: rows keys, columns queries
    f32_tn(dp, vt, gt, tx, ty);                  // dpᵀ
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx * 4 + j;
        const float e = expf(s[i][j] * scale - s_m[qi]);
        es[qi * LDT + key] = e;
        dss[qi * LDT + key] = e * ((dp[i][j] - s_delta[qi]) * (s_r[qi] * scale));
      }
    }
    __syncthreads();
    f32_acc(dva, es, gs, tx, ty);
    f32_acc(dka, dss, qs, tx, ty);
  }
  store_rows_f32(base(dk, st.dk, b, h), st.dk, dka, N, k0, tx, ty);
  store_rows_f32(base(dv, st.dv, b, h), st.dv, dva, N, k0, tx, ty);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr size_t BF16_DQ_SMEM = (BQ * LD + 2 * BK * LD + D * LDV) * sizeof(bf16);
constexpr size_t BF16_DKDV_SMEM = (BK * LD + 2 * BQ * LD + 2 * D * LDV) * sizeof(bf16);
constexpr size_t F32_DQ_SMEM = (4 * D * LDT + BK * D + BK * LDT) * sizeof(float);
constexpr size_t F32_DKDV_SMEM = (4 * D * LDT + 2 * BQ * D + 2 * BQ * LDT) * sizeof(float);

// One backward call: operands, outputs and the statistics scratch.
struct BwdCall {
  const void *q, *k, *v, *o, *g;
  void *dq, *dk, *dv;
  float* stats;
  int B, N, K;
  BwdViews st;
  float scale;
  cudaStream_t stream;
};

template <typename T>
cudaError_t launch_bwd_dq(const BwdCall& a, int threads, size_t smem,
                          void (*kernel)(const T*, const T*, const T*, const T*, const T*, T*,
                                         float*, int, int, int, BwdViews, float)) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BQ - 1) / BQ, a.K, a.B);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.g), static_cast<T*>(a.dq), a.stats,
      a.B, a.N, a.K, a.st, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dkdv(const BwdCall& a, int threads, size_t smem,
                            void (*kernel)(const T*, const T*, const T*, const T*, T*, T*,
                                           const float*, int, int, int, BwdViews, float)) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BK - 1) / BK, a.K, a.B);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.stats, a.B,
      a.N, a.K, a.st, a.scale);
  return cudaGetLastError();
}

// The views of the stacked layouts: q, k, v of a (B, N, 3, K, D) qkv with
// strides (sb, sn, ss, sh, sd), o and do of (B, N, K, D) tensors, and
// dq, dk, dv of a contiguous (B, N, 3, K, D) dqkv.  Element offsets of k, v
// and dk, dv from their slab's base pointer are ss and K·D.
inline BwdViews stacked_views(int N, int K, long long sb, long long sn, long long sh,
                              long long sd, long long ob, long long on, long long oh,
                              long long od, long long gb, long long gn, long long gh,
                              long long gd) {
  const View qv{sb, sh, sn, sd};
  const View dv{static_cast<long long>(N) * 3 * K * D, D, 3LL * K * D, 1};
  return BwdViews{qv, qv, qv, {ob, oh, on, od}, {gb, gh, gn, gd}, dv, dv, dv};
}

}  // namespace
