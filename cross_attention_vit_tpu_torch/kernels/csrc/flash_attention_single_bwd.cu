// Recompute-form backward of the single-block self-attention, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel cross_attention_vit_tpu/kernels/flash_attention.py
// ::_attn_bwd_kernel (defined at :280, launched by pallas_call at :351 in
// _flash_backward_pallas), the gradient of the public flash_attention at
// N <= _SINGLE_BLOCK_MAX = 1040 (_bwd, :1103-1108).  Nothing of the forward
// is saved but q, k, v.  For every (batch b, head h):
//
//     s     = q·kᵀ · scale;   p = softmax(s)           f32, p = e / Σe
//     pb    = p cast to the operand dtype
//     o     = pb·v                                     f32, NOT rounded
//     delta = Σ_d f32(dO)·o
//     dv    = pbᵀ·dO                                   dO not scaled
//     dp    = dO·vᵀ
//     ds    = p·(dp − delta)·scale                     the f32 p; cast
//     dq    = ds·k;   dk = dsᵀ·q                       f32 accumulation
//
// This is neither K2's rounding (flash_attention_bwd.cu rounds e and dO·r and
// takes delta from the saved output) nor K7's (flash_attention_stream_bwd.cu
// takes p = exp(s − lse) and delta from the rounded forward output).
//
// Layout.  q, k, v, dO and dq, dk, dv are (B, K, N, D) operands of any
// strides (in elements).  The row statistics go through a (3, B, K, N) f32
// scratch: [0] the row max (bf16: c·m with c = scale·log2 e, of the unscaled
// scores; f32: m of the scaled scores), [1] l = Σ exp(s − m), [2] delta.
// Head dim D = 64.
//
// Bound.  At B=8, K=16, N=513, D=64 bf16 the function must read q, k, v, dO
// and write dq, dk, dv: 7·B·N·K·D·2 B = 58.8 MB, 17.6 us at 3.35 TB/s.  Its
// least work is five products (s, dp, dv, dq, dk; delta can be had as
// rowsum(pb ⊙ dp) without recomputing o), 10·B·K·N²·D = 21.6 GFLOP, 21.8 us
// at 989 TFLOP/s, so operations bound it.  This design does ten: the dq
// kernel six (s in pass 1; s and pb·v in pass 2; s, dp and dq in pass 3),
// the dk/dv kernel four (s, dp, dv, dk).
//
// Design.  The TPU kernel held the (N, N) planes of one (b, h) in VMEM; here
// they do not fit in shared memory, so the program is split into two kernels
// launched back to back on the caller's stream, each block owning its
// outputs (no atomics):
//
//   dq kernel:    one block per 64-row query tile.  Pass 1 over the key tiles
//                 finds each row's m and l; pass 2 forms pb and accumulates
//                 o = pb·v in f32 registers, then delta = Σ_d dO·o; the block
//                 writes (m, l, delta) to the scratch.  Pass 3 recomputes s
//                 and dp, forms ds from the f32 p and accumulates dq = ds·k.
//   dk/dv kernel: one block per 64-key tile streams the query tiles, reads
//                 (m, l, delta) and recomputes sᵀ and dpᵀ: dv += pbᵀ·dO,
//                 dk += dsᵀ·q.
//
// The f32 p enters twice: in ds, and as the value pb rounds from.  Ragged N:
// key columns ≥ N give p = 0 in the dq kernel; query rows ≥ N get m = +inf
// and l = 1 in the dk/dv kernel, so their p and ds are exactly 0.  Rows ≥ N
// of every operand are staged as zeros and nothing outside [0, N) is stored.
//
//   bf16: 4 warps, each owning 16 rows of the block's tile, run every product
//   on the tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate); the
//   score-shaped accumulators are re-packed in registers as the A operand of
//   the next product (pb for o and dv, ds for dq and dk).  Needs a unit
//   head-dim stride and 16-byte rows (the wrapper checks).
//   f32: scalar f32 FMAs on the CUDA cores (256 threads, 4×4 register
//   tiles), any strides, full f32 (no TF32).
//
// Not yet done (later work): delta as rowsum(pb ⊙ dp) (one product fewer),
// prefetching the next tile during the products, wgmma and TMA.

#include "attention_tiles.cuh"

namespace {

struct Views {
  View q, k, v, g, dq, dk, dv;   // g: the output's cotangent dO
};

// the (b, h) row of statistic `which` in the (3, B, K, N) scratch
__device__ __forceinline__ float* stat(float* stats, int which, int B, int K, int N, int b,
                                       int h) {
  return stats + ((static_cast<long long>(which) * B + b) * K + h) * N;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

// Writes this warp's 16 rows × D of f32 accumulators as bf16 rows n_first
// and n_first + 8 of the (b, h) slice `dst` (unit head-dim stride).
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

__device__ __forceinline__ void zero(float acc[D / 8][4]) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
}

__global__ void __launch_bounds__(MMA_THREADS)
attn_single_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ dout,
                               float* __restrict__ stats, bf16* __restrict__ dq, int B, int N,
                               int K, Views st, float scale) {
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);   // [BQ][LD]  q tile (fragments)
  bf16* gs = qs + BQ * LD;                     // [BQ][LD]  dO tile, kept for delta
  bf16* ks = gs + BQ * LD;                     // [BK][LD]  k tile
  bf16* vs = ks + BK * LD;                     // [BK][LD]  v tile
  bf16* kt = vs + BK * LD;                     // [D][LDV]  k tile, transposed
  bf16* vt = kt + D * LDV;                     // [D][LDV]  v tile, transposed

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = base(q, st.q, b, h);
  const bf16* kb = base(k, st.k, b, h);
  const bf16* vb = base(v, st.v, b, h);
  const bf16* gb = base(dout, st.g, b, h);
  const int tiles = (N + BK - 1) / BK;
  const float c = scale * LOG2E;               // exp(scale·x) = exp2(c·x)
  const int r0 = warp * 16 + g;

  Tile tl;
  uint32_t qf[D / 16][4], df[D / 16][4];
  tl.load_rows(qb, q0, N, st.q.n);
  tl.store_rows(qs, LD);
  tl.load_rows(gb, q0, N, st.g.n);
  tl.store_rows(gs, LD);
  __syncthreads();
  load_a(qf, qs, r0, t);
  load_a(df, gs, r0, t);

  // pass 1: row max (unscaled) and sum, online; a quad of threads shares a row
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    tl.load_rows(kb, k0, N, st.k.n);
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
  float cm[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    cm[half] = c * m[half];
  }

  // pass 2: o = pb·v in f32, pb = bf16(exp(s − m) / l)
  float acc[D / 8][4];
  zero(acc);
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    tl.load_rows(kb, k0, N, st.k.n);
    tl.store_rows(ks, LD);
    tl.load_cols(vb, k0, N, st.v.n);
    tl.store_transposed(vt, LDV);
    __syncthreads();
    float s[BK / 8][4];
    mma_nt(s, qf, ks, g, t);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[j][e] = k0 + j * 8 + 2 * t + (e & 1) < N
                      ? exp2f(fmaf(s[j][e], c, -cm[e >> 1])) / l[e >> 1] : 0.f;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_acc(acc, a, vt, kk, g, t);
    }
  }

  // delta = Σ_d dO·o: thread (g, t) holds columns 8j + 2t + {0, 1} of rows
  // r0 and r0 + 8; the quad adds
  float delta[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bf16* grow = gs + (r0 + 8 * half) * LD + 2 * t;
    float dd = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        dd = fmaf(__bfloat162float(grow[j * 8 + e]), acc[j][2 * half + e], dd);
    dd += __shfl_xor_sync(0xffffffffu, dd, 1);
    dd += __shfl_xor_sync(0xffffffffu, dd, 2);
    delta[half] = dd;
    const int n = q0 + r0 + 8 * half;
    if (t == 0 && n < N) {
      stat(stats, 0, B, K, N, b, h)[n] = cm[half];
      stat(stats, 1, B, K, N, b, h)[n] = l[half];
      stat(stats, 2, B, K, N, b, h)[n] = dd;
    }
  }

  // pass 3: ds = p·(dp − delta)·scale with the f32 p, dq += bf16(ds)·k
  zero(acc);
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    tl.load_rows(kb, k0, N, st.k.n);
    tl.store_rows(ks, LD);
    tl.load_rows(vb, k0, N, st.v.n);
    tl.store_rows(vs, LD);
    tl.load_cols(kb, k0, N, st.k.n);
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
        const float p = valid ? exp2f(fmaf(s[j][e], c, -cm[half])) / l[half] : 0.f;
        s[j][e] = p * (dp[j][e] - delta[half]) * scale;      // ds
      }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_acc(acc, a, kt, kk, g, t);
    }
  }
  store_rows_bf16(base(dq, st.dq, b, h), st.dq.n, acc, N, q0 + r0, t);
}

__global__ void __launch_bounds__(MMA_THREADS)
attn_single_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                 const float* __restrict__ stats, bf16* __restrict__ dk,
                                 bf16* __restrict__ dv, int B, int N, int K, Views st,
                                 float scale) {
  extern __shared__ float4 smem4[];
  bf16* rs = reinterpret_cast<bf16*>(smem4);   // [BK][LD]  k, then v (fragments)
  bf16* qs = rs + BK * LD;                     // [BQ][LD]  q tile
  bf16* gs = qs + BQ * LD;                     // [BQ][LD]  dO tile
  bf16* qt = gs + BQ * LD;                     // [D][LDV]  q tile, transposed
  bf16* gt = qt + D * LDV;                     // [D][LDV]  dO tile, transposed
  __shared__ float s_cm[BQ], s_l[BQ], s_delta[BQ];

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
  const float* st_l = stat(fstats, 1, B, K, N, b, h);
  const float* st_delta = stat(fstats, 2, B, K, N, b, h);

  Tile tl;
  uint32_t kf[D / 16][4], vf[D / 16][4];
  tl.load_rows(kb, k0, N, st.k.n);
  tl.store_rows(rs, LD);
  __syncthreads();
  load_a(kf, rs, r0, t);
  __syncthreads();
  tl.load_rows(vb, k0, N, st.v.n);
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
      // query rows ≥ N: m = +inf and l = 1 make p = exp2(c·s − inf) / 1 = 0
      const int n = q0 + threadIdx.x;
      const bool valid = n < N;
      s_cm[threadIdx.x] = valid ? st_cm[n] : INFINITY;
      s_l[threadIdx.x] = valid ? st_l[n] : 1.f;
      s_delta[threadIdx.x] = valid ? st_delta[n] : 0.f;
    }
    tl.load_rows(qb, q0, N, st.q.n);
    tl.store_rows(qs, LD);
    tl.load_rows(gb, q0, N, st.g.n);
    tl.store_rows(gs, LD);
    tl.load_cols(qb, q0, N, st.q.n);
    tl.store_transposed(qt, LDV);
    tl.load_cols(gb, q0, N, st.g.n);
    tl.store_transposed(gt, LDV);
    __syncthreads();

    float s[BQ / 8][4], dp[BQ / 8][4];
    mma_nt(s, kf, qs, g, t);                   // sᵀ: rows keys, columns queries
    mma_nt(dp, vf, gs, g, t);                  // dpᵀ
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      float p[2][4], ds[2][4];
#pragma unroll
      for (int jj = 0; jj < 2; ++jj)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int j = 2 * kk + jj;
          const int qi = j * 8 + 2 * t + (x & 1);
          p[jj][x] = exp2f(fmaf(s[j][x], c, -s_cm[qi])) / s_l[qi];
          ds[jj][x] = p[jj][x] * (dp[j][x] - s_delta[qi]) * scale;
        }
      const uint32_t ap[4] = {pack(p[0][0], p[0][1]), pack(p[0][2], p[0][3]),
                              pack(p[1][0], p[1][1]), pack(p[1][2], p[1][3])};
      const uint32_t ad[4] = {pack(ds[0][0], ds[0][1]), pack(ds[0][2], ds[0][3]),
                              pack(ds[1][0], ds[1][1]), pack(ds[1][2], ds[1][3])};
      mma_acc(dva, ap, gt, kk, g, t);
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

__global__ void __launch_bounds__(F32_THREADS)
attn_single_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ dout,
                              float* __restrict__ stats, float* __restrict__ dq, int B, int N,
                              int K, Views st, float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][LDT]  q, transposed
  float* gt = qt + D * LDT;                      // [D][LDT]  dO, transposed
  float* kt = gt + D * LDT;                      // [D][LDT]  k tile, transposed
  float* vt = kt + D * LDT;                      // [D][LDT]  v tile, transposed
  float* rows = vt + D * LDT;                    // [BK][D]   v (pass 2) or k (pass 3) tile
  float* pt = rows + BK * D;                     // [BK][LDT] p or ds, transposed
  __shared__ float row_m[BQ], row_l[BQ], row_delta[BQ];

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
    for (int i = 0; i < 4; ++i) { row_m[ty * 4 + i] = m[i]; row_l[ty * 4 + i] = l[i]; }
  }

  // pass 2: o = pb·v in f32 (pb = p, the operand dtype is f32)
  float acc[4][4];
  zero4(acc);
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    stage_t(kt, kb, k0, N, st.k.n, st.k.d);
    stage_rows(rows, vb, k0, N, st.v.n, st.v.d);
    __syncthreads();
    float s[4][4];
    f32_tn(s, qt, kt, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        pt[(tx * 4 + j) * LDT + r] =
            k0 + tx * 4 + j < N ? expf(s[i][j] * scale - row_m[r]) / row_l[r] : 0.f;
    }
    __syncthreads();
    f32_acc(acc, pt, rows, tx, ty);
  }
  // delta = Σ_d dO·o over this thread's columns d = tx·4 + j, then the 16
  // threads of a row add
  float delta[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float dd = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) dd = fmaf(gt[(tx * 4 + j) * LDT + ty * 4 + i], acc[i][j], dd);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) dd += __shfl_xor_sync(0xffffffffu, dd, off);
    delta[i] = dd;
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, n = q0 + r;
      row_delta[r] = delta[i];
      if (n < N) {
        stat(stats, 0, B, K, N, b, h)[n] = row_m[r];
        stat(stats, 1, B, K, N, b, h)[n] = row_l[r];
        stat(stats, 2, B, K, N, b, h)[n] = delta[i];
      }
    }
  }

  // pass 3: ds = p·(dp − delta)·scale, then dq += ds·k
  zero4(acc);
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    stage_t(kt, kb, k0, N, st.k.n, st.k.d);
    stage_t(vt, vb, k0, N, st.v.n, st.v.d);
    stage_rows(rows, kb, k0, N, st.k.n, st.k.d);
    __syncthreads();
    float s[4][4], dp[4][4];
    f32_tn(s, qt, kt, tx, ty);
    f32_tn(dp, gt, vt, tx, ty);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = k0 + tx * 4 + j < N ? expf(s[i][j] * scale - row_m[r]) / row_l[r] : 0.f;
        pt[(tx * 4 + j) * LDT + r] = p * (dp[i][j] - row_delta[r]) * scale;
      }
    }
    __syncthreads();
    f32_acc(acc, pt, rows, tx, ty);
  }
  store_rows_f32(base(dq, st.dq, b, h), st.dq, acc, N, q0, tx, ty);
}

__global__ void __launch_bounds__(F32_THREADS)
attn_single_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ stats, float* __restrict__ dk,
                                float* __restrict__ dv, int B, int N, int K, Views st,
                                float scale) {
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);   // [D][LDT]  k tile, transposed
  float* vt = kt + D * LDT;                      // [D][LDT]  v tile, transposed
  float* qt = vt + D * LDT;                      // [D][LDT]  q tile, transposed
  float* gt = qt + D * LDT;                      // [D][LDT]  dO tile, transposed
  float* qs = gt + D * LDT;                      // [BQ][D]   q tile
  float* gs = qs + BQ * D;                       // [BQ][D]   dO tile
  float* ps = gs + BQ * D;                       // [BQ][LDT] p  [query][key]
  float* dss = ps + BQ * LDT;                    // [BQ][LDT] ds [query][key]
  __shared__ float s_m[BQ], s_l[BQ], s_delta[BQ];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const float* qb = base(q, st.q, b, h);
  const float* kb = base(k, st.k, b, h);
  const float* vb = base(v, st.v, b, h);
  const float* gb = base(dout, st.g, b, h);
  const int tiles = (N + BQ - 1) / BQ;
  float* const fstats = const_cast<float*>(stats);
  const float* st_m = stat(fstats, 0, B, K, N, b, h);
  const float* st_l = stat(fstats, 1, B, K, N, b, h);
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
      // query rows ≥ N: m = +inf and l = 1 make p = exp(s − inf) / 1 = 0
      const int n = q0 + threadIdx.x;
      const bool valid = n < N;
      s_m[threadIdx.x] = valid ? st_m[n] : INFINITY;
      s_l[threadIdx.x] = valid ? st_l[n] : 1.f;
      s_delta[threadIdx.x] = valid ? st_delta[n] : 0.f;
    }
    stage_t(qt, qb, q0, N, st.q.n, st.q.d);
    stage_t(gt, gb, q0, N, st.g.n, st.g.d);
    stage_rows(qs, qb, q0, N, st.q.n, st.q.d);
    stage_rows(gs, gb, q0, N, st.g.n, st.g.d);
    __syncthreads();
    float s[4][4], dp[4][4];
    f32_tn(s, kt, qt, tx, ty);                   // sᵀ: rows keys, columns queries
    f32_tn(dp, vt, gt, tx, ty);                  // dpᵀ
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qi = tx * 4 + j;
        const float p = expf(s[i][j] * scale - s_m[qi]) / s_l[qi];
        ps[qi * LDT + key] = p;
        dss[qi * LDT + key] = p * (dp[i][j] - s_delta[qi]) * scale;
      }
    }
    __syncthreads();
    f32_acc(dva, ps, gs, tx, ty);
    f32_acc(dka, dss, qs, tx, ty);
  }
  store_rows_f32(base(dk, st.dk, b, h), st.dk, dka, N, k0, tx, ty);
  store_rows_f32(base(dv, st.dv, b, h), st.dv, dva, N, k0, tx, ty);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr size_t BF16_DQ_SMEM = (2 * BQ * LD + 2 * BK * LD + 2 * D * LDV) * sizeof(bf16);
constexpr size_t BF16_DKDV_SMEM = (BK * LD + 2 * BQ * LD + 2 * D * LDV) * sizeof(bf16);
constexpr size_t F32_DQ_SMEM = (4 * D * LDT + BK * D + BK * LDT) * sizeof(float);
constexpr size_t F32_DKDV_SMEM = (4 * D * LDT + 2 * BQ * D + 2 * BQ * LDT) * sizeof(float);

struct Call {
  const void *q, *k, *v, *g;
  float* stats;
  void *dq, *dk, *dv;
  int B, N, K;
  Views st;
  float scale;
  cudaStream_t stream;
};

template <typename F>
cudaError_t prepare(F kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <typename T>
cudaError_t launch_dq(const Call& a, int threads, size_t smem,
                      void (*kernel)(const T*, const T*, const T*, const T*, float*, T*, int,
                                     int, int, Views, float)) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BQ - 1) / BQ, a.K, a.B);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.stats, static_cast<T*>(a.dq), a.B, a.N, a.K, a.st, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkdv(const Call& a, int threads, size_t smem,
                        void (*kernel)(const T*, const T*, const T*, const T*, const float*, T*,
                                       T*, int, int, int, Views, float)) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BK - 1) / BK, a.K, a.B);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.stats, static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.B,
      a.N, a.K, a.st, a.scale);
  return cudaGetLastError();
}

// The shared C signature of both entry points.
#define SINGLE_BWD_PARAMS                                                                      \
  const void *q, const void *k, const void *v, const void *g, void *stats, void *dq, void *dk, \
      void *dv, int dtype, int B, int N, int K, int head_dim, long long qb, long long qh,      \
      long long qn, long long qd, long long kb, long long kh, long long kn, long long kd,      \
      long long vb, long long vh, long long vn, long long vd, long long gb, long long gh,      \
      long long gn, long long gd, long long dqb, long long dqh, long long dqn, long long dqd,  \
      long long dkb, long long dkh, long long dkn, long long dkd, long long dvb,               \
      long long dvh, long long dvn, long long dvd, float scale, void *stream, int device

#define SINGLE_BWD_CALL                                                                        \
  Call{q, k, v, g, static_cast<float*>(stats), dq, dk, dv, B, N, K,                            \
       Views{{qb, qh, qn, qd}, {kb, kh, kn, kd}, {vb, vh, vn, vd}, {gb, gh, gn, gd},           \
             {dqb, dqh, dqn, dqd}, {dkb, dkh, dkn, dkd}, {dvb, dvh, dvn, dvd}},                \
       scale, static_cast<cudaStream_t>(stream)}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 64.  Each operand's strides
// are (b, h, n, d) of its (B, K, N, D) view, in elements; stats is a
// contiguous (3, B, K, N) f32 scratch.  Run flash_attention_single_bwd_dq
// first (it writes stats), then flash_attention_single_bwd_dkdv on the same
// stream.  Each returns a cudaError_t (0 on success); the launches do not
// synchronise.
extern "C" int flash_attention_single_bwd_dq(SINGLE_BWD_PARAMS) {
  if (head_dim != D || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Call a = SINGLE_BWD_CALL;
  if (dtype == 0)
    return launch_dq<float>(a, F32_THREADS, F32_DQ_SMEM, attn_single_bwd_dq_f32_kernel);
  return launch_dq<bf16>(a, MMA_THREADS, BF16_DQ_SMEM, attn_single_bwd_dq_bf16_kernel);
}

extern "C" int flash_attention_single_bwd_dkdv(SINGLE_BWD_PARAMS) {
  if (head_dim != D || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Call a = SINGLE_BWD_CALL;
  if (dtype == 0)
    return launch_dkdv<float>(a, F32_THREADS, F32_DKDV_SMEM, attn_single_bwd_dkdv_f32_kernel);
  return launch_dkdv<bf16>(a, MMA_THREADS, BF16_DKDV_SMEM, attn_single_bwd_dkdv_bf16_kernel);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
