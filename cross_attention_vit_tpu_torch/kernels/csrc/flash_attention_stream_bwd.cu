// Blocked backward of the streaming self-attention, for Hopper (sm_90a).
//
// Replaces the two TPU kernels of _flash_backward_blocked in
// cross_attention_vit_tpu/kernels/flash_attention.py: _bwd_dq_kernel
// (defined at :429, launched at :527) and _bwd_dkv_kernel (:379, launched at
// :498).  From the forward's rounded output o and its row logsumexp lse
// (flash_attention_stream.cu), for every (batch b, head h):
//
//     delta = Σ_d dO·o                            f32 (plain XLA on the TPU)
//     p     = exp(s·scale − lse)                  already normalised
//     dv    = Σ (p cast to the operand dtype)ᵀ · dO   dO not scaled
//     dp    = dO·vᵀ
//     ds    = p·(dp − delta)·scale                cast to the operand dtype
//     dq    = ds·k;   dk = dsᵀ·q                  f32 accumulation everywhere
//
// This is not K2's rounding (flash_attention_bwd.cu): K2 rounds e and dO·r,
// these kernels round the normalised p.
//
// Layout.  q, k, v, o, dO and the outputs dq, dk, dv are (B, K, N, D)
// operands of any strides (in elements): the caller passes views of the
// stacked qkv and writes the gradients into views of a stacked dqkv, as
// the QKV projection's backward wants them.  lse and the delta scratch are
// contiguous (B, K, N) f32 arrays.  Head dim D = 64.
//
// Bound.  At the training shape of the 3-stream ModelVIT (B=8, K=16,
// N=1537, D=64, bf16) the backward must read q, k, v, o, dO and lse and
// write dq, dk, dv: 8·B·N·K·D·2 B + B·K·N·4 B = 202 MB, 60.3 us at
// 3.35 TB/s.  Its five products (s, dp, dv, dq, dk) are 10·B·K·N²·D =
// 193.5 GFLOP, 195.7 us at 989 TFLOP/s: operations bound it.  Split in two
// kernels that each recompute s and dp, the dq kernel does three products
// (6·B·K·N²·D) and the dk/dv kernel four (8·B·K·N²·D).
//
// Design.  As K2, FlashAttention-2 style, two kernels back to back on the
// caller's stream, every block owning its outputs (no atomics):
//
//   dq kernel:    one block per 64-row query tile.  It computes delta for
//                 its rows from o and dO and writes it to the scratch, then
//                 streams over the key tiles: s and dp, p from lse, ds in
//                 registers, dq += ds·k.
//   dk/dv kernel: one block per 64-key tile streams over the query tiles,
//                 reading lse and delta: sᵀ and dpᵀ, dv += pᵀ·dO,
//                 dk += dsᵀ·q.
//
// Ragged N: key columns ≥ N give p = 0 in the dq kernel; query rows ≥ N get
// lse = +inf in the dk/dv kernel, so their p and ds are exactly 0.  Rows ≥ N
// of every operand are staged as zeros (no NaN can enter a product) and
// nothing outside [0, N) is stored.
//
//   bf16: 4 warps, each owning 16 rows of the block's tile, run every
//   product on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//   accumulate).  The score-shaped accumulators are re-packed in registers
//   as the A operand of the next product (p for dv, ds for dq and dk).
//   exp(s·scale − lse) is exp2(c·s − lse·log2 e), one FMA and an exp2.
//   Needs a unit head-dim stride and 16-byte rows (the wrapper checks).
//   f32: scalar f32 FMAs on the CUDA cores (256 threads, 4×4 register
//   tiles), any strides, full f32 (no TF32).
//
// Not yet done (later work): prefetching the next tile during the products,
// wgmma and TMA, one kernel for dq, dk and dv.

#include "attention_tiles.cuh"

namespace {

struct Views {
  View q, k, v, o, g, dq, dk, dv;   // g: the output's cotangent dO
};

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

__global__ void __launch_bounds__(MMA_THREADS)
attn_stream_bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                               const bf16* __restrict__ v, const bf16* __restrict__ o,
                               const bf16* __restrict__ dout, const float* __restrict__ lse,
                               float* __restrict__ delta_out, bf16* __restrict__ dq, int N,
                               int K, Views st, float scale) {
  extern __shared__ float4 smem4[];
  bf16* rs = reinterpret_cast<bf16*>(smem4);   // [BQ][LD]  q, then dO (fragments)
  bf16* ks = rs + BQ * LD;                     // [BK][LD]  k tile
  bf16* vs = ks + BK * LD;                     // [BK][LD]  v tile
  bf16* kt = vs + BK * LD;                     // [D][LDV]  k tile, transposed

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = base(q, st.q, b, h);
  const bf16* kb = base(k, st.k, b, h);
  const bf16* vb = base(v, st.v, b, h);
  const bf16* ob = base(o, st.o, b, h);
  const bf16* gb = base(dout, st.g, b, h);
  const long long row0 = (static_cast<long long>(b) * K + h) * N;   // lse, delta
  const int tiles = (N + BK - 1) / BK;
  const float c = scale * LOG2E;               // exp(scale·x) = exp2(c·x)
  const int r0 = warp * 16 + g;

  Tile tl;
  uint32_t qf[D / 16][4], df[D / 16][4];
  tl.load_rows(qb, q0, N, st.q.n);
  tl.store_rows(rs, LD);
  __syncthreads();
  load_a(qf, rs, r0, t);
  __syncthreads();
  tl.load_rows(gb, q0, N, st.g.n);
  tl.store_rows(rs, LD);
  __syncthreads();
  load_a(df, rs, r0, t);

  // row statistics: cl = lse·log2 e (+inf past N, so p = 0 there) and
  // delta = Σ_d dO·o (thread t sums d in [16t, 16t + 16), then the quad adds)
  float cl[2], delta[2];
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
        for (int j = 0; j < 8; ++j) dd = fmaf(__bfloat162float(ge[j]), __bfloat162float(oe[j]), dd);
      }
    }
    dd += __shfl_xor_sync(0xffffffffu, dd, 1);
    dd += __shfl_xor_sync(0xffffffffu, dd, 2);
    delta[half] = dd;
    cl[half] = n < N ? lse[row0 + n] * LOG2E : INFINITY;
    if (t == 0 && n < N) delta_out[row0 + n] = dd;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
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
        const float p = valid ? exp2f(fmaf(s[j][e], c, -cl[half])) : 0.f;
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
attn_stream_bwd_dkdv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                 const bf16* __restrict__ v, const bf16* __restrict__ dout,
                                 const float* __restrict__ lse, const float* __restrict__ delta,
                                 bf16* __restrict__ dk, bf16* __restrict__ dv, int N, int K,
                                 Views st, float scale) {
  extern __shared__ float4 smem4[];
  bf16* rs = reinterpret_cast<bf16*>(smem4);   // [BK][LD]  k, then v (fragments)
  bf16* qs = rs + BK * LD;                     // [BQ][LD]  q tile
  bf16* gs = qs + BQ * LD;                     // [BQ][LD]  dO tile
  bf16* qt = gs + BQ * LD;                     // [D][LDV]  q tile, transposed
  bf16* gt = qt + D * LDV;                     // [D][LDV]  dO tile, transposed
  __shared__ float s_cl[BQ], s_delta[BQ];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = base(q, st.q, b, h);
  const bf16* kb = base(k, st.k, b, h);
  const bf16* vb = base(v, st.v, b, h);
  const bf16* gb = base(dout, st.g, b, h);
  const long long row0 = (static_cast<long long>(b) * K + h) * N;
  const int tiles = (N + BQ - 1) / BQ;
  const float c = scale * LOG2E;
  const int r0 = warp * 16 + g;

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
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    const int q0 = tile * BQ;
    __syncthreads();
    if (threadIdx.x < BQ) {
      // query rows ≥ N: lse = +inf makes p = exp2(c·s − inf) = 0
      const int n = q0 + threadIdx.x;
      s_cl[threadIdx.x] = n < N ? lse[row0 + n] * LOG2E : INFINITY;
      s_delta[threadIdx.x] = n < N ? delta[row0 + n] : 0.f;
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
          p[jj][x] = exp2f(fmaf(s[j][x], c, -s_cl[qi]));
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

__global__ void __launch_bounds__(F32_THREADS)
attn_stream_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, const float* __restrict__ o,
                              const float* __restrict__ dout, const float* __restrict__ lse,
                              float* __restrict__ delta_out, float* __restrict__ dq, int N,
                              int K, Views st, float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][LDT]  q, transposed
  float* gt = qt + D * LDT;                      // [D][LDT]  dO, transposed
  float* kt = gt + D * LDT;                      // [D][LDT]  k tile, transposed
  float* vt = kt + D * LDT;                      // [D][LDT]  v tile, transposed
  float* ks = vt + D * LDT;                      // [BK][D]   k tile
  float* dst = ks + BK * D;                      // [BK][LDT] ds, transposed
  __shared__ float row_lse[BQ], row_delta[BQ];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = base(q, st.q, b, h);
  const float* kb = base(k, st.k, b, h);
  const float* vb = base(v, st.v, b, h);
  const float* ob = base(o, st.o, b, h);
  const float* gb = base(dout, st.g, b, h);
  const long long row0 = (static_cast<long long>(b) * K + h) * N;
  const int tiles = (N + BK - 1) / BK;

  stage_t(qt, qb, q0, N, st.q.n, st.q.d);
  stage_t(gt, gb, q0, N, st.g.n, st.g.d);
  __syncthreads();
  if (threadIdx.x < BQ) {
    const int r = threadIdx.x, n = q0 + r;
    float dd = 0.f;
    if (n < N)
      for (int d = 0; d < D; ++d) dd = fmaf(gt[d * LDT + r], ob[n * st.o.n + d * st.o.d], dd);
    row_delta[r] = dd;
    row_lse[r] = n < N ? lse[row0 + n] : INFINITY;
    if (n < N) delta_out[row0 + n] = dd;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
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
        const float p = k0 + tx * 4 + j < N ? expf(s[i][j] * scale - row_lse[r]) : 0.f;
        dst[(tx * 4 + j) * LDT + r] = p * (dp[i][j] - row_delta[r]) * scale;
      }
    }
    __syncthreads();
    f32_acc(acc, dst, ks, tx, ty);
  }
  store_rows_f32(base(dq, st.dq, b, h), st.dq, acc, N, q0, tx, ty);
}

__global__ void __launch_bounds__(F32_THREADS)
attn_stream_bwd_dkdv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                const float* __restrict__ v, const float* __restrict__ dout,
                                const float* __restrict__ lse, const float* __restrict__ delta,
                                float* __restrict__ dk, float* __restrict__ dv, int N, int K,
                                Views st, float scale) {
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);   // [D][LDT]  k tile, transposed
  float* vt = kt + D * LDT;                      // [D][LDT]  v tile, transposed
  float* qt = vt + D * LDT;                      // [D][LDT]  q tile, transposed
  float* gt = qt + D * LDT;                      // [D][LDT]  dO tile, transposed
  float* qs = gt + D * LDT;                      // [BQ][D]   q tile
  float* gs = qs + BQ * D;                       // [BQ][D]   dO tile
  float* ps = gs + BQ * D;                       // [BQ][LDT] p  [query][key]
  float* dss = ps + BQ * LDT;                    // [BQ][LDT] ds [query][key]
  __shared__ float s_lse[BQ], s_delta[BQ];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const float* qb = base(q, st.q, b, h);
  const float* kb = base(k, st.k, b, h);
  const float* vb = base(v, st.v, b, h);
  const float* gb = base(dout, st.g, b, h);
  const long long row0 = (static_cast<long long>(b) * K + h) * N;
  const int tiles = (N + BQ - 1) / BQ;

  stage_t(kt, kb, k0, N, st.k.n, st.k.d);
  stage_t(vt, vb, k0, N, st.v.n, st.v.d);
  float dka[4][4], dva[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dka[i][j] = dva[i][j] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    const int q0 = tile * BQ;
    __syncthreads();
    if (threadIdx.x < BQ) {
      // query rows ≥ N: lse = +inf makes p = exp(s − inf) = 0
      const int n = q0 + threadIdx.x;
      s_lse[threadIdx.x] = n < N ? lse[row0 + n] : INFINITY;
      s_delta[threadIdx.x] = n < N ? delta[row0 + n] : 0.f;
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
        const float p = expf(s[i][j] * scale - s_lse[qi]);
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

constexpr size_t BF16_DQ_SMEM = (BQ * LD + 2 * BK * LD + D * LDV) * sizeof(bf16);
constexpr size_t BF16_DKDV_SMEM = (BK * LD + 2 * BQ * LD + 2 * D * LDV) * sizeof(bf16);
constexpr size_t F32_DQ_SMEM = (4 * D * LDT + BK * D + BK * LDT) * sizeof(float);
constexpr size_t F32_DKDV_SMEM = (4 * D * LDT + 2 * BQ * D + 2 * BQ * LDT) * sizeof(float);

struct Call {
  const void *q, *k, *v, *o, *g;
  const float* lse;
  float* delta;
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
                      void (*kernel)(const T*, const T*, const T*, const T*, const T*,
                                     const float*, float*, T*, int, int, Views, float)) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BQ - 1) / BQ, a.K, a.B);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.g), a.lse, a.delta,
      static_cast<T*>(a.dq), a.N, a.K, a.st, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkdv(const Call& a, int threads, size_t smem,
                        void (*kernel)(const T*, const T*, const T*, const T*, const float*,
                                       const float*, T*, T*, int, int, Views, float)) {
  cudaError_t err = prepare(kernel, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BK - 1) / BK, a.K, a.B);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), a.lse, a.delta, static_cast<T*>(a.dk), static_cast<T*>(a.dv),
      a.N, a.K, a.st, a.scale);
  return cudaGetLastError();
}

// The shared C signature of both entry points.
#define STREAM_BWD_PARAMS                                                                      \
  const void *q, const void *k, const void *v, const void *o, const void *g, const void *lse,  \
      void *delta, void *dq, void *dk, void *dv, int dtype, int B, int N, int K, int head_dim, \
      long long qb, long long qh, long long qn, long long qd, long long kb, long long kh,       \
      long long kn, long long kd, long long vb, long long vh, long long vn, long long vd,       \
      long long ob, long long oh, long long on, long long od, long long gb, long long gh,      \
      long long gn, long long gd, long long dqb, long long dqh, long long dqn, long long dqd,  \
      long long dkb, long long dkh, long long dkn, long long dkd, long long dvb,               \
      long long dvh, long long dvn, long long dvd, float scale, void *stream, int device

#define STREAM_BWD_CALL                                                                        \
  Call{q, k, v, o, g, static_cast<const float*>(lse), static_cast<float*>(delta), dq, dk, dv, \
       B, N, K,                                                                                \
       Views{{qb, qh, qn, qd}, {kb, kh, kn, kd}, {vb, vh, vn, vd}, {ob, oh, on, od},           \
             {gb, gh, gn, gd}, {dqb, dqh, dqn, dqd}, {dkb, dkh, dkn, dkd},                     \
             {dvb, dvh, dvn, dvd}},                                                            \
       scale, static_cast<cudaStream_t>(stream)}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 64.  Each operand's strides
// are (b, h, n, d) of its (B, K, N, D) view, in elements; lse and delta are
// contiguous (B, K, N) f32 arrays.  Run flash_attention_stream_bwd_dq first
// (it writes delta), then flash_attention_stream_bwd_dkdv on the same stream.
// Each returns a cudaError_t (0 on success); the launches do not synchronise.
extern "C" int flash_attention_stream_bwd_dq(STREAM_BWD_PARAMS) {
  if (head_dim != D || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Call a = STREAM_BWD_CALL;
  if (dtype == 0)
    return launch_dq<float>(a, F32_THREADS, F32_DQ_SMEM, attn_stream_bwd_dq_f32_kernel);
  return launch_dq<bf16>(a, MMA_THREADS, BF16_DQ_SMEM, attn_stream_bwd_dq_bf16_kernel);
}

extern "C" int flash_attention_stream_bwd_dkdv(STREAM_BWD_PARAMS) {
  if (head_dim != D || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Call a = STREAM_BWD_CALL;
  if (dtype == 0)
    return launch_dkdv<float>(a, F32_THREADS, F32_DKDV_SMEM, attn_stream_bwd_dkdv_f32_kernel);
  return launch_dkdv<bf16>(a, MMA_THREADS, BF16_DKDV_SMEM, attn_stream_bwd_dkdv_bf16_kernel);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
