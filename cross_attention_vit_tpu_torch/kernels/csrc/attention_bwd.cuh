// The backward kernels of the attention's single-block path (K2, K5, K6 and
// K8's first two kernels) and of the streaming path (K7), for Hopper
// (sm_90a): the function of _tn_bwd_math
// (cross_attention_vit_tpu/kernels/flash_attention.py:628-692) for every
// (batch b, head h), given the forward's row statistics (m, r) (see `stat`):
//
//     s     = q·kᵀ · scale;  e = exp(s − m)
//     delta = rowsum(do ⊙ o)                        f32
//     dv    = (e cast to the operand dtype)ᵀ · (do·r cast to the operand dtype)
//     dp    = do·vᵀ
//     ds    = e · ((dp − delta) · (r · scale))      cast to the operand dtype
//     dq    = ds·k;   dk = dsᵀ·q                    f32 accumulation everywhere
//
// with o either the SAVED forward output (kRecompute = false: K2, K8) or
// recomputed, o = (e cast to the operand dtype)·v · r in f32 and never
// rounded (kRecompute = true: K6, _tn_bwd_math with o=None).
//
// K5 (_attn_bwd_kernel, :280-336, the public flash_attention's recompute-form
// backward) is kRecompute under another rounding rule, kNormalised: the row
// normalisation comes before the rounding, p = e·r (f32), pb = bf16(p),
//
//     o  = pb·v (f32, never rounded);   dv = pbᵀ · do  (do not scaled)
//     ds = p · (dp − delta) · scale     cast to the operand dtype
//
// (jax.nn.softmax divides, e / Σe; e·r is within 2 ulp of it).  In f32 the
// two rules are one function, so K5's f32 kernels are K6's bodies.
//
// K7 (_bwd_dq_kernel :429 and _bwd_dkv_kernel :379, the blocked backward of
// the streaming forward, _flash_backward_blocked :467) is the saved-o form
// under K5's rule read through kLse: its forward saves the row logsumexp, a
// (B, K, N) f32 lse, which is read as m with r ≡ 1, so e = exp(s − lse) is
// the normalised p itself; ds is formed in the TPU kernel's order,
// (p·(dp − delta))·scale.  lse is `stat`'s plane 0 (the same indexing) and
// no plane 1 is read.  Head dim D = 64.
//
// Layout.  Every operand is a (B, K, N, D) view given by its pointer and its
// (b, h, n, d) strides in elements (View): K2, K8 and K7 read q, k, v as
// views of the stacked (B, N, 3, K, D) qkv and write dq, dk, dv as views of
// a stacked dqkv; K6 and K5 read separate tensors.  bf16 operands need a
// unit head-dim stride and 16-byte aligned rows (the wrappers check, or copy
// for K6); the outputs a unit head-dim stride.  The f32 kernels take any
// strides.
//
// Design.  The 513×513 f32 score and gradient planes do not fit in shared
// memory, so the TPU's one-block-per-(b, h) program is split FlashAttention-2
// style into two kernels launched back to back on the caller's stream:
//
//   dq kernel:   one block per 64-row query tile.  It reads m and r (no pass
//                recomputes them); with kRecompute a first pass over the
//                keys accumulates e·v (K5: pb·v) for o.  It writes delta to
//                a (B, K, N) f32 scratch, then recomputes s and dp tile by
//                tile, forms ds in registers and accumulates dq = ds·k.
//                Products per key tile: s, dp, dq (K5, K6 also s and e·v
//                first).
//   dk/dv kernel: one block per 64-key tile loops over the query tiles,
//                reads m, r and delta, recomputes sᵀ and dpᵀ and accumulates
//                dv = ebᵀ·do_r (K5, K7: pbᵀ·do) and dk = dsᵀ·q: four
//                products per tile.
//
// Seven products in all (K5 and K6: nine; five is the minimum: s, dp, dv,
// dq, dk) and two exponentials per score (K5, K6: three).  Every block owns
// its outputs and sums them in a fixed order: no atomics, two identical
// calls give identical bits.
//
//   bf16: one warpgroup (128 threads) per block runs every product as
//   wgmma (m64nNk16, bf16 in, f32 accumulate).  Operand tiles arrive by
//   cp.async into a three-slot ring (the next tiles' copies overlap this
//   tile's products), each staged ONCE, row-major in the 128-byte swizzle:
//   read K-major for s, dp, sᵀ, dpᵀ and transposed (MN-major B) for
//   dq = ds·k, dv = ebᵀ·do_r and dk = dsᵀ·q.  The score-shaped accumulators
//   are packed in registers as the A operand of the next product (e for o
//   and dv, ds for dq and dk); e is formed while the dp product runs.
//   do_r = bf16(do·r) overwrites the do tile in place once dpᵀ has read it
//   (K5's and K7's dv read do as it is: no rewrite and no barrier for it).
//   The dk/dv kernel forms sᵀ and dpᵀ 32 query columns at a time, so that
//   half a score plane is live beside its dk and dv accumulators: 160
//   registers (ptxas -v), three blocks an SM.  The one-row tail (513 = 8·64 + 1,
//   1025, 1537) costs 16 columns, not 64: its score products run m64n16 and the
//   next products one 16-deep step (a longer ragged tail runs 64 wide,
//   masked, and as many 16-deep steps as it needs); columns ≥ N get e = 0
//   (key columns in the dq kernel, query columns in the dk/dv kernel, so a
//   padded query row's p and ds are 0 whatever its m), rows ≥ N are
//   zero-filled by the copies and never stored.  The query side of a block
//   stays one 64-row warpgroup tile.
//   f32: scalar f32 FMAs on the CUDA cores (256 threads, 4×4 register
//   tiles), element-wise staging, any strides; full f32, no TF32.

#pragma once

#include "hopper_tiles.cuh"

namespace {

struct BwdViews {
  View q, k, v, o, g, dq, dk, dv;   // g: the output's cotangent dO; o unused with kRecompute
};

// ---------------------------------------------------------------------------
// bf16: wgmma, tiles by cp.async
// ---------------------------------------------------------------------------

constexpr int BWD_STAGES = 3;   // ring slots of both kernels

// The kernels' parameters: operand views, outputs, the forward's row
// statistics, the delta scratch (written by the dq kernel, read by the dk/dv
// kernel), the sizes, the views' strides and the softmax scale.
#define BWD_DQ_PARAMS(T)                                                                       \
  const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v,                    \
      const T *__restrict__ o, const T *__restrict__ dout, T *__restrict__ dq,                  \
      const float *__restrict__ stats, float *__restrict__ delta_out, int B, int N, int K,      \
      BwdViews st, float scale
#define BWD_DQ_ARGS q, k, v, o, dout, dq, stats, delta_out, B, N, K, st, scale
#define BWD_DKDV_PARAMS(T)                                                                     \
  const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v,                    \
      const T *__restrict__ dout, T *__restrict__ dk, T *__restrict__ dv,                       \
      const float *__restrict__ stats, const float *__restrict__ delta, int B, int N, int K,    \
      BwdViews st, float scale
#define BWD_DKDV_ARGS q, k, v, dout, dk, dv, stats, delta, B, N, K, st, scale

template <bool kRecompute, bool kNormalised, bool kLse = false>
__device__ __forceinline__ void attn_bwd_dq_bf16(BWD_DQ_PARAMS(bf16)) {
  static_assert(!kLse || (kNormalised && !kRecompute), "K7's rule: the saved o, p normalised");
  extern __shared__ float4 smem4[];
  bf16* qs = aligned_smem(smem4);              // q tile
  bf16* gs = qs + TILE;                        // do tile
  bf16* ring = gs + TILE;                      // [stage][k, v] tiles

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int r0 = warp * 16 + g;
  const bf16* qb = base(q, st.q, b, h);
  const bf16* kb = base(k, st.k, b, h);
  const bf16* vb = base(v, st.v, b, h);
  const bf16* gb = base(dout, st.g, b, h);
  const int tiles = (N + BK - 1) / BK, steps = kRecompute ? 2 * tiles : tiles;
  const float c = scale * LOG2E;   // exp(scale·s − m) = exp2(c·s − m·log2 e)

  auto issue = [&](int i) {
    bf16* stage = ring + (i % BWD_STAGES) * 2 * TILE;
    const int k0 = (i % tiles) * BK;
    load_tile_async(stage, kb, k0, N, st.k.n);
    load_tile_async(stage + TILE, vb, k0, N, st.v.n);
  };
  load_tile_async(qs, qb, q0, N, st.q.n);       // join step 0's group
  load_tile_async(gs, gb, q0, N, st.g.n);
  ring_begin<BWD_STAGES>(steps, issue);

  // this thread's rows: m·log2 e, r and delta (rows ≥ N: 0, never stored;
  // kLse: m = lse, r ≡ 1)
  float cm[2], rr[2], delta[2] = {0.f, 0.f};
  float* const fstats = const_cast<float*>(stats);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = q0 + r0 + 8 * half;
    cm[half] = n < N ? stat(fstats, 0, B, K, N, b, h)[n] * LOG2E : 0.f;
    rr[half] = n >= N ? 0.f : kLse ? 1.f : stat(fstats, 1, B, K, N, b, h)[n];
  }
  if constexpr (!kRecompute) {
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
  const float rsc[2] = {rr[0] * scale, rr[1] * scale};

  float s[32], dp[32], acc[32];   // acc: o (kRecompute's first pass), then dq
  zero32(acc);
  for (int i = 0; i < steps; ++i) {
    ring_step<BWD_STAGES>(i, steps, issue);
    const bf16* ks = ring + (i % BWD_STAGES) * 2 * TILE;
    const bf16* vs = ks + TILE;
    const int k0 = (i % tiles) * BK;
    const int nb = min(BK, N - k0 + 15) / 16;
    const bool full = k0 + BK <= N;
    uint32_t a[4][4];
    if (kRecompute && i < tiles) {
      // first pass: o = (eb·v)·r in f32, eb = bf16(exp(s − m)); K5:
      // o = pb·v, pb = bf16(exp(s − m)·r)
      wg_fence();
      mma_tn_n(s, qs, ks, nb);
      wg_commit();
      wg_wait<0>();
      settle(s);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float e = full || (j < 2 * nb && k0 + 8 * j + 2 * t + (x & 1) < N)
                              ? exp2f(fmaf(s[4 * j + x], c, -cm[x >> 1])) : 0.f;
          s[4 * j + x] = kNormalised ? e * rr[x >> 1] : e;
        }
      pack_a(a, s);
      wg_fence();
      mma_nn(acc, a, vs, nb);
      wg_commit();
      wg_wait<0>();
      if (i == tiles - 1) {
        // delta = Σ_d f32(do)·o, do from the staged tile, o in acc's layout
        // (K5's is normalised already)
        settle(acc);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = r0 + 8 * half;
          const float orr = kNormalised ? 1.f : rr[half];
          float dd = 0.f;
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            const float2 gv = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(gs + swz(row, 8 * j + 2 * t)));
            dd = fmaf(gv.x, acc[4 * j + 2 * half] * orr, dd);
            dd = fmaf(gv.y, acc[4 * j + 2 * half + 1] * orr, dd);
          }
          dd += __shfl_xor_sync(0xffffffffu, dd, 1);
          dd += __shfl_xor_sync(0xffffffffu, dd, 2);
          delta[half] = dd;
        }
        zero32(acc);
      }
    } else {
      // ds = e·((dp − delta)·(r·scale)) in registers (K5's p·(dp − delta)·
      // scale with p = e·r, up to f32 rounding; kLse: (p·(dp − delta))·scale,
      // the TPU kernel's order), dq += ds·k; e is formed while the dp
      // product runs
      wg_fence();
      mma_tn_n(s, qs, ks, nb);
      wg_commit();
      mma_tn_n(dp, gs, vs, nb);
      wg_commit();
      wg_wait<1>();
      settle(s);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const bool valid = full || (j < 2 * nb && k0 + 8 * j + 2 * t + (x & 1) < N);
          s[4 * j + x] = valid ? exp2f(fmaf(s[4 * j + x], c, -cm[x >> 1])) : 0.f;
        }
      wg_wait<0>();
      settle(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float d = dp[4 * j + x] - delta[x >> 1];
          s[4 * j + x] = kLse ? s[4 * j + x] * d * scale : s[4 * j + x] * (d * rsc[x >> 1]);
        }
      pack_a(a, s);
      wg_fence();
      mma_nn(acc, a, ks, nb);
      wg_commit();
      wg_wait<0>();
    }
  }
  settle(acc);
  const float one[2] = {1.f, 1.f};
  store_acc_bf16(base(dq, st.dq, b, h), st.dq.n, acc, N, q0 + r0, t, one);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = q0 + r0 + 8 * half;
    if (t == 0 && n < N) stat(delta_out, 0, B, K, N, b, h)[n] = delta[half];
  }
}

template <bool kNormalised, bool kLse = false>
__device__ __forceinline__ void attn_bwd_dkdv_bf16(BWD_DKDV_PARAMS(bf16)) {
  static_assert(!kLse || kNormalised, "K7's rule: p normalised");
  extern __shared__ float4 smem4[];
  bf16* ks = aligned_smem(smem4);              // this block's k tile
  bf16* vs = ks + TILE;                        // and v tile
  bf16* ring = vs + TILE;                      // [stage][q, do] tiles
  // [stage][m, r, delta][BQ] (kLse: m = lse; r neither read nor used)
  float* rowst = reinterpret_cast<float*>(ring + BWD_STAGES * 2 * TILE);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * BK, h = blockIdx.y, b = blockIdx.z;
  const int r0 = warp * 16 + g;
  const bf16* qb = base(q, st.q, b, h);
  const bf16* kb = base(k, st.k, b, h);
  const bf16* vb = base(v, st.v, b, h);
  const bf16* gb = base(dout, st.g, b, h);
  const int tiles = (N + BQ - 1) / BQ;
  const float c = scale * LOG2E;
  // this (b, h)'s m, then r one plane further, and delta
  const float* mrow = stat(const_cast<float*>(stats), 0, B, K, N, b, h);
  const long long plane = static_cast<long long>(B) * K * N;
  const float* drow = stat(const_cast<float*>(delta), 0, B, K, N, b, h);

  auto issue = [&](int i) {
    bf16* stage = ring + (i % BWD_STAGES) * 2 * TILE;
    const int q0 = i * BQ;
    load_tile_async(stage, qb, q0, N, st.q.n);
    load_tile_async(stage + TILE, gb, q0, N, st.g.n);
    if (threadIdx.x < BQ) {
      const int n = q0 + threadIdx.x;
      const bool ok = n < N;
      const int at = ok ? n : 0;
      float* fs = rowst + (i % BWD_STAGES) * 3 * BQ + threadIdx.x;
      load_f32_async(fs, mrow + at, ok);
      if constexpr (!kLse) load_f32_async(fs + BQ, mrow + plane + at, ok);
      load_f32_async(fs + 2 * BQ, drow + at, ok);
    }
  };
  load_tile_async(ks, kb, k0, N, st.k.n);       // join step 0's group
  load_tile_async(vs, vb, k0, N, st.v.n);
  ring_begin<BWD_STAGES>(tiles, issue);

  float dka[32], dva[32];
  zero32(dka);
  zero32(dva);
  for (int i = 0; i < tiles; ++i) {
    ring_step<BWD_STAGES>(i, tiles, issue);
    bf16* qs = ring + (i % BWD_STAGES) * 2 * TILE;
    bf16* gs = qs + TILE;
    const float* fm = rowst + (i % BWD_STAGES) * 3 * BQ;   // m, r, delta of the 64 rows
    const int q0 = i * BQ;
    const int nb = min(BQ, N - q0 + 15) / 16;
    const bool full = q0 + BQ <= N;

    // sᵀ and dpᵀ (rows this block's keys, columns the tile's queries), 32
    // query columns at a time so that only half of each score plane is live
    // beside the dk and dv accumulators; e (K5: p = e·r; K7: p = e) is
    // formed while the dpᵀ product runs, then both are packed as the A
    // operands of dv and dk
    uint32_t ea[4][4], da[4][4];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int nbh = min(nb - 2 * hh, 2);   // 16-column blocks of this half
      if (nbh <= 0) break;
      float s[32], dp[32];                   // columns [0, 16·nbh) are used
      const bf16* qh = qs + 32 * hh * D;
      const bf16* gh = gs + 32 * hh * D;
      wg_fence();
      if (nbh == 1) mma_tn<1>(s, ks, qh); else mma_tn<2>(s, ks, qh);
      wg_commit();
      if (nbh == 1) mma_tn<1>(dp, vs, gh); else mma_tn<2>(dp, vs, gh);
      wg_commit();
      wg_wait<1>();
      settle<16>(s);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int qi = 32 * hh + 8 * j + 2 * t + (x & 1);
          const bool valid = full || (j < 2 * nbh && q0 + qi < N);
          const float e = valid ? exp2f(fmaf(s[4 * j + x], c, -fm[qi] * LOG2E)) : 0.f;
          s[4 * j + x] = kNormalised && !kLse ? e * fm[BQ + qi] : e;
        }
      wg_wait<0>();
      settle<16>(dp);
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int qi = 32 * hh + 8 * j + 2 * t + (x & 1);
          const float d = dp[4 * j + x] - fm[2 * BQ + qi];
          dp[4 * j + x] = kLse ? s[4 * j + x] * d * scale
                               : s[4 * j + x] * (d * (kNormalised ? scale : fm[BQ + qi] * scale));
        }
#pragma unroll
      for (int kk = 0; kk < 2; ++kk)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          ea[2 * hh + kk][x] = pack(s[8 * kk + 2 * x], s[8 * kk + 2 * x + 1]);
          da[2 * hh + kk][x] = pack(dp[8 * kk + 2 * x], dp[8 * kk + 2 * x + 1]);
        }
    }
    if constexpr (!kNormalised) {
      // do_r = bf16(do·r) over the do tile, in place, once every warp's share
      // of dpᵀ has read it (K5's and K7's dv read do unscaled: no rewrite, no
      // barrier)
      __syncthreads();
#pragma unroll
      for (int x = 0; x < TILE / 8 / WG_THREADS; ++x) {
        const int ch = threadIdx.x + x * WG_THREADS, row = ch >> 3;
        uint4* p = reinterpret_cast<uint4*>(gs + row * D + (((ch & 7) ^ (row & 7)) << 3));
        uint4 u = *p;
        uint32_t* w = reinterpret_cast<uint32_t*>(&u);
        const float r = fm[BQ + row];
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          const float2 f = unpack(w[y]);
          w[y] = pack(f.x * r, f.y * r);
        }
        *p = u;
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    wg_fence();
    mma_nn(dva, ea, gs, nb);
    mma_nn(dka, da, qs, nb);
    wg_commit();
    wg_wait<0>();
  }
  settle(dka);
  settle(dva);
  const float one[2] = {1.f, 1.f};
  store_acc_bf16(base(dk, st.dk, b, h), st.dk.n, dka, N, k0 + r0, t, one);
  store_acc_bf16(base(dv, st.dv, b, h), st.dv.n, dva, N, k0 + r0, t, one);
}

// K2's, K6's and K8's kernels (K1's rounding rule); K5's and K7's, under
// their own names, are in flash_attention_bwd.cu.
template <bool kRecompute>
__global__ void __launch_bounds__(WG_THREADS) attn_bwd_dq_bf16_kernel(BWD_DQ_PARAMS(bf16)) {
  attn_bwd_dq_bf16<kRecompute, false>(BWD_DQ_ARGS);
}

// Three blocks an SM (at most 168 registers a thread), which shared memory
// (67 KB a block) allows too.
__global__ void __launch_bounds__(WG_THREADS, 3)
attn_bwd_dkdv_bf16_kernel(BWD_DKDV_PARAMS(bf16)) {
  attn_bwd_dkdv_bf16<false>(BWD_DKDV_ARGS);
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

// The f32 bodies serve K5 as well: rounding to f32 is the identity, so K5's
// rule and K6's (o recomputed) are one function and differ only in the order
// of f32 operations.  K7 runs them with kLse: m = lse, r ≡ 1, and ds in the
// TPU kernel's order.
template <bool kRecompute, bool kLse = false>
__device__ __forceinline__ void attn_bwd_dq_f32(BWD_DQ_PARAMS(float)) {
  static_assert(!kLse || !kRecompute, "K7's rule reads the saved o");
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

  // the forward's row statistics (rows ≥ N: 0, never stored)
  if (threadIdx.x < BQ) {
    const int n = q0 + threadIdx.x;
    float* const fstats = const_cast<float*>(stats);
    row_m[threadIdx.x] = n < N ? stat(fstats, 0, B, K, N, b, h)[n] : 0.f;
    row_r[threadIdx.x] = n >= N ? 0.f : kLse ? 1.f : stat(fstats, 1, B, K, N, b, h)[n];
  }
  __syncthreads();

  if constexpr (kRecompute) {
    // first pass: o = (e·v)·r in f32 (the operand dtype is f32: e is not
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
  if (threadIdx.x < BQ && q0 + threadIdx.x < N)
    stat(delta_out, 0, B, K, N, b, h)[q0 + threadIdx.x] = row_delta[threadIdx.x];

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
        const float d = dp[i][j] - row_delta[r];
        dst[(tx * 4 + j) * LDT + r] = kLse ? e * d * scale : e * (d * (row_r[r] * scale));
      }
    }
    __syncthreads();
    f32_acc(dqa, dst, ks, tx, ty);
  }
  store_rows_f32(base(dq, st.dq, b, h), st.dq, dqa, N, q0, tx, ty);
}

template <bool kLse = false>
__device__ __forceinline__ void attn_bwd_dkdv_f32(BWD_DKDV_PARAMS(float)) {
  extern __shared__ float4 smem4[];
  float* kt = reinterpret_cast<float*>(smem4);   // [D][LDT]  k tile, transposed
  float* vt = kt + D * LDT;                      // [D][LDT]  v tile, transposed
  float* qt = vt + D * LDT;                      // [D][LDT]  q tile, transposed
  float* gt = qt + D * LDT;                      // [D][LDT]  do tile, transposed
  float* qs = gt + D * LDT;                      // [BQ][D]   q tile
  float* gs = qs + BQ * D;                       // [BQ][D]   do·r tile (kLse: do)
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
  const float* st_r = kLse ? nullptr : stat(fstats, 1, B, K, N, b, h);
  const float* st_delta = stat(const_cast<float*>(delta), 0, B, K, N, b, h);

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
      s_r[threadIdx.x] = !valid ? 0.f : kLse ? 1.f : st_r[n];
      s_delta[threadIdx.x] = valid ? st_delta[n] : 0.f;
    }
    stage_t(qt, qb, q0, N, st.q.n, st.q.d);
    stage_t(gt, gb, q0, N, st.g.n, st.g.d);
    stage_rows(qs, qb, q0, N, st.q.n, st.q.d);
    __syncthreads();                             // s_r is read below
    stage_rows(gs, gb, q0, N, st.g.n, st.g.d, kLse ? nullptr : s_r);
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
        const float d = dp[i][j] - s_delta[qi];
        es[qi * LDT + key] = e;
        dss[qi * LDT + key] = kLse ? e * d * scale : e * (d * (s_r[qi] * scale));
      }
    }
    __syncthreads();
    f32_acc(dva, es, gs, tx, ty);
    f32_acc(dka, dss, qs, tx, ty);
  }
  store_rows_f32(base(dk, st.dk, b, h), st.dk, dka, N, k0, tx, ty);
  store_rows_f32(base(dv, st.dv, b, h), st.dv, dva, N, k0, tx, ty);
}

template <bool kRecompute>
__global__ void __launch_bounds__(F32_THREADS) attn_bwd_dq_f32_kernel(BWD_DQ_PARAMS(float)) {
  attn_bwd_dq_f32<kRecompute>(BWD_DQ_ARGS);
}

__global__ void __launch_bounds__(F32_THREADS) attn_bwd_dkdv_f32_kernel(BWD_DKDV_PARAMS(float)) {
  attn_bwd_dkdv_f32<false>(BWD_DKDV_ARGS);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

constexpr size_t BF16_DQ_SMEM = SMEM_ALIGN + (2 + 2 * BWD_STAGES) * TILE * sizeof(bf16);
constexpr size_t BF16_DKDV_SMEM =
    SMEM_ALIGN + (2 + 2 * BWD_STAGES) * TILE * sizeof(bf16) + BWD_STAGES * 3 * BQ * sizeof(float);
constexpr size_t F32_DQ_SMEM = (4 * D * LDT + BK * D + BK * LDT) * sizeof(float);
constexpr size_t F32_DKDV_SMEM = (4 * D * LDT + 2 * BQ * D + 2 * BQ * LDT) * sizeof(float);

// One backward call: operands, outputs, the forward's row statistics and the
// delta scratch.
struct BwdCall {
  const void *q, *k, *v, *o, *g;
  void *dq, *dk, *dv;
  const float* stats;
  float* delta;
  int B, N, K;
  BwdViews st;
  float scale;
  cudaStream_t stream;
};

template <typename T>
using DqKernel = void (*)(const T*, const T*, const T*, const T*, const T*, T*, const float*,
                          float*, int, int, int, BwdViews, float);
template <typename T>
using DkdvKernel = void (*)(const T*, const T*, const T*, const T*, T*, T*, const float*,
                            const float*, int, int, int, BwdViews, float);

template <typename T>
cudaError_t launch_bwd_dq(const BwdCall& a, int threads, size_t smem, DqKernel<T> kernel) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BQ - 1) / BQ, a.K, a.B);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.o), static_cast<const T*>(a.g), static_cast<T*>(a.dq), a.stats,
      a.delta, a.B, a.N, a.K, a.st, a.scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd_dkdv(const BwdCall& a, int threads, size_t smem, DkdvKernel<T> kernel) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + BK - 1) / BK, a.K, a.B);
  kernel<<<grid, threads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.g), static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.stats, a.delta,
      a.B, a.N, a.K, a.st, a.scale);
  return cudaGetLastError();
}

// The dq kernel, or the dk/dv kernel, of a pair in the call's dtype (0 f32,
// 1 bf16).
inline cudaError_t launch_dq(const BwdCall& a, int dtype, DqKernel<float> f32,
                             DqKernel<bf16> b16) {
  if (dtype == 0) return launch_bwd_dq<float>(a, F32_THREADS, F32_DQ_SMEM, f32);
  return launch_bwd_dq<bf16>(a, WG_THREADS, BF16_DQ_SMEM, b16);
}

inline cudaError_t launch_dkdv(const BwdCall& a, int dtype, DkdvKernel<float> f32,
                               DkdvKernel<bf16> b16) {
  if (dtype == 0) return launch_bwd_dkdv<float>(a, F32_THREADS, F32_DKDV_SMEM, f32);
  return launch_bwd_dkdv<bf16>(a, WG_THREADS, BF16_DKDV_SMEM, b16);
}

// K2's or K6's dq kernel, then its dk/dv kernel.
template <bool kRecompute>
cudaError_t launch_bwd(const BwdCall& a, int dtype, bool dq, bool dkdv) {
  cudaError_t err = cudaSuccess;
  if (dq)
    err = launch_dq(a, dtype, attn_bwd_dq_f32_kernel<kRecompute>,
                    attn_bwd_dq_bf16_kernel<kRecompute>);
  if (dkdv && err == cudaSuccess)
    err = launch_dkdv(a, dtype, attn_bwd_dkdv_f32_kernel, attn_bwd_dkdv_bf16_kernel);
  return err;
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
