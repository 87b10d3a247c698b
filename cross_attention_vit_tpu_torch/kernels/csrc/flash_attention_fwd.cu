// Fused self-attention forward on separate or stacked q, k, v operands, for
// Hopper (sm_90a).
//
// Replaces three TPU kernels of cross_attention_vit_tpu/kernels/flash_attention.py.
// Two compute the same function, _tn_fwd_math (:593-615):
//
//   K1  _attn_kernel_qkv_tn (defined at :759, launched by pallas_call at :796
//       in _flash_forward_qkv_tn), on one stacked qkv — the model's path;
//   K6  _attn_kernel_tn (defined at :587, launched at :711 in
//       _flash_forward_tn), on separate q, k, v — the public flash_attention_tn.
//
// For every (batch b, head h):
//
//     s   = q·kᵀ · scale                       f32 accumulation
//     m   = rowmax(s);  e = exp(s − m);  r = 1 / Σ_j e
//     out = (e cast to the operand dtype)·v   f32 accumulation, then × r
//
// The normalisation comes after the AV product, as in the TPU kernels.  The
// third rounds elsewhere:
//
//   K5  _attn_kernel (defined at :109, launched at :218 in _flash_forward,
//       the public flash_attention at N <= 1040) on separate q, k, v — the
//       int8+attn serving path:
//
//     p   = e · r                              f32 (jax.nn.softmax divides:
//                                              e / Σe; within 2 ulp of e·r)
//     out = (p cast to the operand dtype)·v   f32 accumulation, not rescaled
//
// One body serves both rules (`kNormalised`): K5's pass 1 keeps each row's
// sum online beside its max (the sum rescaled when the max grows: one
// exponential per score more than K1's pass 1), and its pass 2 rounds p
// instead of e and stores the accumulator as it is.  A three-pass form (max,
// then sum, then p·v) would spend the same exponentials and one more score
// product.  In f32 the rules are one function (rounding to f32 is the
// identity), so K5's f32 kernel is K1's body under K5's name.
//
// Head dim D = 64, a compile-time constant: every configuration of the repo
// has it (hidden/heads = 1024/16, 768/12, 192/3).
//
// Layout.  Every operand is a (B, K, N, D) view given by its pointer and its
// (b, h, n, d) strides in elements, so one kernel serves every TPU kernel:
// K1 reads q, k, v as three views of the (B, N, 3, K, D) tensor that
// x @ to_qkv.weightᵀ produces and writes (B, N, K, D), the (B, N, H) input of
// the output projection; K5 reads the same views of the int8 QKV
// projection's output; K6 reads three tensors and writes a (B, K, N, D)
// tensor that the wrapper returns as a (B, K, D, N) view.  The bf16 kernel
// copies 16-byte chunks, so its operands need a unit head-dim stride and
// 16-byte aligned rows; the K6 wrapper hands it (B, K, N, D) copies of
// (B, K, D, N) operands that lack them (a TPU layout choice).  With a stats
// pointer the kernel also writes each row's (m, r) for the backward
// (hopper_tiles.cuh, `stat`), under either rule.
//
// Bound.  At the serving path's largest bucket (B=8, K=16, D=64, N=513, bf16)
// one launch must read 25.2 MB of q, k, v and write 8.4 MB of output: 10.0 us
// at 3.35 TB/s.  Its two necessary products are 4·B·K·N²·D = 8.62 GFLOP,
// 8.7 us at the 989 TFLOP/s bf16 tensor-core peak, and its one exponential
// per score 33.7 M, 8.6 us at about 3.9 T/s.  So the bound is about 10 us
// (bytes).  The kernel runs three products (s twice) and one exponential
// per score (K5: two).
//
// Design.  A 513×513 f32 score matrix (1.05 MB) does not fit in the 227 KB of
// shared memory a block may use, so the TPU's one-block-per-(b, h) design
// cannot carry over.  Here one block owns a 64-row query tile of one (b, h)
// and loops over 64-key tiles of k and v staged in shared memory.  Two passes
// keep the TPU kernel's rounding order: pass 1 finds each row's max (no
// exponential; K5 also the sum), pass 2 recomputes the scores, forms
// e = exp(s − m) with the FINAL row max, sums it in f32 for r and rounds it
// to the operand dtype before it meets v (K5 rounds e·r; the bf16 path
// evaluates exp(scale·s − m) as one FMA and an exp2, which differs from exp
// in the last bits of f32).  Rows ≥ N are staged as zeros, key columns ≥ N
// are masked, and no store leaves [0, N).
//
//   bf16 (the serving path): one warpgroup (128 threads) per block runs both
//   products as wgmma m64nNk16 (bf16 in, f32 accumulate): s = q·kᵀ with q and
//   k read K-major from shared memory, o += e·v with e packed from the score
//   accumulators into registers (the A operand) and v read transposed
//   (MN-major B) from its one row-major tile.  Tiles arrive by cp.async into
//   a ring of three slots, two steps ahead of the products, one barrier a
//   step.  The one-row last key tile (N = 513, 1025) costs 16 keys, not 64:
//   an m64n16 score product and one 16-deep e·v step (a longer ragged tail
//   runs 64 wide, masked, and as many 16-deep steps as it needs); the query
//   side stays one 64-row tile.  Grid (⌈N/64⌉, K, B): 1152 blocks at B=8
//   K=16 N=513, 8.7 per SM on 132 SMs; 57 KB of shared memory a block (q
//   and three slots of k and v) admits three blocks an SM, and 116
//   registers a thread (ptxas -v, sm_90a, no spills) four.
//   f32: scalar f32 FMAs on the CUDA cores (256 threads, 4×4 register tiles),
//   element-wise staging, any strides.  f32 operands keep full f32
//   precision, as Precision.HIGHEST did on the TPU, so no TF32.  Capped at
//   the 67 TFLOP/s f32 rate; f32 is not the serving path.
//
// Not yet done (later work): TMA with a producer warp, more than one
// consumer warpgroup per block, and one pass with online rescaling (each
// 64-row query block re-reads its head's k twice and v once from L2).

#include "hopper_tiles.cuh"

namespace {

struct Views {
  View q, k, v, o;
};

// ---------------------------------------------------------------------------
// bf16: wgmma, tiles by cp.async
// ---------------------------------------------------------------------------

constexpr int FWD_STAGES = 3;   // ring slots of (k, v) tile pairs

// The kernels' parameters: q, k, v and out views, the row statistics (or
// null), the sizes, the views' strides and the softmax scale.
#define FWD_PARAMS(T)                                                                          \
  const T *__restrict__ q, const T *__restrict__ k, const T *__restrict__ v,                    \
      T *__restrict__ out, float *__restrict__ stats, int B, int N, int K, Views st, float scale
#define FWD_ARGS q, k, v, out, stats, B, N, K, st, scale

// The bf16 body: one warpgroup per 64-row query tile of one (b, h).  Steps
// 0 .. tiles−1 are pass 1 (k tiles), tiles .. 2·tiles−1 pass 2 (k and v
// tiles); the copies run FWD_STAGES − 1 steps ahead of the products.
// kNormalised selects K5's rounding rule over K1's (see the header).
template <bool kNormalised>
__device__ __forceinline__ void attn_fwd_bf16(FWD_PARAMS(bf16)) {
  extern __shared__ float4 smem4[];
  bf16* qs = aligned_smem(smem4);              // q tile
  bf16* ring = qs + TILE;                      // [stage][k, v] tiles

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = base(q, st.q, b, h);
  const bf16* kb = base(k, st.k, b, h);
  const bf16* vb = base(v, st.v, b, h);
  const int tiles = (N + BK - 1) / BK, steps = 2 * tiles;
  // exp(scale·s − m) = exp2(c·s − m·log2 e) for unscaled scores s: one FMA
  // and one ex2 per score (scale > 0 keeps the maxima's order)
  const float c = scale * LOG2E;

  auto issue = [&](int i) {
    bf16* stage = ring + (i % FWD_STAGES) * 2 * TILE;
    const int k0 = (i % tiles) * BK;
    load_tile_async(stage, kb, k0, N, st.k.n);
    if (i >= tiles) load_tile_async(stage + TILE, vb, k0, N, st.v.n);
  };
  load_tile_async(qs, qb, q0, N, st.q.n);       // joins step 0's group
  ring_begin<FWD_STAGES>(steps, issue);

  float mu[2] = {-INFINITY, -INFINITY};        // pass 1: row max of the unscaled scores
  float cm[2], l[2] = {0.f, 0.f}, r[2];        // m·log2 e, Σ e in f32, 1 / Σ e
  float s[32], o[32];
  zero32(o);
  for (int i = 0; i < steps; ++i) {
    ring_step<FWD_STAGES>(i, steps, issue);
    const bf16* ks = ring + (i % FWD_STAGES) * 2 * TILE;
    const int k0 = (i % tiles) * BK;
    const int nb = min(BK, N - k0 + 15) / 16;   // 16-key blocks holding a key < N
    const bool full = k0 + BK <= N;
    wg_fence();
    mma_tn_n(s, qs, ks, nb);
    wg_commit();
    wg_wait<0>();
    settle(s);
    if (i < tiles) {
      if constexpr (kNormalised) {
        // K5: the max and Σ exp(s − max) together, online — the quad's max
        // over this tile, then this thread's sum rescaled when the max grows
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (full || (j < 2 * nb && k0 + 8 * j + 2 * t + e < N))
                mx = fmaxf(mx, s[4 * j + 2 * half + e]);
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mn = fmaxf(mu[half], mx);   // finite: key k0 < N is valid
          const float cmn = mn * c;
          float sum = 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (full || (j < 2 * nb && k0 + 8 * j + 2 * t + e < N))
                sum += exp2f(fmaf(s[4 * j + 2 * half + e], c, -cmn));
          l[half] = l[half] * exp2f(fmaf(mu[half], c, -cmn)) + sum;
          mu[half] = mn;
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int x = 0; x < 4; ++x)
            if (full || (j < 2 * nb && k0 + 8 * j + 2 * t + (x & 1) < N))
              mu[x >> 1] = fmaxf(mu[x >> 1], s[4 * j + x]);
      }
      if (i == tiles - 1) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if constexpr (kNormalised) {
            l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
            l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
            r[half] = 1.f / l[half];
            cm[half] = mu[half] * c;
          } else {
            mu[half] = fmaxf(mu[half], __shfl_xor_sync(0xffffffffu, mu[half], 1));
            mu[half] = fmaxf(mu[half], __shfl_xor_sync(0xffffffffu, mu[half], 2));
            cm[half] = mu[half] * scale * LOG2E;  // m = scale·max, the stats' unit
          }
        }
      }
    } else {
      // e = exp(s − m) with the final max; K1 sums it in f32 and rounds it,
      // K5 rounds p = e·r
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const bool valid = full || (j < 2 * nb && k0 + 8 * j + 2 * t + (x & 1) < N);
          const float e = valid ? exp2f(fmaf(s[4 * j + x], c, -cm[x >> 1])) : 0.f;
          if constexpr (kNormalised) {
            s[4 * j + x] = e * r[x >> 1];
          } else {
            l[x >> 1] += e;
            s[4 * j + x] = e;
          }
        }
      uint32_t a[4][4];
      pack_a(a, s);
      wg_fence();
      mma_nn(o, a, ks + TILE, nb);
      wg_commit();
      wg_wait<0>();
    }
  }
  settle(o);

  if constexpr (!kNormalised) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
      l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
      r[half] = 1.f / l[half];
    }
  }
  const float one[2] = {1.f, 1.f};              // K5's out is already normalised
  const int r0 = warp * 16 + g;
  store_acc_bf16(base(out, st.o, b, h), st.o.n, o, N, q0 + r0, t, kNormalised ? one : r);
  if (stats != nullptr && t == 0) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int n = q0 + r0 + 8 * half;
      if (n < N) {
        stat(stats, 0, B, K, N, b, h)[n] = mu[half] * scale;
        stat(stats, 1, B, K, N, b, h)[n] = r[half];
      }
    }
  }
}

// K1 and K6, then K5: the two rules under their own names, so that a
// profile never books one's time to the other.
__global__ void __launch_bounds__(WG_THREADS) attn_fwd_qkv_bf16_kernel(FWD_PARAMS(bf16)) {
  attn_fwd_bf16<false>(FWD_ARGS);
}
__global__ void __launch_bounds__(WG_THREADS) attn_single_fwd_bf16_kernel(FWD_PARAMS(bf16)) {
  attn_fwd_bf16<true>(FWD_ARGS);
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs on the CUDA cores (no TF32)
// ---------------------------------------------------------------------------

// s[i][j] = scale · Σ_d q[ty·4+i, d] k[tx·4+j, d], −inf for key columns ≥ N.
__device__ __forceinline__ void f32_scores(float s[4][4], const float* qt, const float* kt,
                                           int tx, int ty, int k0, int N, float scale) {
  f32_tn(s, qt, kt, tx, ty);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool valid = k0 + tx * 4 + j < N;
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][j] = valid ? s[i][j] * scale : -INFINITY;
  }
}

// The f32 body of both rules: rounding to f32 is the identity, so K1's
// (e·v)·r and K5's (e·r)·v are one function and differ only in the order of
// f32 operations.
__device__ __forceinline__ void attn_fwd_f32(FWD_PARAMS(float)) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][LDT]  q tile, transposed
  float* kt = qt + D * LDT;                      // [D][LDT]  k tile, transposed
  float* vs = kt + D * LDT;                      // [BK][D]   v tile
  float* pt = vs + BK * D;                       // [BK][LDT] e, transposed
  __shared__ float row_m[BQ], row_l[BQ];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = base(q, st.q, b, h);
  const float* kb = base(k, st.k, b, h);
  const float* vb = base(v, st.v, b, h);
  const int tiles = (N + BK - 1) / BK;

  stage_t(qt, qb, q0, N, st.q.n, st.q.d);

  // pass 1: each thread keeps the max over its own columns
  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY;
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    stage_t(kt, kb, k0, N, st.k.n, st.k.d);
    __syncthreads();
    float s[4][4];
    f32_scores(s, qt, kt, tx, ty, k0, N, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      m[i] = fmaxf(m[i], fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3])));
  }
  // over the 16 threads (lanes differing in bits 0-3) sharing a row
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], off));
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) row_m[ty * 4 + i] = m[i];
  }

  // pass 2: e with the final row max, summed and accumulated against v
  float acc[4][4], l[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[i][c] = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    stage_t(kt, kb, k0, N, st.k.n, st.k.d);
    stage_rows(vs, vb, k0, N, st.v.n, st.v.d);
    __syncthreads();
    float s[4][4];
    f32_scores(s, qt, kt, tx, ty, k0, N, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float mi = row_m[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float e = exp_shift(s[i][j], mi);
        l[i] += e;
        pt[(tx * 4 + j) * LDT + ty * 4 + i] = e;
      }
    }
    __syncthreads();
    f32_acc(acc, pt, vs, tx, ty);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) row_l[ty * 4 + i] = l[i];
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    if (n >= N) continue;
    const float r = 1.f / row_l[ty * 4 + i];
    float* o = base(out, st.o, b, h) + n * st.o.n;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[(tx * 4 + j) * st.o.d] = acc[i][j] * r;
  }
  if (stats != nullptr && threadIdx.x < BQ && q0 + threadIdx.x < N) {
    const int n = q0 + threadIdx.x;
    stat(stats, 0, B, K, N, b, h)[n] = row_m[threadIdx.x];
    stat(stats, 1, B, K, N, b, h)[n] = 1.f / row_l[threadIdx.x];
  }
}

__global__ void __launch_bounds__(F32_THREADS) attn_fwd_qkv_f32_kernel(FWD_PARAMS(float)) {
  attn_fwd_f32(FWD_ARGS);
}
__global__ void __launch_bounds__(F32_THREADS) attn_single_fwd_f32_kernel(FWD_PARAMS(float)) {
  attn_fwd_f32(FWD_ARGS);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch(void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, int, Views,
                                  float),
                   int threads, size_t smem, const void* q, const void* k, const void* v,
                   void* out, float* stats, int B, int N, int K, const Views& st, float scale,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, K, B);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(out), stats,
                                          B, N, K, st, scale);
  return cudaGetLastError();
}

constexpr size_t BF16_SMEM = SMEM_ALIGN + (1 + 2 * FWD_STAGES) * TILE * sizeof(bf16);
constexpr size_t F32_SMEM = (2 * D * LDT + BK * D + BK * LDT) * sizeof(float);

// single: K5's kernels, else K1's (K6's).
cudaError_t dispatch(bool single, const void* q, const void* k, const void* v, void* out,
                     void* stats, int dtype, int B, int N, int K, const Views& st, float scale,
                     void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* fs = static_cast<float*>(stats);
  if (dtype == 0)
    return launch<float>(single ? attn_single_fwd_f32_kernel : attn_fwd_qkv_f32_kernel,
                         F32_THREADS, F32_SMEM, q, k, v, out, fs, B, N, K, st, scale, s);
  return launch<bf16>(single ? attn_single_fwd_bf16_kernel : attn_fwd_qkv_bf16_kernel,
                      WG_THREADS, BF16_SMEM, q, k, v, out, fs, B, N, K, st, scale, s);
}

}  // namespace

// K1.  dtype: 0 = float32, 1 = bfloat16.  D must be 64.  qkv is
// (B, N, 3, K, D) and out (B, N, K, D) with a unit head-dim stride, strides in
// elements; bf16 rows 16-byte aligned.  stats: a (2, B, K, N) f32 tensor for
// the row statistics (m, r) a backward reads, or null when none follows.
// Returns a cudaError_t (0 on success); the launch does not synchronise.
extern "C" int flash_attention_qkv_fwd(const void* qkv, void* out, void* stats, int dtype, int B,
                                       int N, int K, int head_dim, long long sb, long long sn,
                                       long long ss, long long sh, long long sd, long long ob,
                                       long long on, long long oh, long long od, float scale,
                                       void* stream, int device) {
  if (head_dim != D || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const View qv{sb, sh, sn, sd};
  const Views st{qv, qv, qv, {ob, oh, on, od}};
  const size_t esize = dtype == 0 ? sizeof(float) : sizeof(bf16);
  const char* q = static_cast<const char*>(qkv);
  return dispatch(false, q, q + ss * esize, q + 2 * ss * esize, out, stats, dtype, B, N, K, st,
                  scale, stream, device);
}

// K6 and K5 on separate operands: q, k, v and out are (B, K, N, D) views
// given by their (b, h, n, d) strides in elements (bf16: unit head-dim
// stride and 16-byte rows, which the K6 wrapper ensures by copying and the
// K5 wrapper checks; out: unit head-dim stride); stats as K1's.
#define SEPARATE_FWD_PARAMS                                                                    \
  const void *q, const void *k, const void *v, void *out, void *stats, int dtype, int B, int N, \
      int K, int head_dim, long long qb, long long qh, long long qn, long long qd, long long kb, \
      long long kh, long long kn, long long kd, long long vb, long long vh, long long vn,      \
      long long vd, long long ob, long long oh, long long on, long long od, float scale,       \
      void *stream, int device
#define SEPARATE_FWD_VIEWS                                                                     \
  Views { {qb, qh, qn, qd}, {kb, kh, kn, kd}, {vb, vh, vn, vd}, {ob, oh, on, od} }

// K6: K1's rule.
extern "C" int flash_attention_tn_fwd(SEPARATE_FWD_PARAMS) {
  if (head_dim != D || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  return dispatch(false, q, k, v, out, stats, dtype, B, N, K, SEPARATE_FWD_VIEWS, scale, stream,
                  device);
}

// K5: p = e·r rounded before p·v, out not rescaled.
extern "C" int flash_attention_single_fwd(SEPARATE_FWD_PARAMS) {
  if (head_dim != D || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  return dispatch(true, q, k, v, out, stats, dtype, B, N, K, SEPARATE_FWD_VIEWS, scale, stream,
                  device);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
