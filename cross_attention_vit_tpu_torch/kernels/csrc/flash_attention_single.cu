// Single-block self-attention forward on separate q, k, v, for Hopper (sm_90a).
//
// Replaces the TPU kernel cross_attention_vit_tpu/kernels/flash_attention.py
// ::_attn_kernel (defined at :109, launched by pallas_call at :218 in
// _flash_forward, the branch for N <= _SINGLE_BLOCK_MAX = 1040).  It computes
// that kernel's function for every (batch b, head h):
//
//     s   = q·kᵀ · scale                              f32 accumulation
//     p   = exp(s − rowmax(s)) / Σ_j exp(s − rowmax)  f32 (jax.nn.softmax)
//     out = (p cast to the operand dtype)·v          f32 accumulation, cast
//
// The softmax is normalised by a division BEFORE p is rounded, and nothing
// multiplies the AV product afterwards.  K1 (flash_attention_fwd.cu) rounds
// the unnormalised e and multiplies by 1/Σe after AV; K7
// (flash_attention_stream.cu) rounds p with the running max.  The three
// agree only to bf16 rounding, so K5 is its own kernel.
//
// Layout.  q, k, v are (B, K, N, D) operands of any strides (in elements):
// the int8+attn serving path passes views of the stacked (B, N, 3, K, D)
// output of the quantized QKV projection.  out is written through its
// strides (the wrapper allocates it in (B, N, K, D) order, the output
// projection's input).  Head dim D = 64.
//
// Bound.  At the ModelCross int8+attn serving shape (B=8, K=16, N=513, D=64,
// bf16) one launch must read q, k, v and write out: 4·B·N·K·D·2 B = 33.6 MB,
// 10.0 us at 3.35 TB/s; its two products are 4·B·K·N²·D = 8.62 GFLOP, 8.7 us
// at the 989 TFLOP/s bf16 tensor-core peak, so bytes bound it (10.0 us).  At
// the 2-stream ModelVIT's N = 1025 the products are 34.4 GFLOP (34.8 us) and
// operations bound it.
//
// Design.  The (N, N) f32 scores of one (b, h) do not fit in 227 KB of shared
// memory (1.05 MB at N = 513), so one block owns a 64-row query tile and
// walks the 64-key tiles twice: pass 1 finds each row's max m and sum
// l = Σ exp(s − m) (online within the pass); pass 2 recomputes the scores,
// forms p = exp(s − m) / l, rounds it and accumulates p·v.  An online
// one-pass softmax would round p before its row is normalised, which is not
// this kernel's function.  Ragged N: key columns ≥ N score −inf and rows ≥ N
// of q, k and v are staged as zeros; nothing is stored for rows ≥ N.
//
//   bf16 (the serving path): 4 warps, each owning 16 query rows, run both
//   products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//   accumulate); p goes from the score accumulators to the A operand of p·v
//   in registers.  exp(scale·(s − m)) is one FMA and an exp2 on the unscaled
//   scores (scale > 0 keeps the row order).  The next tile's 16-byte loads
//   are issued into registers before this tile's products.  Needs a unit
//   head-dim stride and 16-byte rows (the wrapper checks).
//   f32: scalar f32 FMAs on the CUDA cores (256 threads, 4×4 register
//   tiles), any strides, full f32 (no TF32: JAX used Precision.HIGHEST).
//
// Not yet done (later work): wgmma, TMA, a one-pass form that keeps the
// division (the row sums of pass 1 written by a cheaper kernel).

#include "attention_tiles.cuh"

namespace {

struct Views {
  View q, k, v, o;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

// s = q·kᵀ (unscaled) for this warp's 16 rows and the 64 keys of `ks`; keys
// ≥ N score −inf
__device__ __forceinline__ void scores(float s[BK / 8][4], const uint32_t qf[D / 16][4],
                                       const bf16* ks, int g, int t, int k0, int N) {
  mma_nt(s, qf, ks, g, t);
  if (k0 + BK > N) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + j * 8 + 2 * t + (e & 1) >= N) s[j][e] = -INFINITY;
  }
}

// p = exp2(c·s − cm) / l for scores s[i], s[i + 1] of one row, rounded to
// bf16 and packed
__device__ __forceinline__ uint32_t pack_p(const float s[4], int i, float c, float cm, float l) {
  return pack(exp2f(fmaf(s[i], c, -cm)) / l, exp2f(fmaf(s[i + 1], c, -cm)) / l);
}

__global__ void __launch_bounds__(MMA_THREADS)
attn_single_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out, int N,
                            Views st, float scale) {
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);   // [BQ][LD]  q tile
  bf16* ks = qs + BQ * LD;                     // [BK][LD]  k tile
  bf16* vt = ks + BK * LD;                     // [D][LDV]  v tile, transposed

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;       // mma fragment coordinates
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = base(q, st.q, b, h);
  const bf16* kb = base(k, st.k, b, h);
  const bf16* vb = base(v, st.v, b, h);
  const int tiles = (N + BK - 1) / BK;
  const float c = scale * LOG2E;               // exp(scale·x) = exp2(c·x)
  const int r0 = warp * 16 + g;

  Tile kr, vr;
  kr.load_rows(qb, q0, N, st.q.n);
  kr.store_rows(qs, LD);
  kr.load_rows(kb, 0, N, st.k.n);
  __syncthreads();
  uint32_t qf[D / 16][4];                      // this warp's q as A fragments
  load_a(qf, qs, r0, t);

  // pass 1: row max (unscaled) and sum; a quad of threads shares a row.
  // Every tile holds a valid key, so m is finite after the first tile
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    kr.store_rows(ks, LD);
    __syncthreads();
    if (tile + 1 < tiles) {
      kr.load_rows(kb, k0 + BK, N, st.k.n);    // in flight during the products
    } else {
      kr.load_rows(kb, 0, N, st.k.n);          // pass 2's first tile
      vr.load_cols(vb, 0, N, st.v.n);
    }
    float s[BK / 8][4];
    scores(s, qf, ks, g, t, k0, N);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[half], mx);
      const float cm = c * mn;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
        sum += exp2f(fmaf(s[j][2 * half], c, -cm)) + exp2f(fmaf(s[j][2 * half + 1], c, -cm));
      l[half] = l[half] * exp2f(fmaf(m[half], c, -cm)) + sum;
      m[half] = mn;
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
  }

  // pass 2: p = exp(s − m) / l rounded to bf16, o += p·v on the tensor cores
  const float cm[2] = {c * m[0], c * m[1]};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    kr.store_rows(ks, LD);
    vr.store_transposed(vt, LDV);
    __syncthreads();
    if (tile + 1 < tiles) {
      kr.load_rows(kb, k0 + BK, N, st.k.n);
      vr.load_cols(vb, k0 + BK, N, st.v.n);
    }
    float s[BK / 8][4];
    scores(s, qf, ks, g, t, k0, N);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // the C fragments of score tiles 2kk and 2kk+1 are the A fragment of
      // keys [16kk, 16kk + 16)
      const uint32_t a[4] = {pack_p(s[2 * kk], 0, c, cm[0], l[0]),
                             pack_p(s[2 * kk], 2, c, cm[1], l[1]),
                             pack_p(s[2 * kk + 1], 0, c, cm[0], l[0]),
                             pack_p(s[2 * kk + 1], 2, c, cm[1], l[1])};
      mma_acc(o, a, vt, kk, g, t);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = q0 + r0 + 8 * half;
    if (n >= N) continue;
    bf16* orow = base(out, st.o, b, h) + n * st.o.n;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * half], o[j][2 * half + 1]);
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs on the CUDA cores (no TF32)
// ---------------------------------------------------------------------------

// s[i][j] = scale · Σ_d q[ty·4+i, d] k[tx·4+j, d], −inf for key columns ≥ N
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

__global__ void __launch_bounds__(F32_THREADS)
attn_single_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out, int N,
                           Views st, float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][LDT]  q tile, transposed
  float* kt = qt + D * LDT;                      // [D][LDT]  k tile, transposed
  float* vs = kt + D * LDT;                      // [BK][D]   v tile
  float* pt = vs + BK * D;                       // [BK][LDT] p, transposed
  __shared__ float row_m[BQ], row_l[BQ];

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = base(q, st.q, b, h);
  const float* kb = base(k, st.k, b, h);
  const float* vb = base(v, st.v, b, h);
  const int tiles = (N + BK - 1) / BK;

  stage_t(qt, qb, q0, N, st.q.n, st.q.d);

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
    f32_scores(s, qt, kt, tx, ty, k0, N, scale);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
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

  // pass 2: p = exp(s − m) / l, accumulated against v
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
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
      const float mi = row_m[ty * 4 + i], li = row_l[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) pt[(tx * 4 + j) * LDT + ty * 4 + i] = exp_shift(s[i][j], mi) / li;
    }
    __syncthreads();
    f32_acc(acc, pt, vs, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    if (n >= N) continue;
    float* orow = base(out, st.o, b, h) + n * st.o.n;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[(tx * 4 + j) * st.o.d] = acc[i][j];
  }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

constexpr size_t BF16_SMEM = ((BQ + BK) * LD + D * LDV) * sizeof(bf16);
constexpr size_t F32_SMEM = (2 * D * LDT + BK * D + BK * LDT) * sizeof(float);

template <typename T>
cudaError_t launch(void (*kernel)(const T*, const T*, const T*, T*, int, Views, float),
                   int threads, size_t smem, const void* q, const void* k, const void* v,
                   void* out, int B, int N, int K, const Views& st, float scale,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, K, B);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(out), N,
                                          st, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 64.  Each operand's strides
// are (b, h, n, d) of its (B, K, N, D) view, in elements.  Returns a
// cudaError_t (0 on success); the launch does not synchronise.
extern "C" int flash_attention_single_fwd(
    const void* q, const void* k, const void* v, void* out, int dtype, int B, int N, int K,
    int head_dim, long long qb, long long qh, long long qn, long long qd, long long kb,
    long long kh, long long kn, long long kd, long long vb, long long vh, long long vn,
    long long vd, long long ob, long long oh, long long on, long long od, float scale,
    void* stream, int device) {
  if (head_dim != D || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Views st{{qb, qh, qn, qd}, {kb, kh, kn, kd}, {vb, vh, vn, vd}, {ob, oh, on, od}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(attn_single_fwd_f32_kernel, F32_THREADS, F32_SMEM, q, k, v, out, B, N,
                         K, st, scale, s);
  return launch<bf16>(attn_single_fwd_bf16_kernel, MMA_THREADS, BF16_SMEM, q, k, v, out, B, N,
                      K, st, scale, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
