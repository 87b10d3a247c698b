// Fused self-attention forward on separate or stacked q, k, v operands, for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of cross_attention_vit_tpu/kernels/flash_attention.py
// that compute the same function, _tn_fwd_math (:593-615):
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
// The normalisation comes after the AV product, as in the TPU kernels.
//
// Head dim D = 64, a compile-time constant: every configuration of the repo
// has it (hidden/heads = 1024/16, 768/12, 192/3).
//
// Layout.  Every operand is a (B, K, N, D) view given by its pointer and its
// (b, h, n, d) strides in elements, so one kernel serves both TPU kernels:
// K1 reads q, k, v as three views of the (B, N, 3, K, D) tensor that
// x @ to_qkv.weightᵀ produces and writes (B, N, K, D), the (B, N, H) input of
// the output projection; K6 reads three tensors of any strides and writes a
// (B, K, N, D) tensor that the wrapper returns as a (B, K, D, N) view.  The
// TPU kernels took (B, K, D, N) operands, a TPU layout choice; such an
// operand is contiguous along N, its rows are not 16-byte aligned when N is
// not a multiple of 8, and the bf16 path then stages it one element at a
// time (TileAny, chosen by the wrapper) instead of in 16-byte chunks.
//
// Bound.  At the serving path's largest bucket (B=8, K=16, D=64, N=513, bf16)
// one launch must read 25.2 MB of q, k, v and write 8.4 MB of output: 10.0 us
// at 3.35 TB/s.  It does 4·B·K·N²·D = 8.62 GFLOP: 8.7 us at the 989 TFLOP/s
// bf16 tensor-core peak.  So the bound is about 10 us (bytes).
//
// Design.  A 513×513 f32 score matrix (1.05 MB) does not fit in the 227 KB of
// shared memory a block may use, so the TPU's one-block-per-(b, h) design
// cannot carry over.  Here one block owns a 64-row query tile of one (b, h)
// and loops over 64-key tiles of k and v staged in shared memory.  Two passes
// keep the TPU kernel's rounding order: pass 1 finds each row's max and sum
// (online within the pass), pass 2 recomputes the scores, rounds
// e = exp(s − m) with the FINAL row max to the operand dtype and accumulates
// e·v in f32 (the bf16 path evaluates exp(scale·(s − m)) as one FMA and an
// exp2, which differs from exp in the last bits of f32).  The ragged last
// tile (513 = 8·64 + 1) is masked: key columns ≥ N score −inf, rows ≥ N of
// q, k and v are staged as zeros, and no load or store leaves [0, N).
//
//   bf16 (the serving path): 4 warps, each owning 16 query rows, run both
//   products on the tensor cores with mma.sync m16n8k16 (bf16 in, f32
//   accumulate).  The score accumulators are re-packed in registers as the
//   A operand of the e·v product (the FlashAttention-2 register layout), so
//   e never touches shared memory.  Tiles move in 16-byte chunks (Tile: unit
//   head-dim stride, 16-byte aligned rows) or element by element (TileAny:
//   any strides), and the next tile's loads are issued into registers before
//   this tile's products, so their latency hides behind the tensor cores.
//   f32: scalar f32 FMAs on the CUDA cores (256 threads, 4×4 register tiles),
//   element-wise staging, any strides.  f32 operands keep full f32
//   precision, as Precision.HIGHEST did on the TPU, so no TF32.  Capped at
//   the 67 TFLOP/s f32 rate; f32 is not the serving path.
//
// Not yet done (later work): wgmma, TMA, warp specialisation, and one pass
// with online rescaling (each 64-row query block re-reads its head's k twice
// and v once from L2).

#include "attention_tiles.cuh"

namespace {

struct Views {
  View q, k, v, o;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

// e = exp2(c·s − cm) for scores s[i], s[i + 1], rounded to bf16 and packed
__device__ __forceinline__ uint32_t pack_e(const float s[4], int i, float c, float cm) {
  __nv_bfloat162 v = __floats2bfloat162_rn(exp2f(fmaf(s[i], c, -cm)),
                                           exp2f(fmaf(s[i + 1], c, -cm)));
  return *reinterpret_cast<uint32_t*>(&v);
}

// s = q·kᵀ (unscaled) for this warp's 16 rows and the 64 keys in `ks`: 8
// tiles of 8 keys; thread (g, t) holds rows g and g+8, keys 8j + 2t + {0, 1}.
// Keys ≥ N (only in the last tile) score −inf.
__device__ __forceinline__ void mma_scores(float s[BK / 8][4], const uint32_t qf[D / 16][4],
                                           const bf16* ks, int g, int t, int k0, int N) {
#pragma unroll
  for (int j = 0; j < BK / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const bf16* kr = ks + (j * 8 + g) * LD + kk * 16 + 2 * t;
      mma_bf16(s[j], qf[kk], ld_pair(kr), ld_pair(kr + 8));
    }
  if (k0 + BK > N) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (k0 + j * 8 + 2 * t + (c & 1) >= N) s[j][c] = -INFINITY;
  }
}

template <class TileT>
__global__ void __launch_bounds__(MMA_THREADS)
attn_fwd_qkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, bf16* __restrict__ out, int N, Views st,
                         float scale) {
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
  // exp(scale·(s − m)) = exp2(c·s − c·m): one FMA and one ex2 per score; row
  // maxima are taken on the unscaled scores (scale > 0 keeps the order)
  const float c = scale * LOG2E;

  TileT kr, vr;
  kr.load_rows(qb, q0, N, st.q.n, st.q.d);
  kr.store_rows(qs, LD);
  kr.load_rows(kb, 0, N, st.k.n, st.k.d);
  __syncthreads();
  uint32_t qf[D / 16][4];                      // this warp's q as A fragments
  const int r0 = warp * 16 + g;
  load_a(qf, qs, r0, t);

  // pass 1: row max and sum; m is shared by the 4 threads (a quad) of a row.
  // m starts at −inf; exp2 of −inf is 0, and every tile has a valid key, so
  // no guard is needed
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    kr.store_rows(ks, LD);
    __syncthreads();
    if (tile + 1 < tiles) {
      kr.load_rows(kb, k0 + BK, N, st.k.n, st.k.d);   // in flight during the products
    } else {
      kr.load_rows(kb, 0, N, st.k.n, st.k.d);         // pass 2's first tile
      vr.load_cols(vb, 0, N, st.v.n, st.v.d);
    }
    float s[BK / 8][4];
    mma_scores(s, qf, ks, g, t, k0, N);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[half], mx);   // finite: key k0 < N is valid
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

  // pass 2: e = exp(s − m) rounded to bf16, o += e·v on the tensor cores
  const float cm[2] = {c * m[0], c * m[1]};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;
  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    kr.store_rows(ks, LD);
    vr.store_transposed(vt, LDV);
    __syncthreads();
    if (tile + 1 < tiles) {
      kr.load_rows(kb, k0 + BK, N, st.k.n, st.k.d);
      vr.load_cols(vb, k0 + BK, N, st.v.n, st.v.d);
    }
    float s[BK / 8][4];
    mma_scores(s, qf, ks, g, t, k0, N);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // the C fragments of score tiles 2kk and 2kk+1 are the A fragment of
      // keys [16kk, 16kk + 16)
      const uint32_t a[4] = {pack_e(s[2 * kk], 0, c, cm[0]), pack_e(s[2 * kk], 2, c, cm[1]),
                             pack_e(s[2 * kk + 1], 0, c, cm[0]),
                             pack_e(s[2 * kk + 1], 2, c, cm[1])};
      mma_acc(o, a, vt, kk, g, t);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int n = q0 + r0 + 8 * half;
    if (n >= N) continue;
    const float r = 1.f / l[half];
    bf16* orow = base(out, st.o, b, h) + n * st.o.n;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        orow[(j * 8 + 2 * t + e) * st.o.d] = __float2bfloat16_rn(o[j][2 * half + e] * r);
  }
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

__global__ void __launch_bounds__(F32_THREADS)
attn_fwd_qkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out, int N, Views st,
                        float scale) {
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

  // pass 2: e with the final row max, accumulated against v
  float acc[4][4];
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
      for (int j = 0; j < 4; ++j) pt[(tx * 4 + j) * LDT + ty * 4 + i] = exp_shift(s[i][j], mi);
    }
    __syncthreads();
    f32_acc(acc, pt, vs, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    if (n >= N) continue;
    const float r = 1.f / row_l[ty * 4 + i];
    float* o = base(out, st.o, b, h) + n * st.o.n;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[(tx * 4 + j) * st.o.d] = acc[i][j] * r;
  }
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

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

constexpr size_t BF16_SMEM = ((BQ + BK) * LD + D * LDV) * sizeof(bf16);
constexpr size_t F32_SMEM = (2 * D * LDT + BK * D + BK * LDT) * sizeof(float);

cudaError_t dispatch(const void* q, const void* k, const void* v, void* out, int dtype,
                     bool any_strides, int B, int N, int K, const Views& st, float scale,
                     void* stream, int device) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(attn_fwd_qkv_f32_kernel, F32_THREADS, F32_SMEM, q, k, v, out, B, N, K,
                         st, scale, s);
  if (any_strides)
    return launch<bf16>(attn_fwd_qkv_bf16_kernel<TileAny>, MMA_THREADS, BF16_SMEM, q, k, v, out,
                        B, N, K, st, scale, s);
  return launch<bf16>(attn_fwd_qkv_bf16_kernel<Tile>, MMA_THREADS, BF16_SMEM, q, k, v, out, B,
                      N, K, st, scale, s);
}

}  // namespace

// K1.  dtype: 0 = float32, 1 = bfloat16.  D must be 64.  qkv is
// (B, N, 3, K, D) and out (B, N, K, D), strides in elements.  Returns a
// cudaError_t (0 on success); the launch does not synchronise.
extern "C" int flash_attention_qkv_fwd(const void* qkv, void* out, int dtype, int B, int N,
                                       int K, int head_dim, long long sb, long long sn,
                                       long long ss, long long sh, long long sd, long long ob,
                                       long long on, long long oh, long long od, float scale,
                                       void* stream, int device) {
  if (head_dim != D || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const View qv{sb, sh, sn, sd};
  const Views st{qv, qv, qv, {ob, oh, on, od}};
  const size_t esize = dtype == 0 ? sizeof(float) : sizeof(bf16);
  const char* q = static_cast<const char*>(qkv);
  return dispatch(q, q + ss * esize, q + 2 * ss * esize, out, dtype, false, B, N, K, st, scale,
                  stream, device);
}

// K6.  q, k, v and out are (B, K, N, D) views given by their (b, h, n, d)
// strides in elements; any_strides = 1 stages bf16 tiles element by element
// (needed unless every operand has a unit head-dim stride and 16-byte rows).
extern "C" int flash_attention_tn_fwd(const void* q, const void* k, const void* v, void* out,
                                      int dtype, int any_strides, int B, int N, int K,
                                      int head_dim, long long qb, long long qh, long long qn,
                                      long long qd, long long kb, long long kh, long long kn,
                                      long long kd, long long vb, long long vh, long long vn,
                                      long long vd, long long ob, long long oh, long long on,
                                      long long od, float scale, void* stream, int device) {
  if (head_dim != D || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  const Views st{{qb, qh, qn, qd}, {kb, kh, kn, kd}, {vb, vh, vn, vd}, {ob, oh, on, od}};
  return dispatch(q, k, v, out, dtype, any_strides != 0, B, N, K, st, scale, stream, device);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
