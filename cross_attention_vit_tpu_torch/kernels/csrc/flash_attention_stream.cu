// Streaming self-attention forward with the row logsumexp, for Hopper (sm_90a).
//
// Replaces the TPU kernel cross_attention_vit_tpu/kernels/flash_attention.py
// ::_attn_kernel_stream (defined at :133, launched by pallas_call at :250 in
// _flash_forward, the branch for N > _SINGLE_BLOCK_MAX = 1040).  It computes
// that kernel's function for every (batch b, head h), one pass over the keys
// with an online softmax:
//
//     s     = q·kᵀ · scale                      f32 accumulation
//     m_new = max(m, rowmax(s));  p = exp(s − m_new);  alpha = exp(m − m_new)
//     l     = l·alpha + Σ_j p                    f32
//     acc   = acc·alpha + (p cast to the operand dtype)·v    f32 accumulation
//     out   = acc / l  (cast);   lse = m + log l  (f32)
//
// Unlike K1 (flash_attention_fwd.cu), which casts e with the FINAL row max
// in a second pass, p is cast with the running max, as the TPU kernel does.
// The TPU kernel walks 512-key tiles; this one walks 64-key tiles, so its
// running max (and with it the rounding of p) can differ within bf16
// rounding from the plain version, which follows the 512-key tiles.
//
// Layout.  q, k, v are (B, K, N, D) operands of any strides (in elements),
// so the caller passes views of the stacked (B, N, 3, K, D) qkv without a
// copy; out is written through its strides (the wrapper allocates it in
// (B, N, K, D) order, the output projection's input) and lse is a
// contiguous (B, K, N) f32 array.  Head dim D = 64, as in K1.
//
// Bound.  At the training shape of the 3-stream ModelVIT (B=8, K=16,
// N=1537, D=64, bf16) one launch must read q, k, v and write out and lse:
// 4·B·N·K·D·2 B + B·K·N·4 B = 101.5 MB, 30.3 us at 3.35 TB/s.  Its two
// products are 4·B·K·N²·D = 77.4 GFLOP, 78.3 us at the 989 TFLOP/s bf16
// tensor-core peak.  So operations bound it.
//
// Design.  One block per 64-row query tile of one (b, h) streams over the
// 64-key tiles of k and v staged in shared memory; (m, l, acc) stay in
// registers for the whole loop, so the one pass reads k and v once per
// query tile (K1's two passes read k twice).
//
//   bf16 (the training and serving path): 4 warps, each owning 16 query
//   rows, run both products on the tensor cores with mma.sync m16n8k16
//   (bf16 in, f32 accumulate).  The score accumulators become p in place
//   and are re-packed in registers as the A operand of the p·v product, so
//   p never touches shared memory.  exp(scale·(s − m)) is one FMA and an
//   exp2 on the unscaled scores (scale > 0 keeps the row order).  The next
//   tile's 16-byte loads are issued into registers before this tile's
//   products.  Needs a unit head-dim stride and 16-byte rows (the wrapper
//   checks).
//   f32: scalar f32 FMAs on the CUDA cores (256 threads, 4×4 register
//   tiles), any strides, full f32 (no TF32); p goes through shared memory.
//
// Ragged N (1537 = 24·64 + 1): key columns ≥ N score −inf and rows ≥ N of
// q, k and v are staged as zeros, so no NaN can enter; nothing is stored
// for rows ≥ N.  Every key tile holds a valid key, so the running max is
// finite after the first tile; it is guarded anyway (m = −inf gives
// alpha = 0 and p = 0, never −inf − −inf).
//
// Not yet done (later work): wgmma, TMA, warp specialisation, larger tiles.

#include "attention_tiles.cuh"

namespace {

struct Views {
  View q, k, v, o;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(MMA_THREADS)
attn_stream_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out,
                            float* __restrict__ lse, int N, int K, Views st, float scale) {
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
  vr.load_cols(vb, 0, N, st.v.n);
  __syncthreads();
  uint32_t qf[D / 16][4];                      // this warp's q as A fragments
  load_a(qf, qs, r0, t);

  // (m, l, acc) of rows r0 and r0 + 8; m (unscaled) is shared by the 4
  // threads (a quad) of a row, l is this thread's partial sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();                           // the last tile's reads are done
    kr.store_rows(ks, LD);
    vr.store_transposed(vt, LDV);
    __syncthreads();
    if (tile + 1 < tiles) {                    // in flight during the products
      kr.load_rows(kb, k0 + BK, N, st.k.n);
      vr.load_cols(vb, k0 + BK, N, st.v.n);
    }
    // s = q·kᵀ (unscaled): 8 tiles of 8 keys; thread (g, t) holds rows g and
    // g+8, keys 8j + 2t + {0, 1}; keys ≥ N score −inf
    float s[BK / 8][4];
    mma_nt(s, qf, ks, g, t);
    if (k0 + BK > N) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * t + (e & 1) >= N) s[j][e] = -INFINITY;
    }

    float cm[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * half], s[j][2 * half + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[half], mx);
      cm[half] = mn == -INFINITY ? 0.f : c * mn;
      // alpha = exp(scale·(m − m_new)); m = −inf (first tile) gives 0
      const float alpha = exp2f(fmaf(m[half], c, -cm[half]));
      l[half] *= alpha;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[j][2 * half] *= alpha;
        o[j][2 * half + 1] *= alpha;
      }
      m[half] = mn;
    }
    // p = exp(scale·(s − m_new)) in f32, in place; l sums the f32 p
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(fmaf(s[j][e], c, -cm[e >> 1]));
        l[e >> 1] += s[j][e];
      }
    // acc += bf16(p)·v: the C fragments of score tiles 2kk and 2kk+1 are
    // the A fragment of keys [16kk, 16kk + 16)
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]), pack(s[2 * kk][2], s[2 * kk][3]),
                             pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      mma_acc(o, a, vt, kk, g, t);
    }
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const int n = q0 + r0 + 8 * half;
    if (n >= N) continue;
    bf16* orow = base(out, st.o, b, h) + n * st.o.n;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) =
          __floats2bfloat162_rn(o[j][2 * half] / l[half], o[j][2 * half + 1] / l[half]);
    if (t == 0) lse[(static_cast<long long>(b) * K + h) * N + n] = fmaf(m[half], scale, logf(l[half]));
  }
}

// ---------------------------------------------------------------------------
// f32: scalar FMAs on the CUDA cores (no TF32)
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(F32_THREADS)
attn_stream_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ out,
                           float* __restrict__ lse, int N, int K, Views st, float scale) {
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);   // [D][LDT]  q tile, transposed
  float* kt = qt + D * LDT;                      // [D][LDT]  k tile, transposed
  float* vs = kt + D * LDT;                      // [BK][D]   v tile
  float* pt = vs + BK * D;                       // [BK][LDT] p, transposed

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = base(q, st.q, b, h);
  const float* kb = base(k, st.k, b, h);
  const float* vb = base(v, st.v, b, h);
  const int tiles = (N + BK - 1) / BK;

  stage_t(qt, qb, q0, N, st.q.n, st.q.d);
  // rows ty·4 + i: m is shared by the 16 threads (lanes differing in bits
  // 0-3) of a row, l is this thread's partial sum over its own columns
  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }

  for (int tile = 0; tile < tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();
    stage_t(kt, kb, k0, N, st.k.n, st.k.d);
    stage_rows(vs, vb, k0, N, st.v.n, st.v.d);
    __syncthreads();
    float s[4][4];                               // scaled scores, −inf past N
    f32_tn(s, qt, kt, tx, ty);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool valid = k0 + tx * 4 + j < N;
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][j] = valid ? s[i][j] * scale : -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float mn = fmaxf(m[i], mx);
      const float alpha = exp_shift(m[i], mn);   // 0 while m is −inf
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp_shift(s[i][j], mn);
        pt[(tx * 4 + j) * LDT + ty * 4 + i] = p;
        sum += p;
        acc[i][j] *= alpha;
      }
      l[i] = l[i] * alpha + sum;
      m[i] = mn;
    }
    __syncthreads();
    f32_acc(acc, pt, vs, tx, ty);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int n = q0 + ty * 4 + i;
    if (n >= N) continue;
    float* orow = base(out, st.o, b, h) + n * st.o.n;
#pragma unroll
    for (int j = 0; j < 4; ++j) orow[(tx * 4 + j) * st.o.d] = acc[i][j] / l[i];
    if (tx == 0) lse[(static_cast<long long>(b) * K + h) * N + n] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// launcher
// ---------------------------------------------------------------------------

constexpr size_t BF16_SMEM = ((BQ + BK) * LD + D * LDV) * sizeof(bf16);
constexpr size_t F32_SMEM = (2 * D * LDT + BK * D + BK * LDT) * sizeof(float);

template <typename T>
cudaError_t launch(void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, Views,
                                  float),
                   int threads, size_t smem, const void* q, const void* k, const void* v,
                   void* out, float* lse, int B, int N, int K, const Views& st, float scale,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + BQ - 1) / BQ, K, B);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(out), lse,
                                          N, K, st, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 64.  Each operand's strides
// are (b, h, n, d) of its (B, K, N, D) view, in elements; lse is a contiguous
// (B, K, N) f32 array.  Returns a cudaError_t (0 on success); the launch
// does not synchronise.
extern "C" int flash_attention_stream_fwd(
    const void* q, const void* k, const void* v, void* out, void* lse, int dtype, int B, int N,
    int K, int head_dim, long long qb, long long qh, long long qn, long long qd, long long kb,
    long long kh, long long kn, long long kd, long long vb, long long vh, long long vn,
    long long vd, long long ob, long long oh, long long on, long long od, float scale,
    void* stream, int device) {
  if (head_dim != D || (dtype != 0 && dtype != 1)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Views st{{qb, qh, qn, qd}, {kb, kh, kn, kd}, {vb, vh, vn, vd}, {ob, oh, on, od}};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0)
    return launch<float>(attn_stream_fwd_f32_kernel, F32_THREADS, F32_SMEM, q, k, v, out, l, B,
                         N, K, st, scale, s);
  return launch<bf16>(attn_stream_fwd_bf16_kernel, MMA_THREADS, BF16_SMEM, q, k, v, out, l, B,
                      N, K, st, scale, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
