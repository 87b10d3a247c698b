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
// Design.  A block owns 64-row query tiles of one (b, h) and streams once
// over the 64-key tiles of k and v; (m, l, acc) stay in registers for the
// whole loop, so the one pass reads k and v once per query tile (K1's two
// passes read k twice).
//
//   bf16 (the training and serving path) on K1's parts (hopper_tiles.cuh):
//   a warpgroup per 64-row query tile runs s = q·kᵀ as wgmma m64n64k16 with
//   q and k read K-major from shared memory; each row's max over the tile is
//   shuffled across its four threads; p = exp2(c·s − c·m) is one FMA and an
//   ex2 per score, packed from the score accumulators into bf16 A fragments
//   in registers; acc += p·v runs wgmma with v read transposed (MN-major)
//   from its one row-major tile, so no operand is stored transposed.  k and
//   v tiles arrive by cp.async into a ring of FWD_STAGES (k, v) slots, two
//   steps ahead of the products, one barrier a step.  The one-key last tile
//   (N = 1537) costs an m64n16 score product and one 16-deep p·v step, not
//   64.  A block holds two warpgroups, each owning a 64-row query tile,
//   sharing the ring: warpgroup 0 copies each step's k tile and warpgroup 1
//   its v tile.  Two tiles a block halve the reads of each head's k and v
//   from L2 (25 × 393 KB a head at N = 1537 with one), and while one
//   warpgroup runs its softmax the other's products run; the cost is the
//   last block's second tile, which may hold no row (it copies and waits,
//   and computes nothing).  One tile a block was measured and dropped: on
//   an H100 at B=8 K=16 N=1537, 0.3760 ms against two's 0.3311 ms, timed in
//   turns by kernels_in_turns.py (PERF.md §6).  Needs a unit head-dim
//   stride and 16-byte rows (the wrapper checks).
//   f32: scalar f32 FMAs on the CUDA cores (256 threads, 4×4 register
//   tiles), any strides, full f32 (no TF32); p goes through shared memory.
//
// Ragged N (1537 = 24·64 + 1): key columns ≥ N are left out of the max and
// give p = 0, and rows ≥ N of q, k and v are staged as zeros, so no NaN can
// enter; nothing is stored for rows ≥ N.  Every key tile holds a valid key,
// so the running max is finite after the first tile; it is guarded anyway
// (m = −inf gives alpha = 0, never −inf − −inf).
//
// Not yet done (later work): TMA with a producer warp, and overlapping one
// tile's softmax with the next tile's score product inside a warpgroup.

#include "hopper_tiles.cuh"

namespace {

struct Views {
  View q, k, v, o;
};

// ---------------------------------------------------------------------------
// bf16: wgmma, tiles by cp.async
// ---------------------------------------------------------------------------

constexpr int FWD_STAGES = 3;   // ring slots of (k, v) tile pairs

// Two warpgroups per block, each owning a 64-row query tile of one (b, h);
// they share the ring of (k, v) tiles (warpgroup 0 copies the k tile and
// warpgroup 1 the v tile of each step).
constexpr int WGS = 2;

__global__ void __launch_bounds__(WGS * WG_THREADS)
attn_stream_fwd_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                            const bf16* __restrict__ v, bf16* __restrict__ out,
                            float* __restrict__ lse, int N, int K, Views st, float scale) {
  extern __shared__ float4 smem4[];
  bf16* qs = aligned_smem(smem4);              // WGS q tiles
  bf16* ring = qs + WGS * TILE;                // [stage][k, v] tiles

  const int wg = threadIdx.x / WG_THREADS, tid = threadIdx.x % WG_THREADS;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = (blockIdx.x * WGS + wg) * BQ, h = blockIdx.y, b = blockIdx.z;
  const bf16* qb = base(q, st.q, b, h);
  const bf16* kb = base(k, st.k, b, h);
  const bf16* vb = base(v, st.v, b, h);
  const int tiles = (N + BK - 1) / BK;
  // exp(scale·(s − m)) = exp2(c·s − c·m) for unscaled scores s: one FMA and
  // one ex2 per score (scale > 0 keeps the maxima's order)
  const float c = scale * LOG2E;
  // the last block's second warpgroup may hold no query row: it copies and
  // waits with the others, and computes nothing
  const bool active = q0 < N;
  bf16* qt = qs + wg * TILE;

  auto issue = [&](int i) {
    bf16* stage = ring + (i % FWD_STAGES) * 2 * TILE;
    const int k0 = i * BK;
    load_tile_async(stage + wg * TILE, wg ? vb : kb, k0, N, wg ? st.v.n : st.k.n, tid);
  };
  if (active) load_tile_async(qt, qb, q0, N, st.q.n, tid);   // joins step 0's group
  ring_begin<FWD_STAGES>(tiles, issue);

  // (m, l, o) of rows 16·warp + g and + 8: m, the running max of the
  // unscaled scores, is shared by the 4 threads (a quad) of a row; l is this
  // thread's partial sum of the f32 p
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float s[32], o[32];
  zero32(o);
  for (int i = 0; i < tiles; ++i) {
    ring_step<FWD_STAGES>(i, tiles, issue);
    if (!active) continue;
    const bf16* ks = ring + (i % FWD_STAGES) * 2 * TILE;
    const int k0 = i * BK;
    const int nb = min(BK, N - k0 + 15) / 16;   // 16-key blocks holding a key < N
    const bool full = k0 + BK <= N;
    wg_fence();
    mma_tn_n(s, qt, ks, nb);
    wg_commit();
    wg_wait<0>();
    settle(s);
    // the new running max over the quad; acc and l rescaled by
    // alpha = exp(scale·(m − m_new)) (0 on the first tile: m = −inf)
    float cm[2];
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
      const float mn = fmaxf(m[half], mx);     // finite: key k0 < N is valid
      cm[half] = mn == -INFINITY ? 0.f : c * mn;
      const float alpha = exp2f(fmaf(m[half], c, -cm[half]));
      l[half] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[4 * j + 2 * half] *= alpha;
        o[4 * j + 2 * half + 1] *= alpha;
      }
      m[half] = mn;
    }
    // p = exp(scale·(s − m_new)) in f32, summed into l, rounded to bf16 as
    // the A operand of p·v (the running max's rounding, as the TPU kernel)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const bool valid = full || (j < 2 * nb && k0 + 8 * j + 2 * t + (x & 1) < N);
        const float p = valid ? exp2f(fmaf(s[4 * j + x], c, -cm[x >> 1])) : 0.f;
        l[x >> 1] += p;
        s[4 * j + x] = p;
      }
    uint32_t a[4][4];
    pack_a(a, s);
    wg_fence();
    mma_nn(o, a, ks + TILE, nb);
    wg_commit();
    wg_wait<0>();
  }
  if (!active) return;
  settle(o);

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 1);
    l[half] += __shfl_xor_sync(0xffffffffu, l[half], 2);
    const int n = q0 + warp * 16 + g + 8 * half;
    if (n >= N) continue;
    bf16* orow = base(out, st.o, b, h) + n * st.o.n;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8 + 2 * t) = __floats2bfloat162_rn(
          o[4 * j + 2 * half] / l[half], o[4 * j + 2 * half + 1] / l[half]);
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

constexpr size_t BF16_SMEM = SMEM_ALIGN + (WGS + 2 * FWD_STAGES) * TILE * sizeof(bf16);
constexpr size_t F32_SMEM = (2 * D * LDT + BK * D + BK * LDT) * sizeof(float);

// rows: query rows a block owns
template <typename T>
cudaError_t launch(void (*kernel)(const T*, const T*, const T*, T*, float*, int, int, Views,
                                  float),
                   int threads, int rows, size_t smem, const void* q, const void* k,
                   const void* v, void* out, float* lse, int B, int N, int K, const Views& st,
                   float scale, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid((N + rows - 1) / rows, K, B);
  kernel<<<grid, threads, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(out), lse,
                                          N, K, st, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be 64.  Each operand's strides
// are (b, h, n, d) of its (B, K, N, D) view, in elements; lse is a contiguous
// (B, K, N) f32 array.
// Returns a cudaError_t (0 on success); the launch does not synchronise.
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
    return launch<float>(attn_stream_fwd_f32_kernel, F32_THREADS, BQ, F32_SMEM, q, k, v, out, l,
                         B, N, K, st, scale, s);
  return launch<bf16>(attn_stream_fwd_bf16_kernel, WGS * WG_THREADS, WGS * BQ, BF16_SMEM, q, k,
                      v, out, l, B, N, K, st, scale, s);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
