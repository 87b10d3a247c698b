// Pooling attention with a decomposed relative-position bias (K10), forward
// and backward, for Hopper (sm_90a): the attention of MViTv2's
// MultiScaleAttention (Li et al., arXiv:2112.01526) at a head size of 96,
// after its pooled q, k and v.
//
// Replaces no TPU kernel: the JAX package has no multiscale model.  For one
// batch-head, q (Nq, 96), k and v (Nk, 96) bf16, the keys on a (tk, hk, wk)
// grid in row-major order, and the bias terms e (Nq, PP) bf16, whose
// columns [0, tk), [tk, tk + hk) and [tk + hk, tk + hk + wk) hold
// q_i·Rt[dt], q_i·Rh[dh] and q_i·Rw[dw] for every key coordinate:
//
//   s   = q·kᵀ·scale + e[i, jt] + e[i, tk + jh] + e[i, tk + hk + jw]      f32
//   lse = log Σ_j exp s;   o = (exp(s − m) in bf16)·v / Σ_j exp(s − m) + q
//
// The bias is added per score from the three terms: no (Nq, Nk) bias or
// score is ever stored.  The backward gives dq (with the residual's do),
// dk, dv, and de: dS summed over the key's other two coordinates, each
// row's sums taken in a fixed order by one thread with no atomics, so two
// calls give the same bits.
//
// Kernels, each a block of four warps on mma.sync m16n8k16 (bf16 operands,
// f32 accumulators), k and v (or q and do) streamed through shared memory
// on a cp.async ring of two tiles:
//   mvit_attention_fwd_kernel       64 query rows of a batch-head, online
//                                   softmax over 64-key steps; o and lse
//   mvit_attention_bwd_dq_kernel    64 query rows: Σ do·(o − q) (delta),
//                                   dq = dS·k·scale + do and de, over
//                                   32-key steps
//   mvit_attention_bwd_dkdv_kernel  64 keys: dv = Pᵀ·do, dk = dSᵀ·q·scale,
//                                   over 32-query steps
// The forward and dq kernels walk the keys in a padded order: each (t, h)
// row of keys is widened to a multiple of 8 (WG groups of 8, the padding
// masked), so that an 8-key column group of an mma tile is one (t, h) and
// each thread's key w is fixed.  A thread then keeps its rows' w terms (and
// their gradient) in registers and reads the (t, h) terms once a group;
// the (t, h) gradient is the group's quad sum, added by the row's one
// owning lane.  P and dS are rounded to bf16 before their products; de
// sums the f32 dS.  The scores are recomputed in each backward kernel.
//
// Bound.  A batch-head's forward reads q, k, v and the terms and writes o:
// 4·Nq·Nk·96 FLOP for about 4·(Nq + Nk)·96 bytes, Nq·Nk/(Nq + Nk) FLOP a
// byte: 283-340 at Nk = 392 and 300-1070 at Nk = 1568 in MViTv2-S, at or
// above the card's 295, so the products bind all but the blocks with 1,568
// or 392 queries against 392 keys, where the bytes bind barely.
//
// Names.  Every kernel's name begins with mvit_attention and holds none of
// the marks by which the benchmark's frozen kernel classes sort kernels
// (attn_fwd_qkv, attn_bwd_, pool, reduce, copy, softmax, ...).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int D = 96;               // head size
constexpr int CH = D / 8;           // 16-byte chunks of a row
constexpr int KC = D / 16;          // 16-wide steps of the head dim (mma depth)
constexpr int NT = D / 8;           // 8-wide column tiles of a (rows, 96) result
constexpr int THREADS = 128;        // four warps
constexpr int LD = D + 8;           // bf16 row stride of a staged tile: 208 bytes, so
                                    // the 8 rows an ldmatrix phase reads fall on
                                    // distinct banks
constexpr int BM = 64;              // query rows of a forward or dq block
constexpr int BN = 64;              // keys of a forward step
constexpr int BK = 32;              // keys of a dq step
constexpr int BKV = 64;             // keys of a dk/dv block
constexpr int BQ = 32;              // queries of a dk/dv step
constexpr float LOG2E = 1.4426950408889634f;

// One call's operands: q (BH, Nq, 96), k and v (BH, Nk, 96), e (BH, Nq, PP)
struct Problem {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  const bf16* e;
  int Nq, Nk, tk, hk, wk, PP;
  float scale;
};

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float bf(bf16 x) { return __bfloat162float(x); }

// c += a·b on one 16 × 8 tile: a 16 × 16 (row), b 16 × 8 (col), f32 c
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// The A operand of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a staged tile
__device__ __forceinline__ void a_tile(uint32_t a[4], const bf16* tile, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm(a, tile + (r0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD + c0 + (lane >> 4) * 8);
}

// Rows [r0, r0 + 16) and columns [c0, c0 + 16) of a staged tile as the B
// operands of two 8-column products whose columns are those rows (q·kᵀ):
// r[0], r[1] for rows r0..r0+7, r[2], r[3] for rows r0+8..r0+15.
__device__ __forceinline__ void b_rows(uint32_t r[4], const bf16* tile, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm(r, tile + (r0 + (lane & 7) + ((lane >> 4) << 3)) * LD + c0 + ((lane >> 3) & 1) * 8);
}

// Rows [r0, r0 + 16) and columns [c0, c0 + 16) of a staged tile as the B
// operands of a product that sums over those rows (P·v): r[0], r[1] for
// columns c0..c0+7, r[2], r[3] for c0+8..c0+15.
__device__ __forceinline__ void b_cols(uint32_t r[4], const bf16* tile, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  ldsm_t(r, tile + (r0 + (lane & 7) + (((lane >> 3) & 1) << 3)) * LD + c0 + (lane >> 4) * 8);
}

// acc[0..NT) (16 × 96) += x·tile over the 16·J rows r0.. of a staged
// tile, x the 2·J 8-column f32 tiles rounded to bf16
template <int J>
__device__ __forceinline__ void product(float acc[NT][4], const float x[2 * J][4],
                                        const bf16* tile, int r0) {
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const uint32_t a[4] = {pack(x[2 * j][0], x[2 * j][1]), pack(x[2 * j][2], x[2 * j][3]),
                           pack(x[2 * j + 1][0], x[2 * j + 1][1]),
                           pack(x[2 * j + 1][2], x[2 * j + 1][3])};
#pragma unroll
    for (int d = 0; d < KC; ++d) {
      uint32_t b[4];
      b_cols(b, tile, r0 + 16 * j, 16 * d);
      mma(acc[2 * d], a, b[0], b[1]);
      mma(acc[2 * d + 1], a, b[2], b[3]);
    }
  }
}

// s[0..2J) = a·tileᵀ for the 16·J rows r0.. of a staged tile, a the
// KC A operands of a 16-row (·, 96) operand
template <int J>
__device__ __forceinline__ void scores(float s[2 * J][4], const uint32_t a[KC][4],
                                       const bf16* tile, int r0) {
#pragma unroll
  for (int j = 0; j < 2 * J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int c = 0; c < KC; ++c)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      uint32_t b[4];
      b_rows(b, tile, r0 + 16 * j, 16 * c);
      mma(s[2 * j], a[c], b[0], b[1]);
      mma(s[2 * j + 1], a[c], b[2], b[3]);
    }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// cp.async of 16 or 4 bytes; nothing is read and zeros land when !ok
__device__ __forceinline__ void copy16(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void copy4(void* dst, const void* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [r0, r0 + rows) of an (n, width) bf16 operand (width a multiple of
// 8) into shared memory at row stride `ld`; rows ≥ n are zero.
__device__ __forceinline__ void issue_rows(bf16* dst, const bf16* src, int r0, int rows, int n,
                                           int width, int ld) {
  const int ch = width / 8;
  for (int i = threadIdx.x; i < rows * ch; i += THREADS) {
    const int r = i / ch, c = (i % ch) * 8;
    const bool ok = r0 + r < n;
    copy16(dst + r * ld + c, src + static_cast<long long>(ok ? r0 + r : 0) * width + c, ok);
  }
}

// Padded keys [p0, p0 + rows) into staged k and v tiles.  Padded key p is
// (th, w) = (p / (8·WG), p % (8·WG)): the key th·wk + w where th < tk·hk
// and w < wk, else zeros.
template <int WG>
__device__ __forceinline__ void issue_padded_keys(bf16* kt, bf16* vt, const Problem& p,
                                                  long long off, int p0, int rows) {
  const int TH = p.tk * p.hk;
  for (int i = threadIdx.x; i < 2 * rows * CH; i += THREADS) {
    const int which = i / (rows * CH), rem = i % (rows * CH);
    const int r = rem / CH, c = (rem % CH) * 8;
    const int pk = p0 + r, th = pk / (8 * WG), w = pk % (8 * WG);
    const bool ok = th < TH && w < p.wk;
    const long long j = ok ? static_cast<long long>(th) * p.wk + w : 0;
    copy16((which ? vt : kt) + r * LD + c, (which ? p.v : p.k) + off + j * D + c, ok);
  }
}

// Each (t, h) key row th's term columns, packed t | (tk + h) << 16
__device__ __forceinline__ void group_table(int* gtab, const Problem& p) {
  for (int i = threadIdx.x; i < p.tk * p.hk; i += THREADS) {
    const int t = i / p.hk;
    gtab[i] = t | ((p.tk + i - t * p.hk) << 16);
  }
}

// The w terms of this thread's rows (er[r] their staged term rows), times
// log2 e: row r, group m of the padded row, lane column e; −∞ past wk, which
// masks the padding.
template <int WG>
__device__ __forceinline__ void w_terms(float ew[2][WG][2], const bf16* const er[2],
                                        const Problem& p) {
  const int tq = threadIdx.x & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int m = 0; m < WG; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int w = 8 * m + 2 * tq + e;
        ew[r][m][e] = w < p.wk ? bf(er[r][p.tk + p.hk + w]) * LOG2E : -INFINITY;
      }
}

// The scores s·log2 e of a thread's 8-key groups n of the padded keys from
// group g0 on (s: q·kᵀ on entry), for its rows with staged term rows er.
template <int WG, int G>
__device__ __forceinline__ void finish_scores(float s[G][4], const Problem& p, const int* gtab,
                                              const bf16* const er[2],
                                              const float ew[2][WG][2], int g0) {
  const int TH = p.tk * p.hk;
  const float scale2 = p.scale * LOG2E;
#pragma unroll
  for (int n = 0; n < G; ++n) {
    const int th = (g0 + n) / WG;
    const bool ok = th < TH;
    const int gt = ok ? gtab[th] : 0;
    float eth[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) eth[r] = (bf(er[r][gt & 0xffff]) + bf(er[r][gt >> 16])) * LOG2E;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      s[n][e] = ok ? fmaf(s[n][e], scale2, eth[e >> 1] + ew[e >> 1][n % WG][e & 1]) : -INFINITY;
  }
}

template <int WG>
__global__ void __launch_bounds__(THREADS) mvit_attention_fwd_kernel(Problem p, bf16* o,
                                                                     float* lse) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + BM * LD;          // two tiles of BN keys
  bf16* vs = ks + 2 * BN * LD;
  bf16* es = vs + 2 * BN * LD;      // BM rows of PP terms
  int* gtab = reinterpret_cast<int*>(es + BM * p.PP);
  const int bh = blockIdx.y, m0 = blockIdx.x * BM;
  const int tiles = cdiv(p.tk * p.hk * 8 * WG, BN);
  const long long qoff = static_cast<long long>(bh) * p.Nq * D;
  const long long koff = static_cast<long long>(bh) * p.Nk * D;
  issue_rows(qs, p.q + qoff, m0, BM, p.Nq, D, LD);
  issue_rows(es, p.e + static_cast<long long>(bh) * p.Nq * p.PP, m0, BM, p.Nq, p.PP, p.PP);
  issue_padded_keys<WG>(ks, vs, p, koff, 0, BN);
  commit();
  group_table(gtab, p);
  wait_copies<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  uint32_t qa[KC][4];
#pragma unroll
  for (int c = 0; c < KC; ++c) a_tile(qa[c], qs, r0, 16 * c);
  const bf16* const er[2] = {es + (r0 + g) * p.PP, es + (r0 + g + 8) * p.PP};
  float ew[2][WG][2];
  w_terms<WG>(ew, er, p);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, acc[NT][4] = {};
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles)
      issue_padded_keys<WG>(ks + ((it + 1) & 1) * BN * LD, vs + ((it + 1) & 1) * BN * LD, p,
                            koff, (it + 1) * BN, BN);
    commit();
    wait_copies<1>();
    __syncthreads();
    const bf16* kt = ks + (it & 1) * BN * LD;
    const bf16* vt = vs + (it & 1) * BN * LD;
    float s[BN / 8][4];
    scores<BN / 16>(s, qa, kt, 0);
    finish_scores<WG, BN / 8>(s, p, gtab, er, ew, it * (BN / 8));
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = quad_max(mx[r]);
      alpha[r] = exp2f(m[r] - mx[r]);
      l[r] *= alpha[r];
      m[r] = mx[r];
    }
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int d = 0; d < NT; ++d)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[d][e] *= alpha[e >> 1];
    product<BN / 16>(acc, s, vt, 0);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    const int i = r0 + g + 8 * r, row = m0 + i;
    if (row >= p.Nq) continue;
    const float inv = 1.f / l[r];
#pragma unroll
    for (int d = 0; d < NT; ++d) {
      const int col = 8 * d + 2 * tq;
      const float2 qv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(qs + i * LD + col));
      *reinterpret_cast<__nv_bfloat162*>(o + qoff + static_cast<long long>(row) * D + col) =
          __floats2bfloat162_rn(fmaf(acc[d][2 * r], inv, qv.x), fmaf(acc[d][2 * r + 1], inv, qv.y));
    }
    if (tq == 0) lse[static_cast<long long>(bh) * p.Nq + row] = (m[r] + log2f(l[r])) / LOG2E;
  }
}

template <int WG>
__global__ void __launch_bounds__(THREADS) mvit_attention_bwd_dq_kernel(
    Problem p, const bf16* o, const bf16* dout, const float* lse, float* delta, bf16* dq,
    float* de) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TKH = p.tk + p.hk;
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + BM * LD;         // do
  bf16* ks = dos + BM * LD;         // two tiles of BK keys
  bf16* vs = ks + 2 * BK * LD;
  bf16* es = vs + 2 * BK * LD;      // BM rows of PP terms
  float* sums = reinterpret_cast<float*>(es + BM * p.PP);   // BM rows of the (t, h) gradient
  float* lse2s = sums + BM * TKH;
  float* dls = lse2s + BM;
  int* gtab = reinterpret_cast<int*>(dls + BM);
  const int bh = blockIdx.y, m0 = blockIdx.x * BM;
  const int tiles = cdiv(p.tk * p.hk * 8 * WG, BK);
  const long long qoff = static_cast<long long>(bh) * p.Nq * D;
  const long long koff = static_cast<long long>(bh) * p.Nk * D;
  const long long eoff = static_cast<long long>(bh) * p.Nq * p.PP;
  issue_rows(qs, p.q + qoff, m0, BM, p.Nq, D, LD);
  issue_rows(dos, dout + qoff, m0, BM, p.Nq, D, LD);
  issue_rows(es, p.e + eoff, m0, BM, p.Nq, p.PP, p.PP);
  issue_padded_keys<WG>(ks, vs, p, koff, 0, BK);
  commit();
  for (int i = threadIdx.x; i < BM * TKH; i += THREADS) sums[i] = 0.f;
  group_table(gtab, p);
  wait_copies<0>();
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  {
    // delta = Σ_d do·(o − q): two lanes a row, 48 columns each
    const int i = r0 + (lane >> 1), half = (lane & 1) * (D / 2), row = m0 + i;
    float sum = 0.f;
    if (row < p.Nq) {
      const bf16* orow = o + qoff + static_cast<long long>(row) * D + half;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + 8 * c);
        const bf16* ob = reinterpret_cast<const bf16*>(&ov);
#pragma unroll
        for (int x = 0; x < 8; ++x) {
          const int col = half + 8 * c + x;
          sum = fmaf(bf(dos[i * LD + col]), bf(ob[x]) - bf(qs[i * LD + col]), sum);
        }
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    if ((lane & 1) == 0) {
      dls[i] = sum;
      if (row < p.Nq) delta[static_cast<long long>(bh) * p.Nq + row] = sum;
    } else {
      lse2s[i] = row < p.Nq ? lse[static_cast<long long>(bh) * p.Nq + row] * LOG2E : 0.f;
    }
  }
  __syncwarp();
  uint32_t qa[KC][4], da[KC][4];
#pragma unroll
  for (int c = 0; c < KC; ++c) {
    a_tile(qa[c], qs, r0, 16 * c);
    a_tile(da[c], dos, r0, 16 * c);
  }
  const bf16* const er[2] = {es + (r0 + g) * p.PP, es + (r0 + g + 8) * p.PP};
  float ew[2][WG][2], dew[2][WG][2] = {};
  w_terms<WG>(ew, er, p);
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse2[r] = lse2s[r0 + g + 8 * r];
    dl[r] = dls[r0 + g + 8 * r];
  }
  const int TH = p.tk * p.hk;
  float acc[NT][4] = {};
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles)
      issue_padded_keys<WG>(ks + ((it + 1) & 1) * BK * LD, vs + ((it + 1) & 1) * BK * LD, p,
                            koff, (it + 1) * BK, BK);
    commit();
    wait_copies<1>();
    __syncthreads();
    const bf16* kt = ks + (it & 1) * BK * LD;
    const bf16* vt = vs + (it & 1) * BK * LD;
    float s[BK / 8][4], dp[BK / 8][4];
    scores<BK / 16>(s, qa, kt, 0);
    scores<BK / 16>(dp, da, vt, 0);
    const int g0 = it * (BK / 8);
    finish_scores<WG, BK / 8>(s, p, gtab, er, ew, g0);
#pragma unroll
    for (int n = 0; n < BK / 8; ++n) {
      const int th = (g0 + n) / WG;
      float row_sum[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float ds = exp2f(s[n][2 * r + e] - lse2[r]) * (dp[n][2 * r + e] - dl[r]);
          s[n][2 * r + e] = ds;
          dew[r][n % WG][e] += ds;
        }
        row_sum[r] = quad_sum(s[n][2 * r] + s[n][2 * r + 1]);
      }
      if (tq == 0 && th < TH) {
        const int gt = gtab[th];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float* row = sums + (r0 + g + 8 * r) * TKH;
          row[gt & 0xffff] += row_sum[r];
          row[gt >> 16] += row_sum[r];
        }
      }
    }
    product<BK / 16>(acc, s, kt, 0);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int i = r0 + g + 8 * r, row = m0 + i;
    if (row >= p.Nq) continue;
#pragma unroll
    for (int d = 0; d < NT; ++d) {
      const int col = 8 * d + 2 * tq;
      const float2 dv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dos + i * LD + col));
      *reinterpret_cast<__nv_bfloat162*>(dq + qoff + static_cast<long long>(row) * D + col) =
          __floats2bfloat162_rn(fmaf(acc[d][2 * r], p.scale, dv.x),
                                fmaf(acc[d][2 * r + 1], p.scale, dv.y));
    }
    float* derow = de + eoff + static_cast<long long>(row) * p.PP + TKH;
#pragma unroll
    for (int m = 0; m < WG; ++m)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int w = 8 * m + 2 * tq + e;
        if (w < p.wk) derow[w] = dew[r][m][e];
      }
  }
  __syncwarp();
  for (int x = lane; x < 16 * TKH; x += 32) {
    const int i = r0 + x / TKH, row = m0 + i;
    if (row < p.Nq) de[eoff + static_cast<long long>(row) * p.PP + x % TKH] = sums[i * TKH + x % TKH];
  }
}

__global__ void __launch_bounds__(THREADS) mvit_attention_bwd_dkdv_kernel(
    Problem p, const bf16* dout, const float* lse, const float* delta, bf16* dk, bf16* dv) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BKV * LD;
  bf16* qs = vs + BKV * LD;         // two tiles of BQ queries
  bf16* dos = qs + 2 * BQ * LD;
  bf16* es = dos + 2 * BQ * LD;     // two tiles of BQ rows of PP terms
  float* lses = reinterpret_cast<float*>(es + 2 * BQ * p.PP);   // two tiles of BQ
  float* dls = lses + 2 * BQ;
  const int bh = blockIdx.y, j0 = blockIdx.x * BKV;
  const int tiles = cdiv(p.Nq, BQ);
  const long long qoff = static_cast<long long>(bh) * p.Nq * D;
  const long long koff = static_cast<long long>(bh) * p.Nk * D;
  const long long eoff = static_cast<long long>(bh) * p.Nq * p.PP;
  const long long soff = static_cast<long long>(bh) * p.Nq;
  auto issue = [&](int it) {
    const int b = it & 1, q0 = it * BQ;
    issue_rows(qs + b * BQ * LD, p.q + qoff, q0, BQ, p.Nq, D, LD);
    issue_rows(dos + b * BQ * LD, dout + qoff, q0, BQ, p.Nq, D, LD);
    issue_rows(es + b * BQ * p.PP, p.e + eoff, q0, BQ, p.Nq, p.PP, p.PP);
    for (int i = threadIdx.x; i < 2 * BQ; i += THREADS) {
      const int r = i % BQ;
      const bool ok = q0 + r < p.Nq;
      copy4(i < BQ ? &lses[b * BQ + r] : &dls[b * BQ + r],
            (i < BQ ? lse : delta) + soff + (ok ? q0 + r : 0), ok);
    }
  };
  issue_rows(ks, p.k + koff, j0, BKV, p.Nk, D, LD);
  issue_rows(vs, p.v + koff, j0, BKV, p.Nk, D, LD);
  issue(0);
  commit();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int r0 = warp * 16;
  // this thread's two keys' term columns (t, tk + h, tk + hk + w)
  int ot[2], oh[2], ow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = min(j0 + r0 + g + 8 * r, p.Nk - 1);
    const int t = j / (p.hk * p.wk), rest = j - t * p.hk * p.wk, h = rest / p.wk;
    ot[r] = t;
    oh[r] = p.tk + h;
    ow[r] = p.tk + p.hk + rest - h * p.wk;
  }
  const float scale2 = p.scale * LOG2E;
  float dka[NT][4] = {}, dva[NT][4] = {};
  for (int it = 0; it < tiles; ++it) {
    if (it + 1 < tiles) issue(it + 1);
    commit();
    wait_copies<1>();
    __syncthreads();
    const int b = it & 1, q0 = it * BQ;
    const bf16* qt = qs + b * BQ * LD;
    const bf16* dot = dos + b * BQ * LD;
    const bf16* et = es + b * BQ * p.PP;
    uint32_t a[KC][4];
    float st[BQ / 8][4], dpt[BQ / 8][4];
#pragma unroll
    for (int c = 0; c < KC; ++c) a_tile(a[c], ks, r0, 16 * c);
    scores<BQ / 16>(st, a, qt, 0);          // k·qᵀ: rows keys, columns queries
#pragma unroll
    for (int c = 0; c < KC; ++c) a_tile(a[c], vs, r0, 16 * c);
    scores<BQ / 16>(dpt, a, dot, 0);        // v·doᵀ
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 8 * n + 2 * tq + (e & 1), r = e >> 1;
        const bf16* erow = et + col * p.PP;
        const float bias = bf(erow[ot[r]]) + bf(erow[oh[r]]) + bf(erow[ow[r]]);
        // a query past Nq has P = 0: exp2(s − ∞)
        const float l2 = q0 + col < p.Nq ? lses[b * BQ + col] * LOG2E : INFINITY;
        const float pr = exp2f(fmaf(st[n][e], scale2, bias * LOG2E) - l2);
        st[n][e] = pr;
        dpt[n][e] = pr * (dpt[n][e] - dls[b * BQ + col]);
      }
    product<BQ / 16>(dva, st, dot, 0);
    product<BQ / 16>(dka, dpt, qt, 0);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = j0 + r0 + g + 8 * r;
    if (j >= p.Nk) continue;
#pragma unroll
    for (int d = 0; d < NT; ++d) {
      const long long at = koff + static_cast<long long>(j) * D + 8 * d + 2 * tq;
      *reinterpret_cast<__nv_bfloat162*>(dk + at) =
          __floats2bfloat162_rn(dka[d][2 * r] * p.scale, dka[d][2 * r + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at) =
          __floats2bfloat162_rn(dva[d][2 * r], dva[d][2 * r + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t allow(Kernel kernel, int bytes) {
  return bytes > 48 * 1024
             ? cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
             : cudaSuccess;
}

constexpr int MAX_SMEM = 227 * 1024;

int fwd_smem(int PP, int TH) { return (BM + 4 * BN) * LD * 2 + BM * PP * 2 + TH * 4; }

int dq_smem(int PP, int TKH, int TH) {
  return (2 * BM + 4 * BK) * LD * 2 + BM * PP * 2 + BM * TKH * 4 + 2 * BM * 4 + TH * 4;
}

int dkdv_smem(int PP) { return (2 * BKV + 4 * BQ) * LD * 2 + 2 * BQ * PP * 2 + 4 * BQ * 4; }

bool aligned(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

bool bad(const Problem& p, int BH) {
  return !aligned(p.q) || !aligned(p.k) || !aligned(p.v) || !aligned(p.e) || BH < 0 ||
         BH > 65535 || p.Nq <= 0 || p.tk <= 0 || p.hk <= 0 || p.wk <= 0 || p.wk > 32 ||
         p.Nk != p.tk * p.hk * p.wk || p.PP % 8 != 0 || p.PP < p.tk + p.hk + p.wk ||
         p.tk + p.hk >= 0x8000 || fwd_smem(p.PP, p.tk * p.hk) > MAX_SMEM ||
         dq_smem(p.PP, p.tk + p.hk, p.tk * p.hk) > MAX_SMEM || dkdv_smem(p.PP) > MAX_SMEM;
}

// groups of 8 keys a (t, h) row of keys is padded to
int groups(int wk) { return wk <= 8 ? 1 : wk <= 16 ? 2 : 4; }

template <int WG>
cudaError_t launch_fwd(const Problem& p, int BH, bf16* o, float* lse, cudaStream_t s) {
  const int bytes = fwd_smem(p.PP, p.tk * p.hk);
  cudaError_t err = allow(mvit_attention_fwd_kernel<WG>, bytes);
  if (err != cudaSuccess) return err;
  mvit_attention_fwd_kernel<WG><<<dim3(cdiv(p.Nq, BM), BH), THREADS, bytes, s>>>(p, o, lse);
  return cudaGetLastError();
}

template <int WG>
cudaError_t launch_dq(const Problem& p, int BH, const bf16* o, const bf16* dout,
                      const float* lse, float* delta, bf16* dq, float* de, cudaStream_t s) {
  const int bytes = dq_smem(p.PP, p.tk + p.hk, p.tk * p.hk);
  cudaError_t err = allow(mvit_attention_bwd_dq_kernel<WG>, bytes);
  if (err != cudaSuccess) return err;
  mvit_attention_bwd_dq_kernel<WG><<<dim3(cdiv(p.Nq, BM), BH), THREADS, bytes, s>>>(
      p, o, dout, lse, delta, dq, de);
  return cudaGetLastError();
}

}  // namespace

// Forward: o (BH, Nq, 96) bf16 and lse (BH, Nq) f32 from q (BH, Nq, 96),
// k and v (BH, Nk, 96) with Nk = tk·hk·wk, and the bias terms e (BH, Nq,
// PP), all bf16.
extern "C" int pool_attention_fwd(const void* q, const void* k, const void* v, const void* e,
                                  void* o, void* lse, int BH, int Nq, int Nk, int tk, int hk,
                                  int wk, int PP, float scale, void* stream, int device) {
  const Problem p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(e),
                  Nq, Nk, tk, hk, wk, PP, scale};
  if (bad(p, BH) || o == nullptr || lse == nullptr || !aligned(o)) return cudaErrorInvalidValue;
  if (BH == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  bf16* ob = static_cast<bf16*>(o);
  float* l = static_cast<float*>(lse);
  switch (groups(wk)) {
    case 1: return launch_fwd<1>(p, BH, ob, l, s);
    case 2: return launch_fwd<2>(p, BH, ob, l, s);
    default: return launch_fwd<4>(p, BH, ob, l, s);
  }
}

// Backward: dq (with the residual's do), dk, dv (bf16, as q, k, v) and de
// (BH, Nq, PP) f32 (columns past tk + hk + wk unwritten) from the forward's
// o and lse and the cotangent do (BH, Nq, 96) bf16.  Scratch: delta (BH, Nq) f32.
extern "C" int pool_attention_bwd(const void* q, const void* k, const void* v, const void* e,
                                  const void* o, const void* dout, const void* lse, void* delta,
                                  void* dq, void* dk, void* dv, void* de, int BH, int Nq, int Nk,
                                  int tk, int hk, int wk, int PP, float scale, void* stream,
                                  int device) {
  const Problem p{static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                  static_cast<const bf16*>(v), static_cast<const bf16*>(e),
                  Nq, Nk, tk, hk, wk, PP, scale};
  if (bad(p, BH) || o == nullptr || dout == nullptr || lse == nullptr || delta == nullptr ||
      dq == nullptr || dk == nullptr || dv == nullptr || de == nullptr || !aligned(o) ||
      !aligned(dout) || !aligned(dq) || !aligned(dk) || !aligned(dv))
    return cudaErrorInvalidValue;
  if (BH == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* ob = static_cast<const bf16*>(o);
  const bf16* db = static_cast<const bf16*>(dout);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  bf16* dqb = static_cast<bf16*>(dq);
  float* deb = static_cast<float*>(de);
  switch (groups(wk)) {
    case 1: err = launch_dq<1>(p, BH, ob, db, l, dl, dqb, deb, s); break;
    case 2: err = launch_dq<2>(p, BH, ob, db, l, dl, dqb, deb, s); break;
    default: err = launch_dq<4>(p, BH, ob, db, l, dl, dqb, deb, s); break;
  }
  if (err != cudaSuccess) return err;
  const int bytes = dkdv_smem(PP);
  if ((err = allow(mvit_attention_bwd_dkdv_kernel, bytes)) != cudaSuccess) return err;
  mvit_attention_bwd_dkdv_kernel<<<dim3(cdiv(Nk, BKV), BH), THREADS, bytes, s>>>(
      p, db, l, dl, static_cast<bf16*>(dk), static_cast<bf16*>(dv));
  return cudaGetLastError();
}

extern "C" const char* pool_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
