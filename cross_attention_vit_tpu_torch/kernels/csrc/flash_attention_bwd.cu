// Backward of the self-attention, for Hopper (sm_90a): the kernels of
// attention_bwd.cuh behind four entry points (K2, K6, K5 and K7).
//
// K2 replaces the TPU kernel cross_attention_vit_tpu/kernels/flash_attention.py
// ::_attn_bwd_kernel_qkv_tn (defined at :768, launched by pallas_call at :835
// in _qkv_tn_bwd): _tn_bwd_math with the SAVED output o, on one stacked qkv
// read as (B, N, 3, K, D) with o and do as (B, N, K, D); it writes dq, dk, dv
// as one contiguous (B, N, 3, K, D) dqkv, the layout of the QKV projection's
// output, so the dx and dW GEMMs that follow read it as a (B·N, 3H) matrix.
//
// K6 replaces ::_attn_bwd_kernel_tn (defined at :618, launched at :733 in
// _flash_backward_tn), the gradient of the public flash_attention_tn at
// N <= 1040: _tn_bwd_math with o=None, on separate q, k, v and do of any
// strides.  It recomputes o = (eb·v)·r in f32, never rounded, and takes
// delta = Σ_d f32(do)·o from it, where K2 reads the rounded saved output.
// The dq kernel spends one more pass over the keys for it (o accumulated in
// registers).
//
// K5 replaces ::_attn_bwd_kernel (defined at :280, launched at :351 in
// _flash_backward_pallas), the gradient of the public flash_attention at
// N <= 1040: K6's kernels under K5's rounding rule (kNormalised: pb =
// bf16(e·r), o = pb·v, dv = pbᵀ·do with do unscaled), on the same separate
// operands, reading the row statistics of K5's forward.  Its kernels carry
// their own names (attn_single_bwd_*), so that a profile books their time to
// K5 and not to K2.
//
// K7 replaces ::_bwd_dq_kernel (defined at :429, launched at :527) and
// ::_bwd_dkv_kernel (:379, launched at :498), the blocked backward
// _flash_backward_blocked of the streaming forward (N > 1040): K2's kernels
// with the SAVED output under K5's rounding rule, reading the forward's
// (B, K, N) f32 row logsumexp as m with r ≡ 1 (kLse), so p = exp(s − lse)
// is normalised before it is rounded, dv = bf16(p)ᵀ·dO with dO unscaled and
// ds = (p·(dp − delta))·scale, the TPU kernel's order.  The dq kernel writes
// delta = Σ_d f32(dO)·f32(o) to a (B, K, N) scratch that the dk/dv kernel
// reads.  Operands are (B, K, N, D) views (the 3-stream ModelVIT's: views of
// its stacked qkv and dqkv).  Its kernels carry their own names
// (attn_stream_bwd_*), so that a profile books their time to K7.
//
// Bound.  At the training path's shape (B=8, K=16, D=64, N=513, bf16) one K2
// call must read qkv, o and do and write dqkv: 8·B·N·K·D·2 B = 67.2 MB, 20.1 us
// at 3.35 TB/s.  Its five necessary products (s, dp, dv, dq, dk) are
// 10·B·K·N²·D = 21.6 GFLOP, 21.8 us at the 989 TFLOP/s bf16 tensor-core peak,
// and its exponentials, one per score at the least, 33.7 M at about
// 3.9 T/s: 8.6 us.  So the bound is about 22 us (operations); K5's and K6's
// are the same 21.8 us (they read no o: 58.8 MB, 17.6 us of bytes).  The
// kernels run seven products (s twice: once in each kernel; K5 and K6 nine)
// and two exponentials per score (K5 and K6 three).
//
// Grid: a block of one warpgroup per 64-row tile: (⌈N/64⌉, K, B) = (9, 16, 8)
// = 1152 blocks for each kernel at the training shape, 8.7 blocks per SM on
// 132 SMs.  Shared memory: dq kernel 65 KB (q, do, three ring slots of k and
// v), dk/dv kernel 67 KB (k, v, three slots of q and do and their row
// statistics): three blocks an SM.  Registers (ptxas -v, sm_90a): dq kernel
// 150 (152 with o recomputed), dk/dv kernel 160 under its launch bound of
// three blocks, none spilled.
//
// K7's bound at the 3-stream ModelVIT training shape (B=8, K=16, N=1537,
// D=64, bf16): read q, k, v, o, dO and lse, write dq, dk, dv: 202 MB, 60.3 us
// at 3.35 TB/s; five products, 10·B·K·N²·D = 193.5 GFLOP, 195.7 us at
// 989 TFLOP/s: operations bound it.  Grid (25, 16, 8) = 3200 blocks a
// kernel, 8.1 waves at three blocks an SM.

#include "attention_bwd.cuh"

namespace {

bool bad_args(int head_dim, int dtype) { return head_dim != D || (dtype != 0 && dtype != 1); }

// K5's kernels: attention_bwd.cuh's bodies under K5's rule (bf16) and K6's
// f32 bodies, under K5's names.
__global__ void __launch_bounds__(WG_THREADS) attn_single_bwd_dq_bf16_kernel(BWD_DQ_PARAMS(bf16)) {
  attn_bwd_dq_bf16<true, true>(BWD_DQ_ARGS);
}
__global__ void __launch_bounds__(WG_THREADS, 3)
attn_single_bwd_dkdv_bf16_kernel(BWD_DKDV_PARAMS(bf16)) {
  attn_bwd_dkdv_bf16<true>(BWD_DKDV_ARGS);
}
__global__ void __launch_bounds__(F32_THREADS) attn_single_bwd_dq_f32_kernel(BWD_DQ_PARAMS(float)) {
  attn_bwd_dq_f32<true>(BWD_DQ_ARGS);
}
__global__ void __launch_bounds__(F32_THREADS)
attn_single_bwd_dkdv_f32_kernel(BWD_DKDV_PARAMS(float)) {
  attn_bwd_dkdv_f32<false>(BWD_DKDV_ARGS);
}

// K7's kernels: the saved-o bodies under the lse rule, under K7's names.
__global__ void __launch_bounds__(WG_THREADS) attn_stream_bwd_dq_bf16_kernel(BWD_DQ_PARAMS(bf16)) {
  attn_bwd_dq_bf16<false, true, true>(BWD_DQ_ARGS);
}
__global__ void __launch_bounds__(WG_THREADS, 3)
attn_stream_bwd_dkdv_bf16_kernel(BWD_DKDV_PARAMS(bf16)) {
  attn_bwd_dkdv_bf16<true, true>(BWD_DKDV_ARGS);
}
__global__ void __launch_bounds__(F32_THREADS) attn_stream_bwd_dq_f32_kernel(BWD_DQ_PARAMS(float)) {
  attn_bwd_dq_f32<false, true>(BWD_DQ_ARGS);
}
__global__ void __launch_bounds__(F32_THREADS)
attn_stream_bwd_dkdv_f32_kernel(BWD_DKDV_PARAMS(float)) {
  attn_bwd_dkdv_f32<true>(BWD_DKDV_ARGS);
}

}  // namespace

// K2.  dtype: 0 = float32, 1 = bfloat16.  D must be 64.  Strides are in
// elements; dqkv is contiguous (B, N, 3, K, D); stats is K1's (2, B, K, N)
// f32 row statistics and delta a (B, K, N) f32 scratch.  Returns a
// cudaError_t (0 on success); the two launches do not synchronise.
extern "C" int flash_attention_qkv_bwd(const void* qkv, const void* o, const void* dout,
                                       void* dqkv, const void* stats, void* delta, int dtype,
                                       int B, int N, int K, int head_dim, long long sb,
                                       long long sn, long long ss, long long sh, long long sd,
                                       long long ob, long long on, long long oh, long long od,
                                       long long gb, long long gn, long long gh, long long gd,
                                       float scale, void* stream, int device) {
  if (bad_args(head_dim, dtype)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const size_t es = dtype == 0 ? sizeof(float) : sizeof(bf16);
  const char* q = static_cast<const char*>(qkv);
  char* dq = static_cast<char*>(dqkv);
  const long long slab = static_cast<long long>(K) * D;   // dk, dv offsets in dqkv
  const BwdCall a{q, q + ss * es, q + 2 * ss * es, o, dout,
                  dq, dq + slab * es, dq + 2 * slab * es, static_cast<const float*>(stats),
                  static_cast<float*>(delta), B, N, K,
                  stacked_views(N, K, sb, sn, sh, sd, ob, on, oh, od, gb, gn, gh, gd), scale,
                  static_cast<cudaStream_t>(stream)};
  return launch_bwd<false>(a, dtype, true, true);
}

// K6's and K5's two kernels each.  Each operand is a (B, K, N, D) view given
// by its (b, h, n, d) strides in elements (bf16: unit head-dim stride and
// 16-byte rows, which K6's wrapper ensures by copying and K5's checks); dq,
// dk, dv need a unit head-dim stride; stats is the forward's (2, B, K, N) f32
// row statistics and delta a (B, K, N) f32 scratch.  Run the dq kernel first
// (it writes delta), then the dk/dv kernel on the same stream.
#define TN_BWD_PARAMS                                                                          \
  const void *q, const void *k, const void *v, const void *g, const void *stats, void *delta,  \
      void *dq, void *dk, void *dv, int dtype, int B, int N, int K, int head_dim, long long qb, \
      long long qh, long long qn, long long qd, long long kb, long long kh, long long kn,      \
      long long kd, long long vb, long long vh, long long vn, long long vd, long long gb,      \
      long long gh, long long gn, long long gd, long long dqb, long long dqh, long long dqn,   \
      long long dqd, long long dkb, long long dkh, long long dkn, long long dkd,               \
      long long dvb, long long dvh, long long dvn, long long dvd, float scale, void *stream,   \
      int device

#define TN_BWD_CALL                                                                            \
  BwdCall{q, k, v, nullptr, g, dq, dk, dv, static_cast<const float*>(stats),                   \
          static_cast<float*>(delta), B, N, K,                                                 \
          BwdViews{{qb, qh, qn, qd}, {kb, kh, kn, kd}, {vb, vh, vn, vd}, {0, 0, 0, 0},         \
                   {gb, gh, gn, gd}, {dqb, dqh, dqn, dqd}, {dkb, dkh, dkn, dkd},               \
                   {dvb, dvh, dvn, dvd}},                                                      \
          scale, static_cast<cudaStream_t>(stream)}

extern "C" int flash_attention_tn_bwd_dq(TN_BWD_PARAMS) {
  if (bad_args(head_dim, dtype)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_bwd<true>(TN_BWD_CALL, dtype, true, false);
}

extern "C" int flash_attention_tn_bwd_dkdv(TN_BWD_PARAMS) {
  if (bad_args(head_dim, dtype)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_bwd<true>(TN_BWD_CALL, dtype, false, true);
}

extern "C" int flash_attention_single_bwd_dq(TN_BWD_PARAMS) {
  if (bad_args(head_dim, dtype)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_dq(TN_BWD_CALL, dtype, attn_single_bwd_dq_f32_kernel,
                   attn_single_bwd_dq_bf16_kernel);
}

extern "C" int flash_attention_single_bwd_dkdv(TN_BWD_PARAMS) {
  if (bad_args(head_dim, dtype)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_dkdv(TN_BWD_CALL, dtype, attn_single_bwd_dkdv_f32_kernel,
                     attn_single_bwd_dkdv_bf16_kernel);
}

// K7's two kernels.  Each operand, o and dout included, is a (B, K, N, D)
// view given by its (b, h, n, d) strides in elements (bf16: unit head-dim
// stride and 16-byte rows, which the wrapper checks); lse is the forward's
// (B, K, N) f32 row logsumexp and delta a (B, K, N) f32 scratch, both
// contiguous.  Run the dq kernel first (it writes delta), then the dk/dv
// kernel on the same stream.
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
  BwdCall{q, k, v, o, g, dq, dk, dv, static_cast<const float*>(lse),                           \
          static_cast<float*>(delta), B, N, K,                                                 \
          BwdViews{{qb, qh, qn, qd}, {kb, kh, kn, kd}, {vb, vh, vn, vd}, {ob, oh, on, od},     \
                   {gb, gh, gn, gd}, {dqb, dqh, dqn, dqd}, {dkb, dkh, dkn, dkd},               \
                   {dvb, dvh, dvn, dvd}},                                                      \
          scale, static_cast<cudaStream_t>(stream)}

extern "C" int flash_attention_stream_bwd_dq(STREAM_BWD_PARAMS) {
  if (bad_args(head_dim, dtype)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_dq(STREAM_BWD_CALL, dtype, attn_stream_bwd_dq_f32_kernel,
                   attn_stream_bwd_dq_bf16_kernel);
}

extern "C" int flash_attention_stream_bwd_dkdv(STREAM_BWD_PARAMS) {
  if (bad_args(head_dim, dtype)) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  return launch_dkdv(STREAM_BWD_CALL, dtype, attn_stream_bwd_dkdv_f32_kernel,
                     attn_stream_bwd_dkdv_bf16_kernel);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
