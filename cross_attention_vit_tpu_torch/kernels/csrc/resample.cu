// Windowed 1-D affine resample along one axis of a batch of volumes, for
// Hopper (sm_90a).
//
// Replaces two TPU kernels of cross_attention_vit_tpu/kernels/resample.py:
// _resample_kernel_v2 (defined at :90, launched at :191; K3, the LU affine
// augmentation's path) and _resample_kernel (:36, launched at :241; K4, the
// same sum over all taps).  For volume v and output voxel x, a = axis:
//
//     out[x] = Σ_{d=−W..W+1} max(0, 1 − |rel(x) − d|) · src[x + d·e_a]
//     rel(x) = Σ_b cdelta[v, b] · (x_b − center_b)
//
// with src symmetric-padded by (W, W+1) along a (the edge voxel repeats) and
// f32 accumulation.  K3 cuts the output into tiles (a whole, dim 2 whole,
// the other dims of {0, 1} in blocks b0, b1) and sums only the taps d in
// [d_lo, d_lo + span), d_lo = clip(floor(min rel over the tile), −W,
// W + 2 − span); K4 (span < 0 here) sums d in [−W, W + 1].
//
// Design.  The hat weight max(0, 1 − |rel − d|) is nonzero only for
// d = floor(rel) and floor(rel) + 1, so every other tap adds an exact zero
// (the volumes are finite).  Each output voxel therefore reads just those
// two taps, keeps each only if it lies in the tile's window, and
// adds them in ascending order — the TPU kernel's sum, term for term.  The
// tile's min rel is rel at the tile corner picked by the signs of cdelta:
// each rounded product and sum is monotone in its inputs, so that corner's
// value is the exact minimum of the rounded per-voxel values.  The symmetric
// pad is an index reflection, so no padded copy is made.  A thread owns 8
// consecutive voxels of one row along dim 2: it computes the row's
// coordinates and tile window once, issues the 16 tap loads independently
// (2-byte loads need many in flight to cover the memory latency) and
// writes its 8 results with one 16-byte store.  Products and sums are
// written with __fmul_rn / __fadd_rn, so no FMA contraction changes the
// rounding of rel or of the accumulation.
//
// Bound.  Each voxel is read once and written once: 4 bytes per voxel in
// bf16, 8 in f32 (a live pass over 8 volumes of 128×128×64 in bf16: 33.6 MB,
// 10.0 us at 3.35 TB/s).  The arithmetic (rel, two hat weights, two FMAs,
// about 20 f32 operations per voxel) is below a third of that at the
// 67 TFLOP/s f32 rate, so the kernel is bound by bytes.  Neighbouring threads
// own neighbouring chunks along dim 2, so reads and writes coalesce along
// every axis.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int VEC = 8;           // voxels per thread, consecutive along dim 2

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const bf16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float rel_at(const float cd[3], float g0, float g1, float g2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(cd[0], g0), __fmul_rn(cd[1], g1)), __fmul_rn(cd[2], g2));
}

// numpy 'symmetric' padding as an index map (period 2n); in range, p itself
__device__ __forceinline__ int reflect(int p, int n) {
  if (p >= 0 && p < n) return p;
  p %= 2 * n;
  if (p < 0) p += 2 * n;
  return p >= n ? 2 * n - 1 - p : p;
}

struct Geometry {
  int V, D, H, W, axis, window, span, b0, b1;
  float c0, c1, c2;
};

// 8 results of one thread: one 16-byte (bf16) or two (f32) stores
__device__ __forceinline__ void store8(float* p, const float a[VEC]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(a[0], a[1], a[2], a[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(a[4], a[5], a[6], a[7]);
}
__device__ __forceinline__ void store8(bf16* p, const float a[VEC]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int j = 0; j < VEC / 2; ++j) h[j] = __floats2bfloat162_rn(a[2 * j], a[2 * j + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
resample_kernel(const T* __restrict__ src, T* __restrict__ out, const float* __restrict__ cdelta,
                Geometry geo) {
  // grid (⌈H·⌈W/VEC⌉ / THREADS⌉, D, V): a thread owns VEC voxels of one row
  const int per_row = (geo.W + VEC - 1) / VEC;
  const int chunk = blockIdx.x * THREADS + threadIdx.x;
  if (chunk >= geo.H * per_row) return;
  const int x0 = blockIdx.y, v = blockIdx.z;
  const int x1 = chunk / per_row, x2_0 = (chunk - x1 * per_row) * VEC;
  const float cd[3] = {cdelta[v * 3], cdelta[v * 3 + 1], cdelta[v * 3 + 2]};
  const float g0 = static_cast<float>(x0) - geo.c0, g1 = static_cast<float>(x1) - geo.c1;

  // the tile's minimum rel, the same for the whole row: the corner where
  // each term is smallest
  int d_lo = -geo.window, span = 2 * geo.window + 2;
  if (geo.span > 0) {
    const int t0 = x0 / geo.b0 * geo.b0, t1 = x1 / geo.b1 * geo.b1;
    const float y0 = static_cast<float>(cd[0] >= 0.f ? t0 : t0 + geo.b0 - 1);
    const float y1 = static_cast<float>(cd[1] >= 0.f ? t1 : t1 + geo.b1 - 1);
    const float y2 = static_cast<float>(cd[2] >= 0.f ? 0 : geo.W - 1);
    const float rmin = rel_at(cd, y0 - geo.c0, y1 - geo.c1, y2 - geo.c2);
    span = geo.span;
    d_lo = static_cast<int>(fminf(fmaxf(floorf(rmin), static_cast<float>(-geo.window)),
                                  static_cast<float>(geo.window + 2 - span)));
  }

  const long long row = ((static_cast<long long>(v) * geo.D + x0) * geo.H + x1) * geo.W;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    // the VEC voxels' taps are independent loads, all in flight together
    const int x2 = x2_0 + j;
    acc[j] = 0.f;
    if (x2 >= geo.W) continue;
    const float rel = rel_at(cd, g0, g1, static_cast<float>(x2) - geo.c2);
    int n, x;
    long long step;
    if (geo.axis == 0) {
      n = geo.D; x = x0; step = static_cast<long long>(geo.H) * geo.W;
    } else if (geo.axis == 1) {
      n = geo.H; x = x1; step = geo.W;
    } else {
      n = geo.W; x = x2; step = 1;
    }
    const T* line = src + (row + x2 - x * step);     // x_axis = 0
    const int d0 = static_cast<int>(floorf(rel));
#pragma unroll
    for (int d = d0; d <= d0 + 1; ++d) {
      if (d < d_lo || d >= d_lo + span) continue;
      const float w = fmaxf(0.f, 1.f - fabsf(rel - static_cast<float>(d)));
      acc[j] = __fadd_rn(acc[j], __fmul_rn(w, load(line + reflect(x + d, n) * step)));
    }
  }
  if (geo.W % VEC == 0) {
    store8(out + row + x2_0, acc);
  } else {
    for (int j = 0; j < VEC && x2_0 + j < geo.W; ++j) store(out + row + x2_0 + j, acc[j]);
  }
}

template <typename T>
cudaError_t launch(const void* src, void* out, const float* cdelta, const Geometry& geo,
                   cudaStream_t stream) {
  if (geo.D > 65535 || geo.V > 65535) return cudaErrorInvalidValue;
  const long long chunks = static_cast<long long>(geo.H) * ((geo.W + VEC - 1) / VEC);
  const dim3 grid(static_cast<unsigned>((chunks + THREADS - 1) / THREADS), geo.D, geo.V);
  resample_kernel<T><<<grid, THREADS, 0, stream>>>(static_cast<const T*>(src),
                                                   static_cast<T*>(out), cdelta, geo);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  src and out are contiguous (V, D, H, W),
// cdelta (V, 3) f32.  span < 0 sums all 2W+2 taps (K4); otherwise the tiles
// are b0 × b1 along dims 0, 1.  Returns a cudaError_t (0 on success); the
// launch does not synchronise.
extern "C" int resample_axis_windowed(const void* src, void* out, const void* cdelta, int dtype,
                                      int V, int D, int H, int W, int axis, int window, int span,
                                      int b0, int b1, float c0, float c1, float c2, void* stream,
                                      int device) {
  if ((dtype != 0 && dtype != 1) || axis < 0 || axis > 2 || window < 0 || span == 0 ||
      b0 <= 0 || b1 <= 0 || D % b0 || H % b1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Geometry geo{V, D, H, W, axis, window, span, b0, b1, c0, c1, c2};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cd = static_cast<const float*>(cdelta);
  return dtype == 0 ? launch<float>(src, out, cd, geo, s) : launch<bf16>(src, out, cd, geo, s);
}

extern "C" const char* resample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
