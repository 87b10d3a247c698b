// The epilogue of a low-precision linear, forward and backward, for Hopper
// (sm_90a).
//
// Replaces no TPU kernel: in the JAX package XLA fuses this work into the
// epilogue of the dot that precedes it (``ops/layers.py`` ``linear``, then
// GELU and dropout).  In the port the product stays a cuBLAS GEMM
// (``torch.mm`` with an f32 result) and everything between that product
// and the next GEMM's bf16 operand is these kernels.  For an f32 product p
// (rows × cols, contiguous), an f32 bias, keep = 1 − rate and the step's
// drawn bits r (uint8 or int32, one per element, drawn by torch.randint):
//
//   forward   y  = bf16(p + bias)                       one rounding
//             y' = bf16(gelu(f32 y))                    where GELU is asked
//             out = r < thresh ? bf16(f32 y' · inv) : 0 where dropout is asked
//   backward  d  = bit ? bf16(f32 g · inv) : 0          (dropout)
//             d' = bf16(gelu'(f32 d, f32 y))            (GELU)
//             dp = d',  dbias = Σ_rows f32 dp           (f32, fixed order)
//
// with inv = 1.0f / keep in f32.  These are the rounding points of the
// PyTorch chain the kernels replace (f32 add, ``.to(bf16)``, ``F.gelu``,
// ``torch.where(mask, x / keep, 0)`` and its autograd backward), as that
// chain computes them on CUDA: torch divides a tensor by a Python scalar as
// a product with the scalar's f32 reciprocal; over every finite bf16 value
// that product rounds to the bf16 of the quotient at the keeps the models
// use (0.75 and 0.9), so it also equals the CPU's division there.  GELU is
// PyTorch's CUDA formula (tanh or erf, in f32), written term for term.
//
// The forward writes the bf16 output, the pre-GELU bf16 value (only where
// the backward needs it) and the keep mask packed one bit an element (bit k
// of byte j of a row is column 8j + k), so that the backward never reads
// the draws.  The backward writes dp, the product's cotangent, in bf16, so
// that no f32 cotangent exists in device memory, and each block writes the
// f32 column sums of its rows; ``linear_epilogue_bias_reduce`` adds those
// partial sums in a fixed order.  No atomics: two identical calls give
// identical bits.
//
// Bound.  Bytes: the work per element is a few dozen f32 operations (tanhf
// or erff at most), far below the bytes' time at 67 TFLOP/s.  Forward: 4
// bytes of p read, 2 written, 2 more for the pre-GELU value, 1 (uint8) or 4
// (int32) of draws read and 1/8 of mask written.  Backward: 2 of g, 2 of the
// pre-GELU value, 1/8 of mask read, 2 of dp written.  A thread handles 8
// consecutive columns of a row (16-byte loads and stores where the width
// is a multiple of 8 and the pointers are aligned; element by element with
// a masked tail otherwise, as for the heads' 2 classes); a warp covers 256
// consecutive columns, so every load is coalesced.
//
// Names.  The kernels carry "elementwise" and "reduce" in their names, the
// marks by which the benchmark's frozen kernel classes count them among the
// copies, casts and elementwise operations they replace.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int VEC = 8;    // columns a thread handles in a row: one mask byte
constexpr int BX = 32;    // threads of a block along a row (256 columns)
constexpr int BY = 8;     // threads of a block across rows
constexpr int MAX_GRID_Y = 65535;

enum Gelu : int { GELU_NONE = 0, GELU_TANH = 1, GELU_ERF = 2 };
enum Draw : int { DRAW_NONE = 0, DRAW_U8 = 1, DRAW_I32 = 2 };

__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T round_to(float v);
template <>
__device__ __forceinline__ bf16 round_to<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half round_to<__half>(float v) { return __float2half_rn(v); }

// PyTorch's GeluCUDAKernelImpl, in f32
template <int GELU>
__device__ __forceinline__ float gelu_fwd(float x) {
  if constexpr (GELU == GELU_TANH) {
    constexpr float kBeta = M_SQRT2 * M_2_SQRTPI * 0.5;
    constexpr float kKappa = 0.044715;
    float x_cube = x * x * x;
    float inner = kBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.0f + tanhf(inner));
  } else {
    constexpr float kAlpha = M_SQRT1_2;
    return x * 0.5f * (1.0f + erff(x * kAlpha));
  }
}

// PyTorch's GeluBackwardCUDAKernelImpl, in f32
template <int GELU>
__device__ __forceinline__ float gelu_bwd(float dy, float x) {
  if constexpr (GELU == GELU_TANH) {
    constexpr float kBeta = M_SQRT2 * M_2_SQRTPI * 0.5;
    constexpr float kKappa = 0.044715;
    float x_sq = x * x;
    float x_cube = x_sq * x;
    float inner = kBeta * (x + kKappa * x_cube);
    float tanh_inner = tanhf(inner);
    float left = 0.5f * x;
    float right = 1.0f + tanh_inner;
    float left_derivative = 0.5f * right;
    float tanh_derivative = 1.0f - tanh_inner * tanh_inner;
    float inner_derivative = kBeta * (1.0f + 3.0f * kKappa * x_sq);
    float right_derivative = left * tanh_derivative * inner_derivative;
    return dy * (left_derivative + right_derivative);
  } else {
    constexpr float kBeta = M_2_SQRTPI * M_SQRT1_2 * 0.5;
    constexpr float kAlpha = M_SQRT1_2;
    const float cdf = 0.5f * (1.0f + erff(x * kAlpha));
    const float pdf = expf(-0.5f * x * x) * kBeta;
    return dy * (cdf + x * pdf);
  }
}

// 8 consecutive elements of a row: 16-byte accesses when VECTOR, else one
// at a time for the first n
template <bool VECTOR>
__device__ __forceinline__ void load8_f32(const float* src, int n, float v[VEC]) {
  if constexpr (VECTOR) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = k < n ? src[k] : 0.f;
  }
}

template <bool VECTOR, typename T>
__device__ __forceinline__ void load8(const T* src, int n, float v[VEC]) {
  if constexpr (VECTOR) {
    alignas(16) T h[VEC];
    *reinterpret_cast<uint4*>(h) = *reinterpret_cast<const uint4*>(src);
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = to_float(h[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = k < n ? to_float(src[k]) : 0.f;
  }
}

template <bool VECTOR, typename T>
__device__ __forceinline__ void store8(T* dst, int n, const T h[VEC]) {
  if constexpr (VECTOR) {
    alignas(16) T w[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) w[k] = h[k];
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(w);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (k < n) dst[k] = h[k];
  }
}

template <bool VECTOR, int DRAW>
__device__ __forceinline__ void load_draws(const void* draws, int64_t at, int n, int r[VEC]) {
  if constexpr (DRAW == DRAW_U8) {
    const uint8_t* src = static_cast<const uint8_t*>(draws) + at;
    if constexpr (VECTOR) {
      alignas(8) uint8_t b[VEC];
      *reinterpret_cast<uint2*>(b) = *reinterpret_cast<const uint2*>(src);
#pragma unroll
      for (int k = 0; k < VEC; ++k) r[k] = b[k];
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) r[k] = k < n ? src[k] : 0;
    }
  } else {
    const int32_t* src = static_cast<const int32_t*>(draws) + at;
    if constexpr (VECTOR) {
      const int4 a = reinterpret_cast<const int4*>(src)[0];
      const int4 b = reinterpret_cast<const int4*>(src)[1];
      r[0] = a.x; r[1] = a.y; r[2] = a.z; r[3] = a.w;
      r[4] = b.x; r[5] = b.y; r[6] = b.z; r[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) r[k] = k < n ? src[k] : 0;
    }
  }
}

struct Fwd {
  const float* p;       // (rows, cols) f32 product
  const float* bias;    // (cols,) f32, or null
  const void* draws;    // (rows, cols) uint8 or int32, or null
  int thresh;           // keep where r < thresh
  float inv_keep;       // 1 / keep in f32
  void* out;            // (rows, cols) bf16 or f16
  void* pre;            // (rows, cols) pre-GELU value, or null
  uint8_t* mask;        // (rows, chunks) packed keep mask, or null
  int64_t rows;
  int cols, chunks;     // chunks = ceil(cols / 8)
};

// One thread: 8 columns of one row at a time; the block is BX chunks of a
// row by BY rows, and walks down the rows by the grid's height.
template <typename T, int GELU, int DRAW, bool VECTOR>
__global__ void __launch_bounds__(BX * BY) linear_epilogue_elementwise_fwd(const Fwd f) {
  const int j = blockIdx.x * BX + threadIdx.x;
  if (j >= f.chunks) return;
  const int col0 = j * VEC;
  const int n = min(VEC, f.cols - col0);
  float b[VEC];
  if (f.bias != nullptr) {
    load8_f32<VECTOR>(f.bias + col0, n, b);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) b[k] = 0.f;
  }
  T* out = static_cast<T*>(f.out);
  T* pre = static_cast<T*>(f.pre);
  for (int64_t row = (int64_t)blockIdx.y * BY + threadIdx.y; row < f.rows;
       row += (int64_t)gridDim.y * BY) {
    const int64_t at = row * f.cols + col0;
    float v[VEC];
    load8_f32<VECTOR>(f.p + at, n, v);
    int r[VEC];
    if constexpr (DRAW != DRAW_NONE) load_draws<VECTOR, DRAW>(f.draws, at, n, r);
    T y[VEC], q[VEC];
    uint32_t bits = 0;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      T h = round_to<T>(f.bias != nullptr ? __fadd_rn(v[k], b[k]) : v[k]);
      if constexpr (GELU != GELU_NONE) {
        q[k] = h;
        h = round_to<T>(gelu_fwd<GELU>(to_float(h)));
      }
      if constexpr (DRAW != DRAW_NONE) {
        const bool kept = r[k] < f.thresh;
        bits |= uint32_t(kept) << k;
        h = kept ? round_to<T>(__fmul_rn(to_float(h), f.inv_keep)) : round_to<T>(0.f);
      }
      y[k] = h;
    }
    store8<VECTOR>(out + at, n, y);
    if constexpr (GELU != GELU_NONE) {
      if (pre != nullptr) store8<VECTOR>(pre + at, n, q);
    }
    if constexpr (DRAW != DRAW_NONE) {
      if (f.mask != nullptr) f.mask[row * f.chunks + j] = static_cast<uint8_t>(bits & ((1u << n) - 1));
    }
  }
}

struct Bwd {
  const void* g;        // (rows, cols) cotangent of the output
  const uint8_t* mask;  // packed keep mask, or null (no dropout)
  const void* pre;      // pre-GELU value, or null (no GELU)
  float inv_keep;
  void* dp;             // (rows, cols) cotangent of the product, or null (it is g)
  float* partial;       // (parts, cols) f32 column sums of each block's rows, or null
  int64_t rows;
  int cols, chunks, rows_per_part;
};

// Block (x, y): BX chunks of columns over rows [y·rows_per_part, (y+1)·
// rows_per_part).  Each thread sums its rows in order, then the block adds
// its BY threads' sums of a column in order.
template <typename T, int GELU, bool DROP, bool VECTOR>
__global__ void __launch_bounds__(BX * BY) linear_epilogue_elementwise_bwd(const Bwd f) {
  __shared__ float sums[BY][BX * VEC];
  const int j = blockIdx.x * BX + threadIdx.x;
  const int col0 = j * VEC;
  const int n = j < f.chunks ? min(VEC, f.cols - col0) : 0;
  const int64_t r0 = (int64_t)blockIdx.y * f.rows_per_part;
  const int64_t r1 = r0 + f.rows_per_part < f.rows ? r0 + f.rows_per_part : f.rows;
  const T* g = static_cast<const T*>(f.g);
  const T* pre = static_cast<const T*>(f.pre);
  T* dp = static_cast<T*>(f.dp);
  float acc[VEC];
#pragma unroll
  for (int k = 0; k < VEC; ++k) acc[k] = 0.f;
  if (n > 0) {
    for (int64_t row = r0 + threadIdx.y; row < r1; row += BY) {
      const int64_t at = row * f.cols + col0;
      float d[VEC];
      load8<VECTOR>(g + at, n, d);
      if constexpr (DROP) {
        const uint32_t bits = f.mask[row * f.chunks + j];
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          d[k] = (bits >> k) & 1u ? to_float(round_to<T>(__fmul_rn(d[k], f.inv_keep))) : 0.f;
      }
      if constexpr (GELU != GELU_NONE) {
        float x[VEC];
        load8<VECTOR>(pre + at, n, x);
#pragma unroll
        for (int k = 0; k < VEC; ++k) d[k] = to_float(round_to<T>(gelu_bwd<GELU>(d[k], x[k])));
      }
      if constexpr (DROP || GELU != GELU_NONE) {
        T h[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) h[k] = round_to<T>(d[k]);
        store8<VECTOR>(dp + at, n, h);
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k) acc[k] += d[k];
    }
  }
  if (f.partial == nullptr) return;
#pragma unroll
  for (int k = 0; k < VEC; ++k) sums[threadIdx.y][threadIdx.x * VEC + k] = acc[k];
  __syncthreads();
  const int t = threadIdx.y * BX + threadIdx.x;     // one of the block's BX·VEC columns
  const int col = blockIdx.x * BX * VEC + t;
  if (col < f.cols) {
    float s = 0.f;
#pragma unroll
    for (int y = 0; y < BY; ++y) s += sums[y][t];
    f.partial[(int64_t)blockIdx.y * f.cols + col] = s;
  }
}

// dbias[c] = Σ_i partial[i, c]: BY threads of a column take every BY-th
// part in order, then their sums are added in order.
__global__ void __launch_bounds__(BX * BY) linear_epilogue_bias_reduce(const float* partial,
                                                                     float* dbias, int parts,
                                                                     int cols) {
  __shared__ float sums[BY][BX + 1];
  const int col = blockIdx.x * BX + threadIdx.x;
  float s = 0.f;
  if (col < cols)
    for (int i = threadIdx.y; i < parts; i += BY) s += partial[(int64_t)i * cols + col];
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < cols) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < BY; ++y) t += sums[y][threadIdx.x];
    dbias[col] = t;
  }
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T, int GELU, int DRAW>
cudaError_t launch_fwd(const Fwd& f, bool vector, cudaStream_t s) {
  const dim3 block(BX, BY);
  const int64_t height = (f.rows + BY - 1) / BY;
  const dim3 grid((f.chunks + BX - 1) / BX, (unsigned)(height < MAX_GRID_Y ? height : MAX_GRID_Y));
  if (vector)
    linear_epilogue_elementwise_fwd<T, GELU, DRAW, true><<<grid, block, 0, s>>>(f);
  else
    linear_epilogue_elementwise_fwd<T, GELU, DRAW, false><<<grid, block, 0, s>>>(f);
  return cudaGetLastError();
}

template <typename T, int GELU>
cudaError_t launch_fwd(const Fwd& f, int draw, bool vector, cudaStream_t s) {
  switch (draw) {
    case DRAW_NONE: return launch_fwd<T, GELU, DRAW_NONE>(f, vector, s);
    case DRAW_U8: return launch_fwd<T, GELU, DRAW_U8>(f, vector, s);
    default: return launch_fwd<T, GELU, DRAW_I32>(f, vector, s);
  }
}

template <typename T>
cudaError_t launch_fwd(const Fwd& f, int gelu, int draw, bool vector, cudaStream_t s) {
  switch (gelu) {
    case GELU_NONE: return launch_fwd<T, GELU_NONE>(f, draw, vector, s);
    case GELU_TANH: return launch_fwd<T, GELU_TANH>(f, draw, vector, s);
    default: return launch_fwd<T, GELU_ERF>(f, draw, vector, s);
  }
}

template <typename T, int GELU, bool DROP>
cudaError_t launch_bwd(const Bwd& f, bool vector, int parts, cudaStream_t s) {
  const dim3 grid((f.chunks + BX - 1) / BX, parts);
  if (vector)
    linear_epilogue_elementwise_bwd<T, GELU, DROP, true><<<grid, dim3(BX, BY), 0, s>>>(f);
  else
    linear_epilogue_elementwise_bwd<T, GELU, DROP, false><<<grid, dim3(BX, BY), 0, s>>>(f);
  return cudaGetLastError();
}

template <typename T, int GELU>
cudaError_t launch_bwd(const Bwd& f, bool drop, bool vector, int parts, cudaStream_t s) {
  return drop ? launch_bwd<T, GELU, true>(f, vector, parts, s)
              : launch_bwd<T, GELU, false>(f, vector, parts, s);
}

template <typename T>
cudaError_t launch_bwd(const Bwd& f, int gelu, bool drop, bool vector, int parts,
                       cudaStream_t s) {
  switch (gelu) {
    case GELU_NONE: return launch_bwd<T, GELU_NONE>(f, drop, vector, parts, s);
    case GELU_TANH: return launch_bwd<T, GELU_TANH>(f, drop, vector, parts, s);
    default: return launch_bwd<T, GELU_ERF>(f, drop, vector, parts, s);
  }
}

}  // namespace

// Forward.  dtype 1 bf16, 2 f16 (of out and pre); gelu 0 none, 1 tanh, 2
// erf; draw 0 none, 1 uint8, 2 int32.  bias, pre and mask may be null (no
// bias; nothing saved for a backward).  p, draws, out and pre contiguous
// (rows, cols), mask contiguous (rows, ceil(cols / 8)).
extern "C" int linear_epilogue_fwd(const void* p, const void* bias, const void* draws, int draw,
                                   int thresh, float keep, void* out, void* pre, void* mask,
                                   int dtype, int gelu, long long rows, int cols, void* stream,
                                   int device) {
  if ((dtype != 1 && dtype != 2) || gelu < 0 || gelu > 2 || draw < 0 || draw > 2 ||
      (draw != DRAW_NONE && (draws == nullptr || !(keep > 0.f))) || rows < 0 || cols <= 0 ||
      p == nullptr || out == nullptr)
    return cudaErrorInvalidValue;
  if (rows == 0) return cudaSuccess;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int chunks = (cols + VEC - 1) / VEC;
  const Fwd f{static_cast<const float*>(p), static_cast<const float*>(bias), draws, thresh,
              1.0f / keep, out, pre, static_cast<uint8_t*>(mask), rows, cols, chunks};
  const bool vector = cols % VEC == 0 && aligned16(p) && aligned16(bias) && aligned16(draws) &&
                      aligned16(out) && aligned16(pre);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? launch_fwd<bf16>(f, gelu, draw, vector, s)
                    : launch_fwd<__half>(f, gelu, draw, vector, s);
}

// Backward.  g (rows, cols) contiguous; mask null without dropout, pre
// null without GELU; dp (rows, cols) is written where either is given;
// dbias (cols,) f32, or null, with partial scratch of (ceil(rows /
// rows_per_part), cols) f32.
extern "C" int linear_epilogue_bwd(const void* g, const void* mask, const void* pre, float keep,
                                   void* dp, void* partial, void* dbias, int dtype, int gelu,
                                   long long rows, int cols, int rows_per_part, void* stream,
                                   int device) {
  const bool drop = mask != nullptr;
  const bool write = drop || gelu != GELU_NONE;
  if ((dtype != 1 && dtype != 2) || gelu < 0 || gelu > 2 || (gelu != GELU_NONE) != (pre != nullptr) ||
      (drop && !(keep > 0.f)) || (write && dp == nullptr) || (dbias == nullptr) != (partial == nullptr) ||
      (!write && dbias == nullptr) || g == nullptr || rows <= 0 || cols <= 0 || rows_per_part <= 0)
    return cudaErrorInvalidValue;
  const long long parts = (rows + rows_per_part - 1) / rows_per_part;
  if (parts > MAX_GRID_Y) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int chunks = (cols + VEC - 1) / VEC;
  const Bwd f{g, static_cast<const uint8_t*>(mask), pre, drop ? 1.0f / keep : 1.0f, dp,
              static_cast<float*>(partial), rows, cols, chunks, rows_per_part};
  const bool vector = cols % VEC == 0 && aligned16(g) && aligned16(pre) && aligned16(dp);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = dtype == 1 ? launch_bwd<bf16>(f, gelu, drop, vector, (int)parts, s)
                   : launch_bwd<__half>(f, gelu, drop, vector, (int)parts, s);
  if (err != cudaSuccess || dbias == nullptr) return err;
  linear_epilogue_bias_reduce<<<(cols + BX - 1) / BX, dim3(BX, BY), 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dbias), (int)parts, cols);
  return cudaGetLastError();
}

extern "C" const char* linear_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
