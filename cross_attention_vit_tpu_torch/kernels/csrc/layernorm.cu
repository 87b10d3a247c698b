// LayerNorm over the last axis, forward and backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel: in the JAX package XLA fuses ``ops/layers.py``
// ``layernorm`` (the f32 upcast, mean, centred variance, rsqrt, scale and
// bias, the cast back) into the ops around it.  The port ran PyTorch's f32
// ``F.layer_norm`` between two casts, and autograd two more casts in the
// backward.  For a row x of C values (bf16, f16 or f32), f32 weight w and
// bias b:
//
//   forward   mean = Σx / C,  var = Σ(x − mean)² / C,  rstd = rsqrt(var + eps)
//             x̂ = (x − mean)·rstd,  y = x̂·w + b                  rounded once
//   backward  g = dy·w,  dx = rstd·(g − Σg / C − x̂·Σ(g·x̂) / C)    rounded once
//             dw = Σ_rows dy·x̂,  db = Σ_rows dy                   f32, fixed order
//
// all in f32, the statistics in two passes over the row as the JAX
// reference computes them.  The forward writes no statistics: the backward
// reads x anyway and recomputes mean and rstd with the forward's code, and
// gathers Σg and Σg·(x − mean) in the same two passes, so that a backward
// row also takes two reductions.
//
// Bound.  Bytes: a few f32 operations an element, far below the bytes'
// time.  The forward reads x and writes y (2 + 2 bytes an element in bf16);
// the backward reads x and dy and writes dx (6 bytes), plus per-block
// partial column sums of (dy·x̂, dy), which ``layer_norm_bwd_param_sums``
// adds in a fixed order (no atomics: two calls give equal bits).
//
// Design.  A lane reads a row in chunks of 8 columns (16-byte accesses in
// bf16 and f16, two in f32) and holds them in registers; the row's LANES
// lanes reduce by shuffles within their sub-group.  The width picks LANES
// and the chunks a lane holds (ITERS), so that a lane has 3-6 loads in
// flight and a narrow row does not take a warp or a block of its own:
//   C = 48: 2 lanes × 3 chunks, 16 rows a warp;  C = 96: 4 × 3, 8 rows;
//   C = 192: 8 × 3, 4 rows;  C = 384: 16 × 3, 2 rows;
//   C = 768, 1024, 1536: a row a warp, 3, 4 or 6 chunks a lane.
// Wider rows (C > 1536) are read in slabs of 32 × 6 chunks, again from L2
// for each pass, and their column sums go to each warp's own slice of the
// partial sums.  A width that is not a multiple of 8, or rows that are not
// 16-byte aligned, take element-wise accesses with a masked tail.  Blocks
// walk the rows with a stride of the grid, which fills the card once, so
// that a lane's columns stay the same across its rows: the backward keeps
// their weight and their column sums in registers, and a block writes one
// row of partial sums.  (Column sums in shared memory, the forward's
// parameters in registers, two rows at once or a register cap for more
// blocks an SM were each no faster at C = 1024 on an H100.)
//
// Names.  Every kernel holds "layer_norm", the mark by which the
// benchmark's frozen kernel classes count PyTorch's LayerNorm kernels.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int VEC = 8;                                   // columns of a chunk
constexpr int WARPS = 4;                                 // warps a block
constexpr int THREADS = WARPS * 32;
constexpr int MAX_ITERS = 6;                             // chunks a lane holds
constexpr unsigned FULL = 0xffffffffu;

enum Dtype : int { BF16 = 1, F16 = 2, F32 = 3 };

template <typename T>
struct Chunk {
  alignas(16) T v[VEC];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 round_to<bf16>(float v) { return __float2bfloat16_rn(v); }
template <>
__device__ __forceinline__ __half round_to<__half>(float v) { return __float2half_rn(v); }

// the chunk of a row at column c0 (< cols): 16-byte accesses when VECTOR
// (then cols is a multiple of 8), else element by element, zero past cols
template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, int c0, int cols, bool vector,
                                           Chunk<T>& c) {
  if (vector) {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(Chunk<T>) / 16); ++i)
      reinterpret_cast<uint4*>(c.v)[i] = reinterpret_cast<const uint4*>(row + c0)[i];
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) c.v[k] = c0 + k < cols ? row[c0 + k] : round_to<T>(0.f);
  }
}

template <typename T>
__device__ __forceinline__ void zero_chunk(Chunk<T>& c) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) c.v[k] = round_to<T>(0.f);
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* row, int c0, int cols, bool vector,
                                            const Chunk<T>& c) {
  if (vector) {
#pragma unroll
    for (int i = 0; i < (int)(sizeof(Chunk<T>) / 16); ++i)
      reinterpret_cast<uint4*>(row + c0)[i] = reinterpret_cast<const uint4*>(c.v)[i];
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      if (c0 + k < cols) row[c0 + k] = c.v[k];
  }
}

// 8 f32 parameters from column c0 (< cols)
__device__ __forceinline__ void load_params(const float* p, int c0, int cols, bool vector,
                                            float v[VEC]) {
  if (vector) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(p + c0));
    const float4 b = __ldg(reinterpret_cast<const float4*>(p + c0) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) v[k] = c0 + k < cols ? __ldg(p + c0 + k) : 0.f;
  }
}

// the sum over a row's LANES lanes (aligned groups of the warp); every lane
// of the group gets the same bits
template <int LANES>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = LANES / 2; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  return v;
}

// A warp holds 32 / LANES rows at a time; lane `sub` of a row's group holds
// chunks (s·ITERS + k)·LANES + sub of slab s.  RESIDENT: the row is one
// slab, loaded once.
template <typename T, int LANES, int ITERS>
struct Row {
  Chunk<T> c[ITERS];
  const T* row;
  int sub, cols;
  bool active, vector;

  __device__ __forceinline__ int col0(int s, int k) const {
    return ((s * ITERS + k) * LANES + sub) * VEC;
  }
  __device__ __forceinline__ bool holds(int s, int k) const { return active && col0(s, k) < cols; }
  __device__ __forceinline__ void load(int s) {
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      if (holds(s, k))
        load_chunk(row, col0(s, k), cols, vector, c[k]);
      else
        zero_chunk(c[k]);
    }
  }
};

// The weight or the bias at a lane's chunks: HOLD (rows held whole, whose
// chunks are the same for every row) keeps them in registers across the
// rows, else each use reads them from L1.
template <int ITERS, bool HOLD>
struct Params {
  float v[HOLD ? ITERS : 1][VEC];
  const float* p;
  int cols;
  bool vector;

  template <typename R>
  __device__ __forceinline__ void hold(const R& r) {
    if constexpr (HOLD) {
#pragma unroll
      for (int k = 0; k < ITERS; ++k) {
        if (r.col0(0, k) < cols) {
          load_params(p, r.col0(0, k), cols, vector, v[k]);
        } else {
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[k][e] = 0.f;
        }
      }
    }
  }
  __device__ __forceinline__ void get(int k, int c0, float out[VEC]) const {
    if constexpr (HOLD) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) out[e] = v[k][e];
    } else {
      load_params(p, c0, cols, vector, out);
    }
  }
};

// mean and rstd of the row x: its sum, then its centred squares, a chunk
// at a time (the forward's and the backward's code).  GRAD: in the same
// passes also sg = Σ g·w and sgd = Σ g·w·(x − mean) of the cotangent's row
// g, so that the backward reduces over a row twice, as the forward does.
template <bool GRAD, bool RESIDENT, typename T, int LANES, int ITERS, typename W>
__device__ __forceinline__ void row_stats(Row<T, LANES, ITERS>& x, Row<T, LANES, ITERS>& g,
                                          const W& w, int slabs, float eps, float& mean,
                                          float& rstd, float& sg, float& sgd) {
  float sum = 0.f;
  sg = 0.f;
  for (int s = 0; s < slabs; ++s) {
    if (!RESIDENT) {
      x.load(s);
      if constexpr (GRAD) g.load(s);
    }
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) part += to_float(x.c[k].v[e]);
      sum += part;
      if constexpr (GRAD) {
        if (x.holds(s, k)) {
          float wv[VEC], pg = 0.f;
          w.get(k, x.col0(s, k), wv);
#pragma unroll
          for (int e = 0; e < VEC; ++e) pg += to_float(g.c[k].v[e]) * wv[e];
          sg += pg;
        }
      }
    }
  }
  mean = group_sum<LANES>(sum) / (float)x.cols;
  float sq = 0.f;
  sgd = 0.f;
  for (int s = 0; s < slabs; ++s) {
    if (!RESIDENT) {
      x.load(s);
      if constexpr (GRAD) g.load(s);
    }
#pragma unroll
    for (int k = 0; k < ITERS; ++k) {
      const int c0 = x.col0(s, k);
      float part = 0.f;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = to_float(x.c[k].v[e]) - mean;
        if (c0 + e < x.cols) part += d * d;
      }
      sq += part;
      if constexpr (GRAD) {
        if (x.holds(s, k)) {       // g is zero past cols
          float wv[VEC], pgd = 0.f;
          w.get(k, c0, wv);
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            pgd += to_float(g.c[k].v[e]) * wv[e] * (to_float(x.c[k].v[e]) - mean);
          sgd += pgd;
        }
      }
    }
  }
  rstd = rsqrtf(group_sum<LANES>(sq) / (float)x.cols + eps);
  if constexpr (GRAD) {
    sg = group_sum<LANES>(sg);
    sgd = group_sum<LANES>(sgd);
  }
}

struct LnFwd {
  const void* x;        // (rows, cols)
  const float* weight;  // (cols,)
  const float* bias;    // (cols,)
  void* y;              // (rows, cols), x's dtype
  int64_t rows;
  int cols, slabs;
  float eps;
  bool vector;
};

template <typename T, int LANES, int ITERS, bool RESIDENT>
__global__ void __launch_bounds__(THREADS) layer_norm_fwd_kernel(const LnFwd f) {
  constexpr int GROUPS = 32 / LANES;
  const int lane = threadIdx.x % 32;
  const int slabs = RESIDENT ? 1 : f.slabs;
  const int64_t step = (int64_t)gridDim.x * WARPS * GROUPS;
  Row<T, LANES, ITERS> x;
  x.sub = lane % LANES;
  x.cols = f.cols;
  x.vector = f.vector;
  const Params<ITERS, false> w{{}, f.weight, f.cols, f.vector}, b{{}, f.bias, f.cols, f.vector};
  for (int64_t base = ((int64_t)blockIdx.x * WARPS + threadIdx.x / 32) * GROUPS; base < f.rows;
       base += step) {
    const int64_t row = base + lane / LANES;
    x.active = row < f.rows;
    x.row = static_cast<const T*>(f.x) + (x.active ? row : 0) * f.cols;
    if (RESIDENT) x.load(0);
    float mean, rstd, unused_sg, unused_sgd;
    row_stats<false, RESIDENT>(x, x, w, slabs, f.eps, mean, rstd, unused_sg, unused_sgd);
    T* y = static_cast<T*>(f.y) + (x.active ? row : 0) * f.cols;
    for (int s = 0; s < slabs; ++s) {
      if (!RESIDENT) x.load(s);
#pragma unroll
      for (int k = 0; k < ITERS; ++k) {
        if (!x.holds(s, k)) continue;
        const int c0 = x.col0(s, k);
        float wv[VEC], bv[VEC];
        w.get(k, c0, wv);
        b.get(k, c0, bv);
        Chunk<T> out;
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          out.v[e] = round_to<T>((to_float(x.c[k].v[e]) - mean) * rstd * wv[e] + bv[e]);
        store_chunk(y, c0, f.cols, f.vector, out);
      }
    }
  }
}

struct LnBwd {
  const void* dy;       // (rows, cols), x's dtype
  const void* x;        // (rows, cols)
  const float* weight;  // (cols,)
  void* dx;             // (rows, cols), x's dtype
  float* partial;       // (parts, 2, cols): Σ dy·x̂ and Σ dy of a block (a warp in slabs)
  int64_t rows;
  int cols, slabs;
  float eps;
  bool vector;
};

template <typename T, int LANES, int ITERS, bool RESIDENT>
__global__ void __launch_bounds__(THREADS) layer_norm_bwd_kernel(const LnBwd f) {
  constexpr int GROUPS = 32 / LANES;
  __shared__ float sums[RESIDENT ? 2 * LANES * ITERS * VEC : 1];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int slabs = RESIDENT ? 1 : f.slabs;
  const int64_t step = (int64_t)gridDim.x * WARPS * GROUPS;
  // RESIDENT: this lane's column sums over its rows; else the warp's slice
  float acc_w[RESIDENT ? ITERS : 1][VEC], acc_b[RESIDENT ? ITERS : 1][VEC];
#pragma unroll
  for (int k = 0; k < (RESIDENT ? ITERS : 1); ++k)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc_w[k][e] = acc_b[k][e] = 0.f;
  float* mine = f.partial + ((int64_t)blockIdx.x * WARPS + warp) * 2 * f.cols;
  if (!RESIDENT) {
    for (int c = lane; c < 2 * f.cols; c += 32) mine[c] = 0.f;
    __syncwarp();
  }
  Row<T, LANES, ITERS> x, g;
  x.sub = g.sub = lane % LANES;
  x.cols = g.cols = f.cols;
  x.vector = g.vector = f.vector;
  Params<ITERS, RESIDENT> w{{}, f.weight, f.cols, f.vector};
  w.hold(x);
  for (int64_t base = ((int64_t)blockIdx.x * WARPS + warp) * GROUPS; base < f.rows;
       base += step) {
    const int64_t row = base + lane / LANES;
    x.active = g.active = row < f.rows;
    const int64_t at = (x.active ? row : 0) * f.cols;
    x.row = static_cast<const T*>(f.x) + at;
    g.row = static_cast<const T*>(f.dy) + at;
    if (RESIDENT) {
      x.load(0);
      g.load(0);
    }
    float mean, rstd, sg, sgd;
    row_stats<true, RESIDENT>(x, g, w, slabs, f.eps, mean, rstd, sg, sgd);
    const float mg = sg / (float)f.cols;               // mean of g·w
    const float mgx = rstd * sgd / (float)f.cols;      // mean of g·w·x̂
    T* dx = static_cast<T*>(f.dx) + at;
    for (int s = 0; s < slabs; ++s) {
      if (!RESIDENT) {
        x.load(s);
        g.load(s);
      }
#pragma unroll
      for (int k = 0; k < ITERS; ++k) {
        if (!x.holds(s, k)) continue;
        const int c0 = x.col0(s, k);
        float wv[VEC];
        w.get(k, c0, wv);
        Chunk<T> out;
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float xh = (to_float(x.c[k].v[e]) - mean) * rstd;
          const float d = to_float(g.c[k].v[e]);
          out.v[e] = round_to<T>((d * wv[e] - mg - xh * mgx) * rstd);
          if constexpr (RESIDENT) {
            acc_w[k][e] += d * xh;
            acc_b[k][e] += d;
          } else {
            if (c0 + e < f.cols) {
              mine[c0 + e] += d * xh;
              mine[f.cols + c0 + e] += d;
            }
          }
        }
        store_chunk(dx, c0, f.cols, f.vector, out);
      }
    }
  }
  if constexpr (RESIDENT) {
    // the warp's rows: a butterfly over its groups (every group gets the
    // same bits), then the warps in order through shared memory
#pragma unroll
    for (int k = 0; k < ITERS; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e)
#pragma unroll
        for (int off = LANES; off < 32; off <<= 1) {
          acc_w[k][e] += __shfl_xor_sync(FULL, acc_w[k][e], off);
          acc_b[k][e] += __shfl_xor_sync(FULL, acc_b[k][e], off);
        }
    for (int wp = 0; wp < WARPS; ++wp) {
      if (warp == wp && lane < LANES) {
#pragma unroll
        for (int k = 0; k < ITERS; ++k) {
          const int c0 = x.col0(0, k);
#pragma unroll
          for (int e = 0; e < VEC; ++e) {
            const int col = c0 + e;
            if (col < f.cols) {
              sums[col] = wp ? sums[col] + acc_w[k][e] : acc_w[k][e];
              sums[f.cols + col] = wp ? sums[f.cols + col] + acc_b[k][e] : acc_b[k][e];
            }
          }
        }
      }
      __syncthreads();
    }
    float* out = f.partial + (int64_t)blockIdx.x * 2 * f.cols;
    for (int c = threadIdx.x; c < 2 * f.cols; c += THREADS) out[c] = sums[c];
  }
}

// out[c] = Σ_i partial[i, c] over n = 2·cols columns: 8 threads of a column
// take every 8th part in order, then their sums are added in order
__global__ void __launch_bounds__(256) layer_norm_bwd_param_sums(const float* partial, float* out,
                                                                 int parts, int n) {
  __shared__ float sums[8][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (col < n)
    for (int i = threadIdx.y; i < parts; i += 8) s += partial[(int64_t)i * n + col];
  sums[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && col < n) {
    float t = 0.f;
#pragma unroll
    for (int y = 0; y < 8; ++y) t += sums[y][threadIdx.x];
    out[col] = t;
  }
}

// The width's layout: LANES the smallest power of two with 3·LANES ≥
// chunks (at most 32) and 3 chunks a lane, which fits the Swin widths
// exactly; a row a warp takes 3, 4 or 6 chunks a lane; past 32 × 6 chunks,
// slabs of 32 × 6.
struct Layout {
  int lanes, iters, slabs;
};

Layout layout(int cols) {
  const int chunks = (cols + VEC - 1) / VEC;
  int lanes = 1;
  while (lanes < 32 && 3 * lanes < chunks) lanes *= 2;
  if (chunks <= 3 * lanes) return {lanes, 3, 1};
  if (chunks <= 4 * 32) return {32, 4, 1};
  if (chunks <= MAX_ITERS * 32) return {32, MAX_ITERS, 1};
  return {32, MAX_ITERS, (chunks + 32 * MAX_ITERS - 1) / (32 * MAX_ITERS)};
}

// blocks that fill the card once (at most one a row group); the card's
// count, a kernel's own, is kept in ``cache`` by device
constexpr int MAX_DEVICES = 64;

template <typename Kernel>
cudaError_t grid_for(Kernel kernel, int64_t* cache, int64_t rows, int rows_per_block, int device,
                     int* grid) {
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (cache[device] == 0) {
    int sms = 0, per_sm = 0;
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
    if (err != cudaSuccess) return err;
    cache[device] = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  }
  const int64_t need = (rows + rows_per_block - 1) / rows_per_block;
  *grid = (int)(need < cache[device] ? need : cache[device]);
  return cudaSuccess;
}

template <typename T, int L, int I, bool R>
cudaError_t fwd_grid(int64_t rows, int device, int* grid) {
  static int64_t cache[MAX_DEVICES];
  return grid_for(layer_norm_fwd_kernel<T, L, I, R>, cache, rows, WARPS * 32 / L, device, grid);
}

template <typename T, int L, int I, bool R>
cudaError_t bwd_grid(int64_t rows, int device, int* grid) {
  static int64_t cache[MAX_DEVICES];
  return grid_for(layer_norm_bwd_kernel<T, L, I, R>, cache, rows, WARPS * 32 / L, device, grid);
}

// one of the instantiated layouts: op.template run<T, LANES, ITERS, RESIDENT>()
#define LAYER_NORM_LAYOUTS(X)                                                          \
  X(1, 3, true) X(2, 3, true) X(4, 3, true) X(8, 3, true) X(16, 3, true) X(32, 3, true) \
  X(32, 4, true) X(32, 6, true) X(32, 6, false)

template <typename T, typename Op>
cudaError_t with_layout(const Layout& l, const Op& op) {
#define LAYER_NORM_TRY(L, I, R)                                    \
  if (l.lanes == L && l.iters == I && (l.slabs == 1) == R) \
    return op.template run<T, L, I, R>();
  LAYER_NORM_LAYOUTS(LAYER_NORM_TRY)
#undef LAYER_NORM_TRY
  return cudaErrorInvalidValue;
}

template <typename Op>
cudaError_t with_dtype(int dtype, const Layout& l, const Op& op) {
  switch (dtype) {
    case BF16: return with_layout<bf16>(l, op);
    case F16: return with_layout<__half>(l, op);
    default: return with_layout<float>(l, op);
  }
}

struct FwdLaunch {
  const LnFwd& f;
  int device;
  cudaStream_t stream;
  template <typename T, int L, int I, bool R>
  cudaError_t run() const {
    int grid = 0;
    cudaError_t err = fwd_grid<T, L, I, R>(f.rows, device, &grid);
    if (err != cudaSuccess) return err;
    layer_norm_fwd_kernel<T, L, I, R><<<grid, THREADS, 0, stream>>>(f);
    return cudaGetLastError();
  }
};

// the backward's partial sums: a block each, or a warp each in slabs
struct BwdParts {
  int64_t rows;
  int device;
  int64_t* parts;
  template <typename T, int L, int I, bool R>
  cudaError_t run() const {
    int grid = 0;
    cudaError_t err = bwd_grid<T, L, I, R>(rows, device, &grid);
    *parts = R ? grid : (int64_t)grid * WARPS;
    return err;
  }
};

struct BwdLaunch {
  const LnBwd& f;
  int64_t parts;
  int device;
  cudaStream_t stream;
  template <typename T, int L, int I, bool R>
  cudaError_t run() const {
    int grid = 0;
    cudaError_t err = bwd_grid<T, L, I, R>(f.rows, device, &grid);
    if (err != cudaSuccess) return err;
    if (parts != (R ? grid : (int64_t)grid * WARPS)) return cudaErrorInvalidValue;
    layer_norm_bwd_kernel<T, L, I, R><<<grid, THREADS, 0, stream>>>(f);
    return cudaGetLastError();
  }
};

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

bool bad(int dtype, long long rows, int cols, float eps) {
  return dtype < BF16 || dtype > F32 || rows <= 0 || cols <= 0 || !(eps >= 0.f) ||
         (long long)cols * 2 > (1ll << 31) - 1;
}

}  // namespace

// Forward.  dtype 1 bf16, 2 f16, 3 f32 (x and y); weight and bias f32 (cols,);
// x and y contiguous (rows, cols).
extern "C" int layer_norm_fwd(const void* x, const void* weight, const void* bias, void* y,
                              int dtype, long long rows, int cols, float eps, void* stream,
                              int device) {
  if (bad(dtype, rows, cols, eps) || !x || !weight || !bias || !y) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Layout l = layout(cols);
  const LnFwd f{x, static_cast<const float*>(weight), static_cast<const float*>(bias), y, rows,
                cols, l.slabs, eps,
                cols % VEC == 0 && aligned16(x) && aligned16(y) && aligned16(weight) &&
                    aligned16(bias)};
  return with_dtype(dtype, l, FwdLaunch{f, device, static_cast<cudaStream_t>(stream)});
}

// The rows of the backward's partial sums (parts, 2, cols) for this shape
// on this device; negative: a CUDA error.
extern "C" long long layer_norm_bwd_parts(long long rows, int cols, int dtype, int device) {
  if (bad(dtype, rows, cols, 0.f)) return -(long long)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(long long)err;
  int64_t parts = 0;
  err = with_dtype(dtype, layout(cols), BwdParts{rows, device, &parts});
  return err != cudaSuccess ? -(long long)err : parts;
}

// Backward.  dy, x and dx contiguous (rows, cols) of the dtype; weight f32
// (cols,); partial f32 scratch (parts, 2, cols) with parts from
// ``layer_norm_bwd_parts``; sums f32 (2, cols): dweight, then dbias.
extern "C" int layer_norm_bwd(const void* dy, const void* x, const void* weight, void* dx,
                              void* partial, long long parts, void* sums, int dtype,
                              long long rows, int cols, float eps, void* stream, int device) {
  if (bad(dtype, rows, cols, eps) || !dy || !x || !weight || !dx || !partial || !sums ||
      parts <= 0 || parts > (1ll << 31) - 1)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Layout l = layout(cols);
  const LnBwd f{dy, x, static_cast<const float*>(weight), dx, static_cast<float*>(partial), rows,
                cols, l.slabs, eps,
                cols % VEC == 0 && aligned16(dy) && aligned16(x) && aligned16(dx) &&
                    aligned16(weight)};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = with_dtype(dtype, l, BwdLaunch{f, parts, device, s});
  if (err != cudaSuccess) return err;
  const int n = 2 * cols;
  layer_norm_bwd_param_sums<<<(n + 31) / 32, dim3(32, 8), 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(sums), (int)parts, n);
  return cudaGetLastError();
}

// The layout the kernels take at this width: lanes a row, chunks a lane, slabs.
extern "C" void layer_norm_layout(int cols, int* lanes, int* iters, int* slabs) {
  const Layout l = layout(cols);
  *lanes = l.lanes;
  *iters = l.iters;
  *slabs = l.slabs;
}

extern "C" const char* layer_norm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
