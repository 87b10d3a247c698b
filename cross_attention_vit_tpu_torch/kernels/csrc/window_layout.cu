// Swin's window layout for Hopper (sm_90a): a block's tokens into its windows
// and back, each in one gather.
//
// Replaces no TPU kernel: the JAX package has no windowed model.  The port ran
// PyTorch's chain of copies around each block's window attention: the zero
// padding to whole windows, ``torch.roll`` by the shift (one pass an axis), the
// partition's permute, and after the attention the reverse's permute, the roll
// back and the crop, with each step's adjoint in the backward.
//
// For a (B, d, h, w, C) token grid and a block's windows (extent W, grid G and
// shift S on each axis; P = G·W the padded extent):
//
//   pack    (B, d, h, w, C) → (B·windows, n, C).  Window row
//           ((b·Gd + gz)·Gh + gy)·Gw + gx and token (iz·W1 + iy)·W2 + ix lie at
//           p_a = g_a·W_a + i_a of the padded, rolled grid, which holds
//           x[b, q] with q_a = (p_a + S_a) mod P_a where every q_a < dim_a, and
//           zeros elsewhere: ``F.pad``, ``torch.roll(−S)``, the partition.
//   unpack  (B·windows, n, C) → (B, d, h, w, C).  Each real position z reads
//           the window row and token at p_a = (z_a − S_a) mod P_a: the
//           reverse, ``torch.roll(+S)``, the crop.
//
// Each is the other's adjoint (the map p → q is one to one on the padded
// grid), so each is the other's backward.  Both only move bytes: no value is
// computed, so the result is the chain's bit for bit.
//
// Bound: bytes.  The pack reads each real token once and writes each padded
// one once, (R + P)·C·size bytes for R real and P padded tokens; the unpack
// reads only the real tokens' rows of the windows and writes them, 2R·C·size.
// At Swin UNETR's first stage (B = 16, 64³ tokens in 70³ padded ones, C = 48,
// bf16) that is 930 and 805 MB, 0.28 and 0.24 ms at 3.35 TB/s.
//
// Design.  The rows of C values move in units of 16 bytes where the row's
// bytes and both pointers allow (C·size of 96 to 768 bytes at C = 48-384 in
// bf16: 6 to 48 units a row), else in the largest of 8, 4, 2 or 1 bytes that
// do, so the kernels take any dtype alike.  Consecutive threads take
// consecutive units of the output: stores are coalesced along the row, and
// loads along the row and, within a window's line, along x.  Each thread
// finds its token's source by index arithmetic alone: divisions by the
// extents as a multiply-high and a shift (the divisors' constants computed
// once on the host), about 60 integer instructions a 16-byte unit against
// some 280 that the bytes' time leaves.  A thread moves ITEMS units of the
// block's stride apart, their loads in flight together.  Padded tokens are
// not read, only written as zeros.  Token and unit counts are held below
// 2^31.
//
// Names.  The kernels' names hold "window_layout" and none of the marks by
// which the benchmark's frozen kernel classes count copies or attention.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 4;                                  // units a thread moves
constexpr long long LIMIT = (1ll << 31) - 1;              // tokens and units below this

// n / d for 0 <= n < 2^31 as (umulhi(n, m) + n) >> s (Granlund and Montgomery)
struct Divisor {
  uint32_t d, m, s;
};

Divisor divisor(uint32_t d) {
  uint32_t s = 0;
  while ((1ull << s) < d) ++s;
  return {d, (uint32_t)(((1ull << 32) * ((1ull << s) - d)) / d + 1), s};
}

__device__ __forceinline__ uint32_t quot(const Divisor& v, uint32_t n) {
  return (__umulhi(n, v.m) + n) >> v.s;
}

// n / d into n, the remainder returned
__device__ __forceinline__ uint32_t split(const Divisor& v, uint32_t& n) {
  const uint32_t q = quot(v, n), r = n - q * v.d;
  n = q;
  return r;
}

struct Geometry {
  uint32_t units;          // the output's units
  Divisor row;             // units a token's row
  Divisor dim[3];          // d, h, w
  Divisor win[3];          // the window's extent on each axis
  Divisor grid[3];         // windows on each axis
  uint32_t padded[3];      // grid · window
  uint32_t shift[3];       // 0 <= shift < padded
};

// the real token that padded, rolled token (b, p) holds, or -1 for a zero
__device__ __forceinline__ long long pack_source(const Geometry& g, uint32_t token) {
  uint32_t i[3], gi[3];
  i[2] = split(g.win[2], token);
  i[1] = split(g.win[1], token);
  i[0] = split(g.win[0], token);
  gi[2] = split(g.grid[2], token);
  gi[1] = split(g.grid[1], token);
  gi[0] = split(g.grid[0], token);
  uint32_t at = token;                                   // the sample
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    uint32_t q = gi[a] * g.win[a].d + i[a] + g.shift[a];
    if (q >= g.padded[a]) q -= g.padded[a];
    if (q >= g.dim[a].d) return -1;
    at = at * g.dim[a].d + q;
  }
  return at;
}

// the window token that real token (b, z) reads
__device__ __forceinline__ long long unpack_source(const Geometry& g, uint32_t token) {
  uint32_t z[3];
  z[2] = split(g.dim[2], token);
  z[1] = split(g.dim[1], token);
  z[0] = split(g.dim[0], token);
  uint32_t row = token, t = 0;                           // the sample, then the window row
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    uint32_t p = z[a] + g.padded[a] - g.shift[a];
    if (p >= g.padded[a]) p -= g.padded[a];
    const uint32_t gi = quot(g.win[a], p);
    row = row * g.grid[a].d + gi;
    t = t * g.win[a].d + (p - gi * g.win[a].d);
  }
  const uint32_t n = g.win[0].d * g.win[1].d * g.win[2].d;
  return (long long)row * n + t;
}

template <bool PACK, typename U>
__device__ __forceinline__ void gather(const Geometry& g, const U* __restrict__ src,
                                       U* __restrict__ dst) {
  const uint32_t base = blockIdx.x * (uint32_t)(THREADS * ITEMS) + threadIdx.x;
  U v[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    v[k] = U{};
    const uint32_t idx = base + k * THREADS;
    if (idx >= g.units) continue;
    uint32_t token = idx;
    const uint32_t u = split(g.row, token);              // the unit within the token's row
    const long long at = PACK ? pack_source(g, token) : unpack_source(g, token);
    if (at >= 0) v[k] = src[at * g.row.d + u];
  }
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const uint32_t idx = base + k * THREADS;
    if (idx < g.units) dst[idx] = v[k];
  }
}

template <typename U>
__global__ void __launch_bounds__(THREADS)
    window_layout_pack_kernel(const Geometry g, const U* __restrict__ x, U* __restrict__ y) {
  gather<true>(g, x, y);
}

template <typename U>
__global__ void __launch_bounds__(THREADS)
    window_layout_unpack_kernel(const Geometry g, const U* __restrict__ o, U* __restrict__ y) {
  gather<false>(g, o, y);
}

template <typename U>
cudaError_t run(bool pack, Geometry g, const void* src, void* dst, cudaStream_t stream) {
  const uint32_t blocks = (g.units + THREADS * ITEMS - 1) / (THREADS * ITEMS);
  if (pack)
    window_layout_pack_kernel<U><<<blocks, THREADS, 0, stream>>>(
        g, static_cast<const U*>(src), static_cast<U*>(dst));
  else
    window_layout_unpack_kernel<U><<<blocks, THREADS, 0, stream>>>(
        g, static_cast<const U*>(src), static_cast<U*>(dst));
  return cudaGetLastError();
}

int layout(bool pack, const void* src, void* dst, int row_bytes, long long batch, int d, int h,
           int w, int w0, int w1, int w2, int gd, int gh, int gw, int s0, int s1, int s2,
           void* stream, int device) {
  const int dims[3] = {d, h, w}, win[3] = {w0, w1, w2}, grid[3] = {gd, gh, gw},
            shift[3] = {s0, s1, s2};
  if (!src || !dst || row_bytes <= 0 || batch <= 0) return cudaErrorInvalidValue;
  long long real = batch, padded = batch;
  for (int a = 0; a < 3; ++a) {
    const long long p = (long long)grid[a] * win[a];
    if (dims[a] <= 0 || win[a] <= 0 || grid[a] <= 0 || p < dims[a] || p > LIMIT ||
        shift[a] < 0 || shift[a] >= p)
      return cudaErrorInvalidValue;
    real *= dims[a];
    padded *= p;
    if (real > LIMIT || padded > LIMIT) return cudaErrorInvalidValue;
  }
  const uintptr_t bits = reinterpret_cast<uintptr_t>(src) | reinterpret_cast<uintptr_t>(dst);
  int unit = 16;
  while (unit > 1 && (row_bytes % unit || bits % unit)) unit /= 2;
  const long long units = (pack ? padded : real) * (row_bytes / unit);
  if (units > LIMIT) return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  Geometry g;
  g.units = (uint32_t)units;
  g.row = divisor(row_bytes / unit);
  for (int a = 0; a < 3; ++a) {
    g.dim[a] = divisor(dims[a]);
    g.win[a] = divisor(win[a]);
    g.grid[a] = divisor(grid[a]);
    g.padded[a] = (uint32_t)(grid[a] * win[a]);
    g.shift[a] = (uint32_t)shift[a];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return run<uint4>(pack, g, src, dst, s);
    case 8: return run<uint2>(pack, g, src, dst, s);
    case 4: return run<uint32_t>(pack, g, src, dst, s);
    case 2: return run<uint16_t>(pack, g, src, dst, s);
    default: return run<uint8_t>(pack, g, src, dst, s);
  }
}

}  // namespace

// Into the windows.  x contiguous (batch, d, h, w, row_bytes / size) of any
// dtype; y contiguous (batch·gd·gh·gw, w0·w1·w2, the same row).  The grid
// covers the volume (g·w >= dim on each axis); 0 <= shift < g·w.
extern "C" int window_layout_pack(const void* x, void* y, int row_bytes, long long batch, int d,
                                  int h, int w, int w0, int w1, int w2, int gd, int gh, int gw,
                                  int s0, int s1, int s2, void* stream, int device) {
  return layout(true, x, y, row_bytes, batch, d, h, w, w0, w1, w2, gd, gh, gw, s0, s1, s2, stream,
                device);
}

// Out of the windows: o as the pack's y, y as its x.
extern "C" int window_layout_unpack(const void* o, void* y, int row_bytes, long long batch, int d,
                                    int h, int w, int w0, int w1, int w2, int gd, int gh, int gw,
                                    int s0, int s1, int s2, void* stream, int device) {
  return layout(false, o, y, row_bytes, batch, d, h, w, w0, w1, w2, gd, gh, gw, s0, s1, s2,
                stream, device);
}

extern "C" const char* window_layout_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
