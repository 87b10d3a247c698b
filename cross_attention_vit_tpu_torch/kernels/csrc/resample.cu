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
// What is summed.  The hat weight max(0, 1 − |rel − d|) is nonzero only for
// d = floor(rel) and floor(rel) + 1, so every other tap adds an exact zero
// (the volumes are finite).  Each output voxel therefore reads just those
// two taps, keeps each only if it lies in the tile's window, and adds them
// in ascending order — the TPU kernel's sum, term for term, so the result
// equals the plain version bit for bit.  The tile's min rel is rel at the
// tile corner picked by the signs of cdelta: each rounded product and sum is
// monotone in its inputs, so that corner's value is the exact minimum of the
// rounded per-voxel values.  Products and sums are written with __fmul_rn /
// __fadd_rn, so no FMA contraction changes the rounding.  1 − |rel − d| is
// never negative for those two taps (|rel − d| ≤ 1 after rounding), so the
// max with 0 is left out.
//
// Design.  As the TPU kernel stages a tile once in VMEM, a block stages a
// box of the source once in shared memory.  The box is the resample axis
// whole and a cross-section of the other dims inside one TPU tile (the
// wrapper's ``box_geometry``, about 16 KB of source): every tap a box voxel
// reads, after the symmetric reflection, is a voxel of the same
// cross-section at an in-range position along the axis, so the box's own n
// source lines cover every tap — no halo and no voxel read twice.  The
// reflection is an index into shared memory at read time, the same on all
// three axes.  A box's rows are copied by 16-byte cp.async (a plain copy
// loop where a row is not 16-byte aligned).  The blocks are persistent and
// keep a ring of three box slots, so two boxes' copies run while one is
// computed.  A thread computes 8 consecutive voxels of a row and writes them
// with one 16-byte store (two in f32).  The work per voxel is what bounds
// the kernel on the card (on an H100 at 700 W, a live bf16 pass's copies
// alone took about 6 us, its arithmetic about 14), so the common chunk (interior: taps inside the
// window and inside the line) takes a path without tests: floor(rel) by one
// rounded add, the tap addresses by one multiply-add from an offset kept per
// chunk column.  On axis 2 that path also reflects, branch-free, so that the
// lanes at a line's ends stay on it; a warp there covers 16 rows × 2 chunks
// whose staged rows lie 16 bytes past a multiple of 128 apart.  In f32 a
// thread visits its 8 voxels in an order rotated by two for each group of 8
// lanes, so that the rows a warp reads fall in different banks; in bf16 the
// rotation cost more than the conflicts it removed.
//
// Bound.  Each voxel is read once and written once: 4 bytes per voxel in
// bf16, 8 in f32 (a live pass over 8 volumes of 128×128×64 in bf16: 33.6 MB,
// 10.0 us at 3.35 TB/s).  The arithmetic (rel, two hat weights, two products
// and sums, about 20 f32 operations per voxel) is below a third of that at
// the 67 TFLOP/s f32 rate, so the kernel is bound by bytes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 128;
constexpr int VEC = 8;           // voxels per thread, consecutive along dim 2
constexpr int STAGES = 3;        // box slots a block keeps: two boxes' copies in flight
// 1.5·2^23: x + M rounded down is M + floor(x), exactly, for |x| < 2^22
constexpr float FLOOR_MAGIC = 12582912.f;
constexpr int FLOOR_MAGIC_BITS = 0x4B400000;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(bf16* p, float v) { *p = __float2bfloat16_rn(v); }

__device__ __forceinline__ float rel_at(const float cd[3], float g0, float g1, float g2) {
  return __fadd_rn(__fadd_rn(__fmul_rn(cd[0], g0), __fmul_rn(cd[1], g1)), __fmul_rn(cd[2], g2));
}

// numpy 'symmetric' padding as an index map (period 2n); in range, p itself
__device__ __forceinline__ int reflect(int p, int n) {
  for (;;) {
    if (p < 0) {
      p = -1 - p;
    } else if (p >= n) {
      p = 2 * n - 1 - p;
    } else {
      return p;
    }
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ int pow2_at_least(int n) {
  return n <= 1 ? 1 : 1 << (32 - __clz(n - 1));
}

struct Geometry {
  int V, D, H, W, axis, window, span, b0, b1;
  float c0, c1, c2;
  int e0, e1, cw;   // a box: e0 × e1 rows of dims 0, 1 (the axis whole), cw columns of dim 2
  int pitch;        // elements per staged row: whole 16-byte copies, at least cw
  int aligned;      // rows are 16-byte aligned: cp.async copies, 16-byte stores
};

// A box's place: its column block, dim-1 block and dim-0 block (boxes are
// numbered with the column block fastest) and its volume.
struct Box {
  int d2, d1, d0, v;
};

__device__ __forceinline__ Box box_at(int b, const Geometry& g) {
  const int nb2 = (g.W + g.cw - 1) / g.cw, nb1 = g.H / g.e1, nb0 = g.D / g.e0;
  Box x;
  x.d2 = b % nb2;
  b /= nb2;
  x.d1 = b % nb1;
  b /= nb1;
  x.d0 = b % nb0;
  x.v = b / nb0;
  return x;
}

// A thread's share of a box's rows × pieces (16-byte copies or chunks):
// pieces c0, c0 + cstep, ... of rows r0, r0 + rstep, ...
struct Lanes {
  int c0, cstep, r0, rstep;
  bool active;
};

// For the copies: cw neighbouring pieces of a row go to neighbouring lanes;
// when the block has more lanes than rows per piece column, several
// columns run at once.
__device__ __forceinline__ Lanes lanes(int cw, int rows) {
  const int tx = threadIdx.x & (cw - 1), ty = threadIdx.x / cw, ry = THREADS / cw;
  if (ry < rows) return {tx, cw, ty, ry, true};
  const int gpar = ry / rows, gi = ty / rows;
  return {gi * cw + tx, gpar * cw, ty - gi * rows, rows, gi < gpar};
}

// For the compute: warps take whole chunk columns of cw chunks, 32/cw rows
// at a time, so that a thread keeps its column (and what depends on it
// alone) over several rows.  Warp w takes column w mod G when there are
// G ≤ warps columns, sharing it with the other warps of that residue; else
// columns w, w + warps, ...
__device__ __forceinline__ Lanes chunk_lanes(int cw, int per_row) {
  constexpr int WARPS = THREADS / 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, rw = 32 / cw;
  const int groups = (per_row + cw - 1) / cw, tx = lane & (cw - 1), ty = lane / cw;
  if (groups > WARPS) return {warp * cw + tx, WARPS * cw, ty, rw, true};
  const int g = warp % groups, sharing = WARPS / groups + (g < WARPS % groups);
  return {g * cw + tx, groups * cw, warp / groups * rw + ty, sharing * rw, true};
}

// Rows r0, r0 + step, ... of a box's e0 × e1 rows as (i0, i1), i1 fastest,
// without a division per step.
struct Rows {
  int i0, i1, s0, s1;
  __device__ Rows(int r0, int step, int e1)
      : i0(r0 / e1), i1(r0 % e1), s0(step / e1), s1(step % e1) {}
  __device__ void next(int e1) {
    i0 += s0;
    i1 += s1;
    if (i1 >= e1) {
      i1 -= e1;
      ++i0;
    }
  }
};

// Start the copies of box `x` into the slot `slab` (e0·e1 rows of `pitch`):
// 16-byte cp.async for aligned rows, else a plain copy (visible after the
// next barrier, as the asynchronous copies are after their wait).  Lanes of
// one row copy its neighbouring pieces.  The caller commits the group.
template <typename T>
__device__ __forceinline__ void stage(T* slab, const T* __restrict__ src, const Box& x,
                                      const Geometry& g) {
  constexpr int EPC = 16 / sizeof(T);      // elements per 16-byte copy
  const int t0 = x.d0 * g.e0, t1 = x.d1 * g.e1, t2 = x.d2 * g.cw;
  const int wb = min(g.cw, g.W - t2);
  const int pieces = g.aligned ? wb / EPC : wb, width = g.aligned ? EPC : 1;
  const Lanes l = lanes(pow2_at_least(min(32, pieces)), g.e0 * g.e1);
  if (!l.active) return;
  for (int c = l.c0; c < pieces; c += l.cstep) {
    for (Rows it(l.r0, l.rstep, g.e1); it.i0 < g.e0; it.next(g.e1)) {
      const T* p = src + ((static_cast<long long>(x.v) * g.D + t0 + it.i0) * g.H + t1 + it.i1) * g.W +
                   t2 + c * width;
      T* d = slab + (it.i0 * g.e1 + it.i1) * g.pitch + c * width;
      if (g.aligned) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(d)), "l"(p)
                     : "memory");
      } else {
        *d = *p;
      }
    }
  }
}

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

// An element of the staged box at shared-memory byte address `a`, as f32.
template <typename T>
__device__ __forceinline__ float lds(uint32_t a);
template <>
__device__ __forceinline__ float lds<float>(uint32_t a) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}
template <>
__device__ __forceinline__ float lds<bf16>(uint32_t a) {
  unsigned short v;
  asm volatile("ld.shared.u16 %0, [%1];\n" : "=h"(v) : "r"(a));
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

// The hat weights of the taps floor(rel) and floor(rel) + 1, from
// t = M + floor(rel) (FLOOR_MAGIC's add rounded down): 1 − |rel − d|.
__device__ __forceinline__ void hat(float rel, float t, float& w0, float& w1) {
  w0 = __fsub_rn(1.f, fabsf(__fsub_rn(rel, __fsub_rn(t, FLOOR_MAGIC))));
  w1 = __fsub_rn(1.f, fabsf(__fsub_rn(rel, __fsub_rn(t, FLOOR_MAGIC - 1.f))));
}

// numpy 'symmetric' padding's index map for p in [−n, 2n); n2 = 2n − 1
__device__ __forceinline__ int reflect_near(int p, int n2) {
  const int q = p ^ (p >> 31);    // p < 0: −1 − p
  return min(q, n2 - q);
}

// One voxel's sum through the far path: the taps reflected into [0, n) from
// any distance, each kept only inside the window.  Slab element off +
// p·stride is axis position p.
template <typename T>
__device__ __forceinline__ float voxel_far(const T* slab, float rel, int xa, int off, int stride,
                                           int n, int d_lo, int span) {
  const float d0f = floorf(rel);
  const int d0 = static_cast<int>(d0f);
  const float w0 = __fsub_rn(1.f, fabsf(__fsub_rn(rel, d0f)));
  const float w1 = __fsub_rn(1.f, fabsf(__fsub_rn(rel, __fadd_rn(d0f, 1.f))));
  const float t0 = static_cast<unsigned>(d0 - d_lo) < static_cast<unsigned>(span)
                       ? __fmul_rn(w0, to_float(slab[off + reflect(xa + d0, n) * stride])) : 0.f;
  const float t1 = static_cast<unsigned>(d0 + 1 - d_lo) < static_cast<unsigned>(span)
                       ? __fmul_rn(w1, to_float(slab[off + reflect(xa + d0 + 1, n) * stride]))
                       : 0.f;
  return __fadd_rn(__fadd_rn(0.f, t0), t1);
}

// The output of box `x` from its staged source `slab`.  Neighbouring lanes
// take a row's neighbouring chunks: all of them on the axes 0 and 1 (up to
// 32), two on axis 2, whose warps so meet the line ends (where taps reflect)
// together.  A thread keeps one chunk column and walks rows.  A chunk takes
// one of three paths, by the range of its taps (rel is monotone along a
// row, so the chunk's end voxels bound them): interior — every tap inside
// the window and inside [0, n) along the axis, so no test and no reflection
// (on axis 2, inside [−n, 2n) and reflected without a branch); near — taps
// in [−n, 2n), reflected without a branch, each tested against the window;
// far — a partial chunk or taps further out.
template <typename T, int AXIS>
__device__ __forceinline__ void compute(const T* slab, T* __restrict__ out,
                                        const float* __restrict__ cdelta, const Box& x,
                                        const Geometry& g) {
  const float cd[3] = {cdelta[x.v * 3], cdelta[x.v * 3 + 1], cdelta[x.v * 3 + 2]};
  const int t0 = x.d0 * g.e0, t1 = x.d1 * g.e1, t2 = x.d2 * g.cw;
  const int wb = min(g.cw, g.W - t2);

  // the tile's window, the same for the whole box: its minimum rel is at the
  // corner where each term is smallest
  int d_lo = -g.window, span = 2 * g.window + 2;
  if (g.span > 0) {
    const int y0 = t0 / g.b0 * g.b0, y1 = t1 / g.b1 * g.b1;
    const float z0 = static_cast<float>(cd[0] >= 0.f ? y0 : y0 + g.b0 - 1);
    const float z1 = static_cast<float>(cd[1] >= 0.f ? y1 : y1 + g.b1 - 1);
    const float z2 = static_cast<float>(cd[2] >= 0.f ? 0 : g.W - 1);
    const float rmin = rel_at(cd, z0 - g.c0, z1 - g.c1, z2 - g.c2);
    span = g.span;
    d_lo = static_cast<int>(fminf(fmaxf(floorf(rmin), static_cast<float>(-g.window)),
                                  static_cast<float>(g.window + 2 - span)));
  }

  const int n = AXIS == 0 ? g.D : AXIS == 1 ? g.H : g.W;
  const int per_row = (wb + VEC - 1) / VEC;
  const Lanes l = chunk_lanes(pow2_at_least(AXIS == 2 ? min(2, per_row) : min(32, per_row)),
                              per_row);
  // voxel order in f32: rotated by two for each group of 8 lanes (see Design)
  const int rot = sizeof(T) == 4 ? ((threadIdx.x >> 3) & 3) << 1 : 0;
  const int stride = AXIS == 0 ? g.e1 * g.pitch : AXIS == 1 ? g.pitch : 1;
  const uint32_t stride_b = stride * sizeof(T);
  const uint32_t slab_b = smem_u32(slab);
  T* const vol = out + static_cast<long long>(x.v) * g.D * g.H * g.W;
  for (int chunk = l.c0; chunk < per_row; chunk += l.cstep) {
    const int col = chunk * VEC, x2_0 = t2 + col;    // col: within the box
    const bool full = col + VEC <= wb;
    // per voxel of the thread's order: rel's dim-2 term, and the byte offset
    // of its tap less the magic's share (d0 = bits(t) − FLOOR_MAGIC_BITS)
    float g2[VEC];
    uint32_t jb[VEC];
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const int j = (i + rot) & (VEC - 1);
      g2[i] = __fmul_rn(cd[2], static_cast<float>(x2_0 + j) - g.c2);
      jb[i] = j * sizeof(T) - FLOOR_MAGIC_BITS * stride_b;
    }
    const float ga = __fmul_rn(cd[2], static_cast<float>(x2_0) - g.c2);
    const float gb = __fmul_rn(cd[2], static_cast<float>(x2_0 + VEC - 1) - g.c2);
    for (Rows it(l.r0, l.rstep, g.e1); it.i0 < g.e0; it.next(g.e1)) {
      const int i0 = it.i0, i1 = it.i1, x0 = t0 + i0, x1 = t1 + i1;
      const float part = __fadd_rn(__fmul_rn(cd[0], static_cast<float>(x0) - g.c0),
                                   __fmul_rn(cd[1], static_cast<float>(x1) - g.c1));
      // slab element off + p·stride is axis position p (voxel j's at off + j
      // on the axes 0 and 1, where each voxel has its own line)
      const int off = AXIS == 0 ? i1 * g.pitch + col
                    : AXIS == 1 ? i0 * g.e1 * g.pitch + col
                                : (i0 * g.e1 + i1) * g.pitch;
      const int xa = AXIS == 0 ? x0 : AXIS == 1 ? x1 : x2_0;
      int path = 2;                                   // interior 0, near 1, far 2
      if (full) {
        const float ra = __fadd_rn(part, ga), rb = __fadd_rn(part, gb);
        const int lo = static_cast<int>(floorf(fminf(ra, rb)));
        const int hi = static_cast<int>(floorf(fmaxf(ra, rb)));
        const int plo = xa + lo, phi = xa + hi + 1 + (AXIS == 2 ? VEC - 1 : 0);
        // axis 2 reflects on the interior path too, so that a warp's lanes
        // at the line ends do not leave it
        if (plo >= -n && phi < 2 * n)
          path = lo >= d_lo && hi + 2 <= d_lo + span && (AXIS == 2 || (plo >= 0 && phi < n))
                     ? 0 : 1;
      }
      float res[VEC];
      if (path == 0) {
        const uint32_t row = slab_b + off * sizeof(T), line = row + xa * stride_b;
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const float rel = __fadd_rn(part, g2[i]);
          const float t = __fadd_rd(rel, FLOOR_MAGIC);   // M + floor(rel): |rel| < n
          float w0, w1;
          hat(rel, t, w0, w1);
          uint32_t a0, a1;
          if (AXIS == 2) {
            const int p = xa + ((i + rot) & (VEC - 1)) + __float_as_int(t) - FLOOR_MAGIC_BITS;
            a0 = row + reflect_near(p, 2 * n - 1) * sizeof(T);
            a1 = row + reflect_near(p + 1, 2 * n - 1) * sizeof(T);
          } else {
            a0 = line + jb[i] + __float_as_uint(t) * stride_b;
            a1 = a0 + stride_b;
          }
          res[i] = __fadd_rn(__fadd_rn(0.f, __fmul_rn(w0, lds<T>(a0))),
                             __fmul_rn(w1, lds<T>(a1)));
        }
      } else if (path == 1) {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int j = (i + rot) & (VEC - 1);
          const float rel = __fadd_rn(part, g2[i]);
          const float t = __fadd_rd(rel, FLOOR_MAGIC);
          const int d0 = __float_as_int(t) - FLOOR_MAGIC_BITS;
          float w0, w1;
          hat(rel, t, w0, w1);
          const int p = (AXIS == 2 ? xa + j : xa) + d0;
          const uint32_t line = slab_b + (AXIS == 2 ? off : off + j) * sizeof(T);
          const float s0 = lds<T>(line + reflect_near(p, 2 * n - 1) * stride_b);
          const float s1 = lds<T>(line + reflect_near(p + 1, 2 * n - 1) * stride_b);
          const float v0 = static_cast<unsigned>(d0 - d_lo) < static_cast<unsigned>(span)
                               ? __fmul_rn(w0, s0) : 0.f;
          const float v1 = static_cast<unsigned>(d0 + 1 - d_lo) < static_cast<unsigned>(span)
                               ? __fmul_rn(w1, s1) : 0.f;
          res[i] = __fadd_rn(__fadd_rn(0.f, v0), v1);
        }
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) {
          const int j = (i + rot) & (VEC - 1);
          res[i] = col + j < wb
                       ? voxel_far(slab, __fadd_rn(part, g2[i]), AXIS == 2 ? xa + j : xa,
                                   AXIS == 2 ? off : off + j, stride, n, d_lo, span)
                       : 0.f;
        }
      }
      // undo the rotation: voxel j is res[(j − rot) mod 8]
      float a[VEC], y[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) a[j] = (rot & 4) ? res[(j + 4) & (VEC - 1)] : res[j];
#pragma unroll
      for (int j = 0; j < VEC; ++j) y[j] = (rot & 2) ? a[(j + VEC - 2) & (VEC - 1)] : a[j];
      T* dst = vol + (x0 * g.H + x1) * g.W + x2_0;
      if (g.aligned && full) {
        store8(dst, y);
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          if (col + j < wb) store(dst + j, y[j]);
      }
    }
  }
}

// Persistent blocks over the boxes in a ring of STAGES slots: box
// k + (STAGES − 1)·gridDim.x is copied while box k is computed.  One barrier
// per box: after it, every thread's copies of this box have landed and every
// thread has finished the previous box, whose slot the new copies then take.
template <typename T, int AXIS>
__global__ void __launch_bounds__(THREADS, 6)
resample_kernel(const T* __restrict__ src, T* __restrict__ out, const float* __restrict__ cdelta,
                Geometry g, int boxes) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* const slab = reinterpret_cast<T*>(smem);
  const int slot = g.e0 * g.e1 * g.pitch;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    const int b = blockIdx.x + s * gridDim.x;
    if (b < boxes) stage(slab + s * slot, src, box_at(b, g), g);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  int k = 0;
  for (int b = blockIdx.x; b < boxes; b += gridDim.x) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(STAGES - 2) : "memory");
    __syncthreads();
    const int ahead = b + (STAGES - 1) * gridDim.x;
    const int fill = k == 0 ? STAGES - 1 : k - 1;    // the slot the previous box used
    if (ahead < boxes) stage(slab + fill * slot, src, box_at(ahead, g), g);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    compute<T, AXIS>(slab + k * slot, out, cdelta, box_at(b, g), g);
    k = k == STAGES - 1 ? 0 : k + 1;
  }
}

template <typename T, int AXIS>
cudaError_t launch_axis(const T* src, T* out, const float* cdelta, const Geometry& g,
                        int boxes, size_t smem, int sms, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(resample_kernel<T, AXIS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resample_kernel<T, AXIS>, THREADS,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const long long resident = static_cast<long long>(per_sm) * sms;
  const int grid = static_cast<int>(boxes < resident ? boxes : resident);
  resample_kernel<T, AXIS><<<grid, THREADS, smem, stream>>>(src, out, cdelta, g, boxes);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* src, void* out, const float* cdelta, Geometry g, int device,
                   cudaStream_t stream) {
  g.aligned = (g.W * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
              reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const long long boxes =
      static_cast<long long>(g.V) * (g.D / g.e0) * (g.H / g.e1) * ((g.W + g.cw - 1) / g.cw);
  const long long slot = static_cast<long long>(g.e0) * g.e1 * g.pitch;
  if (boxes > INT32_MAX / 2 || slot * STAGES * sizeof(T) > INT32_MAX ||
      static_cast<long long>(g.D) * g.H * g.W > INT32_MAX)
    return cudaErrorInvalidValue;
  const size_t smem = STAGES * slot * sizeof(T);
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const T* s = static_cast<const T*>(src);
  T* o = static_cast<T*>(out);
  const int nb = static_cast<int>(boxes);
  return g.axis == 0   ? launch_axis<T, 0>(s, o, cdelta, g, nb, smem, sms, stream)
         : g.axis == 1 ? launch_axis<T, 1>(s, o, cdelta, g, nb, smem, sms, stream)
                       : launch_axis<T, 2>(s, o, cdelta, g, nb, smem, sms, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  src and out are contiguous (V, D, H, W),
// cdelta (V, 3) f32.  span < 0 sums all 2W+2 taps (K4); otherwise the tiles
// are b0 × b1 along dims 0, 1.  A block's box is e0 × e1 × cw (dims 0, 1, 2),
// the axis whole, inside one tile, staged in rows of `pitch` elements.  Returns a cudaError_t (0 on success); the
// launch does not synchronise.
extern "C" int resample_axis_windowed(const void* src, void* out, const void* cdelta, int dtype,
                                      int V, int D, int H, int W, int axis, int window, int span,
                                      int b0, int b1, float c0, float c1, float c2, int e0, int e1,
                                      int cw, int pitch, void* stream, int device) {
  const int ext[3] = {e0, e1, cw};
  const int full[3] = {D, H, W};
  if ((dtype != 0 && dtype != 1) || axis < 0 || axis > 2 || window < 0 || span == 0 ||
      V <= 0 || D <= 0 || H <= 0 || W <= 0 || b0 <= 0 || b1 <= 0 || D % b0 || H % b1 ||
      e0 <= 0 || e1 <= 0 || cw <= 0 || b0 % e0 || b1 % e1 || ext[axis] != full[axis] ||
      (axis != 2 && cw % 8) || pitch < cw || pitch * (dtype == 0 ? 4 : 2) % 16)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const Geometry g{V, D, H, W, axis, window, span, b0, b1, c0, c1, c2, e0, e1, cw, pitch, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* cd = static_cast<const float*>(cdelta);
  return dtype == 0 ? launch<float>(src, out, cd, g, device, s)
                    : launch<bf16>(src, out, cd, g, device, s);
}

extern "C" const char* resample_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
