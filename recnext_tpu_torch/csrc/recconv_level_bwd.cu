// A peeled RecConv2d level's kernels for Hopper (sm_90a): kernels that take any plane
// size, for planes whose pyramid (forward) or whole backward does not fit in the shared
// memory of recconv.cu's or recconv_bwd.cu's kernel.
//
// The forward peels outer levels by the recursion
//   RecConv_L(x) = conv_L(z),  z = x + up(y),  y = RecConv_{L-1}(d),  d = down(x)
// (ops/recconv.py:rec_conv2d_peeled). recconv_level_kernel computes a peeled level's two
// steps: the stride-2 down conv d = down(x) into fp32, and, once the inner pyramid is
// done (recconv.cu's recconv_kernel on d, or at level 0 this kernel's plain conv),
// conv_L(x + up(y)) with recconv_kernel's lerp plans and arithmetic, rounded once to x's
// type. It is part of K1, the port of the TPU kernel recnext_tpu/ops/pallas/recconv.py:
// pallas_rec_conv2d. The backward walks the same recursion (ops/recconv.py:
// rec_conv2d_peeled_backward): given g = dL/d out, with d and y recomputed in fp32,
//   dz = conv_L^T(g)                      recconv_level_dgrad_kernel (KL'1), stride 1
//   dW_L = sum z (*) g                    recconv_level_wgrad_kernel (KL'2), stride 1, z
//                                         built from x + up(y) in shared memory
//   dy = up^T(dz)                         recconv_up_adjoint_kernel (KL'3)
//   (dd, dW_down, dW_0 .. dW_{L-1}) = the inner backward at (d, dy)
//   dx = dz + down^T(dd)                  recconv_level_dgrad_kernel, stride 2, adding dz
//   dW_down += sum x (*)_2 dd             recconv_level_wgrad_kernel, stride 2
// KL'1-3 replace no TPU kernel: JAX takes rec_conv2d's gradient by autodiff. Every
// kernel accumulates in fp32 and is a gather (no atomics), so it gives the same bits on
// every run.
//
// What bounds them on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): each reads its inputs once and writes its outputs once. The convs do k*k
// multiply-adds an output (the down conv about k*k/4 a fine element of x; the
// upsample-add-conv 10 operations more a fine element to build z); the adjoint 10 a
// fine element. At k = 5 the bytes bound every one, by 3-6x over the operations. So a
// kernel has to keep device memory busy while it computes, and spend less than the
// bytes' time on its instructions and shared memory: building z (about 20 instructions
// a fine element) holds the stride-1 walks, and the adjoint's gathers (two-way bank
// conflicts; 16 a coarse element, 8 with each fine row's column sums taken once) its
// walk. The simple forms these kernels replace (one 32 x 32 tile a block, its window loaded with
// scalar loads and then used, one shared load per tap, k*k warp butterflies a tile; the
// adjoint one thread an element with its plans and fine values from global memory) ran
// at 3-6x their bounds.
//
// Design. One warp walks one band of rows of one plane down a column tile of 128
// outputs. Rows of the inputs arrive by cp.async (16-, 8- or 4-byte chunks, as the
// rows' alignment allows; plain loads for a bf16 row of odd width) into rings of
// shared-memory rows, each holding the tile's columns and a zero halo of 8 elements a
// side, so that the next rows (`stages` - 1 steps of them) are in flight while the
// current one is used; a warp synchronises alone (cp.async.wait_group, __syncwarp).
// In the convs each lane owns a strip of 4 outputs along the row and reads its window
// of an input row (12 or 16 consecutive elements) with 16- or 8-byte loads, once a row:
//   - the forward conv keeps the output rows that an input row feeds (k rows of 4 sums
//     at stride 1, shifted down a row a step; at stride 2 k/2 + 1 rows of 4, a pair of
//     x rows a step, the step loop unrolled so that the ring's slots are registers) and
//     the k x k weights in registers, and writes a row, in 16-byte vectors where it
//     can, when its last input row has passed. Each output sums its taps in recconv_kernel's order
//     (tap row ascending, then tap column, from zero). With u, the warp builds each row
//     of z = x + up(u) a row ahead, from the x ring and a ring of u's coarse rows, by the
//     forward's lerp plans (along H first, then along W, then + x; the plans of every
//     row and column in a table in shared memory), into one of two rows of shared
//     memory, in the same straight-line code as the current row's multiply-adds, so
//     that z is never written out and the build's loads overlap the arithmetic.
//   - the input gradient is the same walk with the taps flipped (a ring of k x 4
//     accumulators; at stride 2, k/2 + 1 pairs of rows, the tap parities fixed per
//     strip at compile time): k*k multiply-adds an output for 12 loaded elements a row.
//   - the weight gradient keeps the k*k sums in registers for the whole band. At
//     stride 1, g's rows stay in a ring of shared rows that holds the k rows the taps
//     read (a lane reads its strip of each, 4 elements), and with u the warp builds z
//     as the forward does. At stride 2, g's last k/2 + 1 strips stay in registers. At
//     the band's end one warp reduce-scatter (5 shuffle stages) leaves each lane its
//     k*k/32 sums, the block adds its warps in order into one row of partial sums per
//     (plane, block of bands), and recconv_level_wgrad_sum_kernel adds a channel's
//     rows in a fixed tree.
//   - the adjoint walks a band of coarse rows down a tile of 128 coarse columns. The
//     fine rows a coarse row reads (at most 4, from the transposed row plans, irregular
//     at odd sizes) are fed into a ring of 256 + 16-wide rows as the plans name them.
//     Lanes take the coarse columns lane + 32 s (s < 4), so their fine reads fall about
//     2 words apart (two-way bank conflicts; strips of 4 would be 8 apart) and their
//     stores coalesce; each lane holds its columns' plan entries (ring offsets and
//     weights) in registers for the tile. Each fine row's column sums (its weighted
//     values in the columns' order) are taken once, when the row is first read, into a
//     ring of kMaxFan rows of the tile's coarse columns, and each coarse row then adds
//     its fine rows' sums times their weights (row entries from a table in shared
//     memory): the simple form's order, so its bits, with half the gathers.
// A band's halo rows (k/2 above and below) pass through the ring once for that band.
// The host (ops/cuda/recconv_level_bwd.py:launch_config) picks the band height (long
// bands read the halo less often; short ones fill the card), the bands and column
// tiles a block, the ring depths, the copy chunks and the shared layout from the
// kernel's registers, and passes them as `Geometry`.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstring>

namespace {

constexpr int kStrip = 4;                     // outputs a lane computes along a row
constexpr int kTile = 32 * kStrip;            // output columns a warp walks
constexpr int kPad = 8;                       // halo elements on each side of a ring row
constexpr int kRow1 = kTile + 2 * kPad;       // a stride-1 row: g, x, z
constexpr int kRowC = kTile / 2 + 2 * kPad;   // a coarse row: dd of the stride-2 dgrad, u
constexpr int kRow2 = 2 * kTile + 2 * kPad;   // a fine row at stride 2 (x), or the adjoint's dz
constexpr int kMaxThreads = 256;              // 8 warps a block at most
constexpr int kMaxFan = 4;                    // fine indices that read one coarse index

// A block's layout, as ops/cuda/recconv_level_bwd.py:launch_config builds it (the field
// order is the Python tuple's). Offsets and sizes are in 4-byte words.
struct Geometry {
  int rows;              // walk units of a plane: output rows (g's rows for the weight
                         // gradient; row pairs for the stride-2 input gradient)
  int row0;              // the first unit
  int band;              // units one warp walks
  int per_block;         // bands a block
  int tiles;             // column tiles of kTile outputs across the plane
  int tiles_pb;          // column tiles a block
  int tile_groups;       // blocks across one band group's tiles
  int blocks_per_plane;  // band groups x tile groups
  int stages;            // ring rows of each input stream (stages - 1 in flight): 2 or 4;
                         // the adjoint: steps of fine rows in flight + 1
  int uring;             // ring rows of u's coarse rows, a power of two
  int gring;             // ring rows of g (wgrad at stride 1), a power of two >= k +
                         // stages - 2: the rows the taps read stay in the ring; the
                         // adjoint: ring rows of dz's fine rows, a power of two
  int warp_words;        // from one warp's rings to the next
  int a_off;             // the first stream's ring (g: dgrad; x: wgrad and the forward;
                         // dz: the adjoint) in a warp's region
  int b_off;             // g's ring (wgrad)
  int u_off;             // u's ring (stride 1 with u)
  int z_off;             // two rows of z (stride 1 with u)
  int plan_off;          // block-wide, after the warps: the lerp plans, an int2 a row and
                         // a column (stride 1 with u); the adjoint's transposed plans
  int sums_off;          // block-wide: each warp's k*k sums (wgrad)
  int chunk_a, chunk_b, chunk_u;  // bytes one copy moves for each stream: 16, 8, 4, or 0
                                  // (plain loads, element by element)
  int vec;               // dgrad and the forward: output rows (and add) take 4-wide
                         // stores at every 4th column
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void put(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}
template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// ---- copies into the rings ----------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

template <int B>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)),
                 "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(smem_addr(dst)),
                 "l"(src), "n"(B) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most stages - 2 of this thread's copy groups are in flight: the group
// of the row the step uses has landed.
__device__ __forceinline__ void cp_wait(int stages) {
  if (stages == 4)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

template <int B>
__device__ __forceinline__ void zero_bytes(void* p) {
  if constexpr (B == 16)
    *reinterpret_cast<uint4*>(p) = make_uint4(0u, 0u, 0u, 0u);
  else if constexpr (B == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(0u, 0u);
  else
    *reinterpret_cast<unsigned*>(p) = 0u;
}

// dst[e] = row[col0 + e] for e < N, in chunks of B bytes: the host chose B so that no
// chunk straddles a row's end (width * sizeof(T) % B == 0, col0 % (B / sizeof(T)) == 0),
// so a chunk is copied whole or zeroed whole. The trip count is known at compile time.
template <int B, int N, typename T>
__device__ __forceinline__ void copy_chunks(T* dst, const T* row, int col0, int width,
                                            int lane) {
  constexpr int E = B / sizeof(T), kIters = (N / E + 31) / 32;
#pragma unroll
  for (int it = 0; it < kIters; ++it) {
    const int e = (lane + 32 * it) * E;
    if (N % (32 * E) == 0 || e < N) {
      const int c = col0 + e;
      if (c >= 0 && c < width)
        cp_async<B>(dst + e, row + c);
      else
        zero_bytes<B>(dst + e);
    }
  }
}

// One ring row: the columns [col0, col0 + N) of `row` (null: a row outside the plane),
// zero outside [0, width), by the warp's 32 lanes.
template <int N, typename T>
__device__ __forceinline__ void copy_row(T* dst, const T* row, int col0, int width, int chunk,
                                         int lane) {
  // phase copy
  if (!row) {
    unsigned* d = reinterpret_cast<unsigned*>(dst);
#pragma unroll
    for (int i = lane; i < N * (int)sizeof(T) / 4; i += 32) d[i] = 0u;
    return;
  }
  switch (chunk) {
    case 16: copy_chunks<16, N>(dst, row, col0, width, lane); break;
    case 8: copy_chunks<8, N>(dst, row, col0, width, lane); break;
    case 4: copy_chunks<4, N>(dst, row, col0, width, lane); break;
    default:  // a bf16 row of odd width: element by element
      for (int e = lane; e < N; e += 32) {
        const int c = col0 + e;
        dst[e] = (c >= 0 && c < width) ? row[c] : zero_of<T>();
      }
  }
  // end copy
}

// ---- loads from the rings into registers -----------------------------------------------

__device__ __forceinline__ void ld4(const float* p, float* v) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
}
__device__ __forceinline__ void ld4(const __nv_bfloat16* p, float* v) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 a, b;
  memcpy(&a, &t.x, 4);
  memcpy(&b, &t.y, 4);
  const float2 fa = __bfloat1622float2(a), fb = __bfloat1622float2(b);
  v[0] = fa.x, v[1] = fa.y, v[2] = fb.x, v[3] = fb.y;
}
__device__ __forceinline__ void ld2(const float* p, float* v) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x, v[1] = t.y;
}
__device__ __forceinline__ void ld2(const __nv_bfloat16* p, float* v) {
  const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = t.x, v[1] = t.y;
}

// v = NG groups of 4 consecutive elements from p (16-byte aligned f32, 8-byte bf16)
template <int NG, typename T>
__device__ __forceinline__ void load_groups(const T* p, float (&v)[4 * NG]) {
#pragma unroll
  for (int q = 0; q < NG; ++q) ld4(p + 4 * q, v + 4 * q);
}

// ---- stores of dx ---------------------------------------------------------------------

__device__ __forceinline__ void st4(float* p, const float (&v)[kStrip]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void st4(__nv_bfloat16* p, const float (&v)[kStrip]) {
  const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
  uint2 t;
  memcpy(&t.x, &a, 4);
  memcpy(&t.y, &b, 4);
  *reinterpret_cast<uint2*>(p) = t;
}

// y[o + s] = v[s] (+ add[o + s]) for the strip's columns q + s < W
template <typename TO>
__device__ __forceinline__ void store_strip(TO* y, const float* add, size_t o, int q, int W,
                                            bool vec, float (&v)[kStrip]) {
  // phase store
  if (q >= W) return;
  if (vec) {
    if (add) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(add + o));
      v[0] += a.x, v[1] += a.y, v[2] += a.z, v[3] += a.w;
    }
    st4(y + o, v);
  } else {
#pragma unroll
    for (int s = 0; s < kStrip; ++s)
      if (q + s < W) put(y, o + s, add ? v[s] + add[o + s] : v[s]);
  }
  // end store
}

// ---- the warp's reduce-scatter --------------------------------------------------------

// The k*k sums padded to a power of two, at least 32.
template <int K>
constexpr int kSumPad = K * K <= 32 ? 32 : 64;

// One stage of the reduce-scatter: lanes O apart swap halves of the M values held, and
// each adds the half it keeps to the half it receives.
template <int N, int O, int M>
__device__ __forceinline__ void scatter_stage(float (&v)[N], int lane) {
  if constexpr (O > 0) {
    const bool upper = lane & O;  // keeps the upper half
#pragma unroll
    for (int t = 0; t < M / 2; ++t) {
      const float send = upper ? v[t] : v[t + M / 2];
      const float keep = upper ? v[t + M / 2] : v[t];
      v[t] = keep + __shfl_xor_sync(0xffffffffu, send, O);
    }
    scatter_stage<N, O / 2, M / 2>(v, lane);
  }
}

// out[e] = the sum over the warp's 32 lanes of acc[e], e < k*k: after the 5 stages lane
// l holds the sums of entries [l m, (l + 1) m), m = kSumPad / 32, and writes them.
template <int K>
__device__ __forceinline__ void warp_sum(const float (&acc)[K * K], float* out) {
  constexpr int KK = K * K, N = kSumPad<K>, M = N / 32;
  float v[N];
#pragma unroll
  for (int t = 0; t < N; ++t) v[t] = t < KK ? acc[t] : 0.f;
  const int lane = threadIdx.x & 31;
  scatter_stage<N, 16, N>(v, lane);
#pragma unroll
  for (int t = 0; t < M; ++t)
    if (lane * M + t < KK) out[lane * M + t] = v[t];
}

// ---- the walks ------------------------------------------------------------------------

// The warp's place: its plane, block of the plane, column tile and band of units [u0,
// u1) (empty, or a tile past the plane's, where the warp has no work).
struct Place {
  int plane, bp, tile, u0, u1;
};
__device__ __forceinline__ Place place_of(const Geometry& geo) {
  const int warp = threadIdx.x >> 5;
  Place p;
  p.plane = blockIdx.x / geo.blocks_per_plane;
  p.bp = blockIdx.x - p.plane * geo.blocks_per_plane;
  p.tile = (p.bp % geo.tile_groups) * geo.tiles_pb + warp % geo.tiles_pb;
  const int band = (p.bp / geo.tile_groups) * geo.per_block + warp / geo.tiles_pb;
  p.u0 = geo.row0 + band * geo.band;
  p.u1 = min(p.u0 + geo.band, geo.row0 + geo.rows);
  return p;
}

// ---- z = x + up(u), a row at a time -----------------------------------------------------

// The lerp plans of an up-step's every row and column into the block's table in shared
// memory, packed: {the two coarse indices i0 | i1 << 16, the weight's bits}; then the
// block synchronises.
__device__ __forceinline__ void load_lerp_plans(int2* table, const int4* __restrict__ plans,
                                                int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int4 p = __ldg(plans + i);
    table[i] = make_int2(p.x | (p.y << 16), p.z);
  }
  __syncthreads();
}

// u's coarse rows from `next` up to the last that fine row rho reads (its row plan in
// `rplan`), into the ring `ur` of U rows (a power of two) of the coarse columns from c0/2
// - kPad that the tile at c0 reads.
__device__ __forceinline__ void copy_u_rows(float* ur, const float* up, const int2* rplan,
                                            int rho, int& next, int U, int UW, int c0,
                                            int chunk, int lane) {
  for (const int hi = max(rplan[rho].x & 0xffff, rplan[rho].x >> 16); next <= hi; ++next)
    copy_row<kRowC>(ur + (next & (U - 1)) * kRowC, up + (size_t)next * UW, c0 / 2 - kPad, UW,
                    chunk, lane);
}

// z row rho = x + up(u) into `zrow` (a row of kRow1 fp32), from x's ring row `xrow` and
// u's ring `ur`: each lane its columns c0 - k/2 + lane + 32 it, zero outside the plane;
// along H first, then along W, then + x, as recconv_kernel's walk back up. Branch-free
// (clamped reads, a select), so that it interleaves with the multiply-adds.
template <int K, typename TI>
__device__ __forceinline__ void build_z(float* zrow, const TI* xrow, const float* ur,
                                        const int2* rplan, const int2* cplan, int rho, int H,
                                        int W, int U, int c0, int lane) {
  // phase build
  constexpr int P = K / 2;
  constexpr int kBuild = (kTile + 2 * P + 31) / 32;  // z columns a lane builds a row
  const int ucol0 = c0 / 2 - kPad;
  const bool in = rho >= 0 && rho < H;
  const int2 rp = rplan[min(max(rho, 0), H - 1)];
  const float* t0r = ur + ((rp.x & 0xffff) & (U - 1)) * kRowC - ucol0;
  const float* t1r = ur + ((rp.x >> 16) & (U - 1)) * kRowC - ucol0;
  const float wr = __int_as_float(rp.y);
  const TI* xs = xrow + kPad - c0;
  float* zs = zrow + kPad - c0;
#pragma unroll
  for (int it = 0; it < kBuild; ++it) {
    const int c = c0 - P + lane + 32 * it;
    const int2 cp = cplan[min(max(c, 0), W - 1)];
    const int a0 = cp.x & 0xffff, a1 = cp.x >> 16;
    const float left = t0r[a0] + (t1r[a0] - t0r[a0]) * wr;
    const float right = t0r[a1] + (t1r[a1] - t0r[a1]) * wr;
    const float val = to_f32(xs[min(c, c0 + kTile + kPad - 1)]) +
                      (left + (right - left) * __int_as_float(cp.y));
    if (it < kBuild - 1 || lane < kTile + 2 * P - 32 * (kBuild - 1))
      zs[c] = in && c >= 0 && c < W ? val : 0.f;
  }
  // end build
}

// dx = conv^T(g) (+ add) for the k x k depthwise conv at stride S with zero padding
// k/2: g is N*C planes of OH x OW in TG, w fp32 (C, K, K), add null or fp32 planes of
// H x W, y planes of H x W in TO. At stride 1 a unit is an output row and step t brings
// input row u0 - k/2 + t; at stride 2 a unit is a pair of output rows (2m - k/2, 2m -
// k/2 + 1) and step t brings coarse row u0 - k/2 + t, after which pair u0 - k/2 + t is
// whole.
template <typename TG, typename TO, int K, int S>
__global__ void __launch_bounds__(kMaxThreads, K == 7 ? 2 : (S == 1 ? 3 : 4))
recconv_level_dgrad_kernel(const TG* __restrict__ g, const float* __restrict__ w,
                           const float* __restrict__ add, TO* __restrict__ y,
                           const Geometry geo, int C, int H, int W, int OH, int OW) {
  constexpr int P = K / 2;
  constexpr int kSlot = S == 1 ? kRow1 : kRowC;
  extern __shared__ __align__(16) float smem[];
  const Place pl = place_of(geo);
  if (pl.tile >= geo.tiles || pl.u0 >= pl.u1) return;
  const int lane = threadIdx.x & 31;
  const int c0 = pl.tile * kTile, q = c0 + kStrip * lane;
  float wk[K * K];
  const float* wc = w + (size_t)(pl.plane % C) * K * K;
#pragma unroll
  for (int i = 0; i < K * K; ++i) wk[i] = __ldg(wc + i);
  const TG* gp = g + (size_t)pl.plane * OH * OW;
  TG* ring = reinterpret_cast<TG*>(smem + (threadIdx.x >> 5) * geo.warp_words + geo.a_off);
  const size_t base = (size_t)pl.plane * H * W;
  const int NS = geo.stages, D = NS - 1;
  const int in0 = pl.u0 - P;  // the input row of step 0
  const int steps = pl.u1 - pl.u0 + (S == 1 ? 2 * P : P);
  const int col0 = (S == 1 ? c0 : c0 / 2) - kPad;
  auto issue = [&](int t) {
    const int r = in0 + t;
    copy_row<kSlot>(ring + (t & (NS - 1)) * kSlot,
                    (r >= 0 && r < OH) ? gp + (size_t)r * OW : nullptr, col0, OW, geo.chunk_a,
                    lane);
  };
  for (int d = 0; d < D; ++d) {
    if (d < steps) issue(d);
    cp_commit();
  }
  if constexpr (S == 1) {
    float acc[K][kStrip];  // the k output rows that the current input row feeds
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int s = 0; s < kStrip; ++s) acc[i][s] = 0.f;
    for (int t0 = 0; t0 < steps; t0 += K) {
#pragma unroll
      for (int u = 0; u < K; ++u) {
        const int t = t0 + u;
        if (t < steps) {
          cp_wait(NS);
          __syncwarp();
          // the window: columns q - 4 .. q + 7 of input row in0 + t
          float win[12];
          load_groups<3>(ring + (t & (NS - 1)) * kSlot + kStrip * lane + kPad - 4, win);
          if (t + D < steps) issue(t + D);
          cp_commit();
          // phase conv
          // output row in0 + t - P + i takes tap row i; its sums are acc[(u + i) % K]
#pragma unroll
          for (int i = 0; i < K; ++i)
#pragma unroll
            for (int j = 0; j < K; ++j)
#pragma unroll
              for (int s = 0; s < kStrip; ++s)
                acc[(u + i) % K][s] =
                    fmaf(wk[i * K + j], win[4 + s + P - j], acc[(u + i) % K][s]);
          // end conv
          const int r = in0 + t - P;  // whole: its last input row has passed
          if (r >= pl.u0)
            store_strip(y, add, base + (size_t)r * W + q, q, W, geo.vec, acc[u]);
#pragma unroll
          for (int s = 0; s < kStrip; ++s) acc[u][s] = 0.f;
        }
      }
    }
  } else {
    float acc[P + 1][2][kStrip];  // the pairs m = a .. a + P that coarse row a feeds
#pragma unroll
    for (int d = 0; d < P + 1; ++d)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int s = 0; s < kStrip; ++s) acc[d][e][s] = 0.f;
    for (int t0 = 0; t0 < steps; t0 += P + 1) {
#pragma unroll
      for (int u = 0; u < P + 1; ++u) {
        const int t = t0 + u;
        if (t < steps) {
          cp_wait(NS);
          __syncwarp();
          // the window: coarse columns q/2 - 2 .. q/2 + 3 of coarse row in0 + t
          float win[6];
          const TG* src = ring + (t & (NS - 1)) * kSlot + 2 * lane + kPad - 2;
#pragma unroll
          for (int h = 0; h < 3; ++h) ld2(src + 2 * h, win + 2 * h);
          if (t + D < steps) issue(t + D);
          cp_commit();
          // phase conv
          // pair a + d, its row e: tap row i = 2d + e; output column q + s: the taps j
          // with (s + P - j) even, coarse column q/2 + (s + P - j)/2
#pragma unroll
          for (int d = 0; d <= P; ++d)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              if (2 * d + e < K) {
#pragma unroll
                for (int s = 0; s < kStrip; ++s)
#pragma unroll
                  for (int j = (s + P) & 1; j < K; j += 2)
                    acc[(u + d) % (P + 1)][e][s] =
                        fmaf(wk[(2 * d + e) * K + j], win[2 + (s + P - j) / 2],
                             acc[(u + d) % (P + 1)][e][s]);
              }
          // end conv
          const int m = in0 + t;  // pair m is whole
          if (m >= pl.u0) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = 2 * m - P + e;
              if (r >= 0 && r < H)
                store_strip(y, add, base + (size_t)r * W + q, q, W, geo.vec, acc[u][e]);
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int s = 0; s < kStrip; ++s) acc[u][e][s] = 0.f;
        }
      }
    }
  }
}

// The stride-1 weight gradient's walk: acc[i k + j] += sum over the band's g rows r and
// the strip's columns of z(r + i - k/2, q + s + j - k/2) g(r, q + s). Step t brings z
// row u0 - k/2 + t and g row u0 + t (zero past the band) into g's ring of `gring` rows,
// which holds the k rows the taps read (zero before the band): a lane reads its strip
// of each, which keeps g out of registers (the step loop is not unrolled: one copy of
// its code). With u (UP), z = x + up(u) is built a row ahead into
// one of two rows of shared memory, in the same straight-line code as the current
// row's multiply-adds, so that the build's shared loads overlap them; the lerp plans
// come from the block's tables in shared memory, each {the two coarse indices i0 | i1
// << 16, the weight's bits}. Without u the window is read from x's ring.
template <bool UP, typename TI, typename TG, int K>
__device__ __forceinline__ void wgrad_walk_s1(const TI* x, const float* u, const TG* g,
                                              const Geometry& geo, const Place& pl, int H,
                                              int W, int UH, int UW, float (&acc)[K * K]) {
  constexpr int P = K / 2;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int c0 = pl.tile * kTile;
  float* const region = smem + (threadIdx.x >> 5) * geo.warp_words;
  TI* const xr = reinterpret_cast<TI*>(region + geo.a_off);
  TG* const gr = reinterpret_cast<TG*>(region + geo.b_off);
  float* const ur = region + geo.u_off;
  float* const zrows = region + geo.z_off;  // two rows
  const int2* const rplan = reinterpret_cast<const int2*>(smem + geo.plan_off);
  const int2* const cplan = rplan + H;
  const TI* xp = x + (size_t)pl.plane * H * W;
  const TG* gp = g + (size_t)pl.plane * H * W;
  const float* up = UP ? u + (size_t)pl.plane * UH * UW : nullptr;
  const int NS = geo.stages, D = NS - 1, U = geo.uring, GS = geo.gring;  // powers of two
  const int z0 = pl.u0 - P, steps = pl.u1 - pl.u0 + 2 * P;
  // the next coarse row of u to copy: the first that the band's first z row reads
  int next = 0;
  if constexpr (UP) next = min(rplan[max(z0, 0)].x & 0xffff, rplan[max(z0, 0)].x >> 16);
  auto issue = [&](int t) {
    const int rho = z0 + t, slot = t & (NS - 1);
    const bool in = rho >= 0 && rho < H;
    copy_row<kRow1>(xr + slot * kRow1, in ? xp + (size_t)rho * W : nullptr, c0 - kPad, W,
                    geo.chunk_a, lane);
    copy_row<kTile>(gr + (t & (GS - 1)) * kTile,
                    pl.u0 + t < pl.u1 ? gp + (size_t)(pl.u0 + t) * W : nullptr, c0, W,
                    geo.chunk_b, lane);
    if (UP && in) copy_u_rows(ur, up, rplan, rho, next, U, UW, c0, geo.chunk_u, lane);
  };
  auto build = [&](int t) {  // z row z0 + t into zrows[t & 1]
    build_z<K>(zrows + (t & 1) * kRow1, xr + (t & (NS - 1)) * kRow1, ur, rplan, cplan, z0 + t,
               H, W, U, c0, lane);
  };
  {  // g's rows before the band: zero
    unsigned* gz = reinterpret_cast<unsigned*>(gr);
    for (int i = lane; i < GS * kTile * (int)sizeof(TG) / 4; i += 32) gz[i] = 0u;
    __syncwarp();
  }
  for (int d = 0; d < D; ++d) {
    if (d < steps) issue(d);
    cp_commit();
  }
  if constexpr (UP) {
    cp_wait(NS);  // row 0 has landed
    __syncwarp();
    build(0);
  }
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const int slot = t & (NS - 1);
    if constexpr (UP)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // row t + 1 too (NS = 4)
    else
      cp_wait(NS);
    __syncwarp();
    float win[12];  // z at columns q - 4 .. q + 7 of row z0 + t
    if constexpr (UP)
      load_groups<3>(zrows + (t & 1) * kRow1 + kStrip * lane + kPad - 4, win);
    else
      load_groups<3>(xr + slot * kRow1 + kStrip * lane + kPad - 4, win);
    if (t + D < steps) issue(t + D);
    cp_commit();
    if constexpr (UP) build(t + 1);  // the next row's z, while this row's multiply-adds run
    // phase corr
    // z row z0 + t pairs with g row u0 + t - i at tap row i
#pragma unroll
    for (int i = 0; i < K; ++i) {
      float gv[kStrip];
      ld4(gr + ((t - i) & (GS - 1)) * kTile + kStrip * lane, gv);
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int s = 0; s < kStrip; ++s)
          acc[i * K + j] = fmaf(win[4 + s + j - P], gv[s], acc[i * K + j]);
    }
    // end corr
  }
}

// The stride-2 weight gradient's walk: acc[i k + j] += sum over the band's g rows r and
// the strip's columns of x(2r + i - k/2, 2(q + s) + j - k/2) g(r, q + s). Step t brings
// x rows 2(u0 + t) - k/2 and the next, and g row u0 + t (zero past the band); g's last
// k/2 + 1 rows stay in registers, shifted down a row each step.
template <typename TI, typename TG, int K>
__device__ __forceinline__ void wgrad_walk_s2(const TI* x, const TG* g, const Geometry& geo,
                                              const Place& pl, int H, int W, int OH, int OW,
                                              float (&acc)[K * K]) {
  constexpr int P = K / 2, R = P + 1;
  constexpr int NG = (14 + P) / 4;  // groups of 4 that cover a strip's x window
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int c0 = pl.tile * kTile;
  float* const region = smem + (threadIdx.x >> 5) * geo.warp_words;
  TI* const xr = reinterpret_cast<TI*>(region + geo.a_off);
  TG* const gr = reinterpret_cast<TG*>(region + geo.b_off);
  const TI* xp = x + (size_t)pl.plane * H * W;
  const TG* gp = g + (size_t)pl.plane * OH * OW;
  const int NS = geo.stages, D = NS - 1;
  const int x0 = 2 * pl.u0 - P, steps = pl.u1 - pl.u0 + P;
  auto issue = [&](int t) {
    const int slot = t & (NS - 1);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int rho = x0 + 2 * t + e;
      copy_row<kRow2>(xr + (2 * slot + e) * kRow2,
                      rho >= 0 && rho < H ? xp + (size_t)rho * W : nullptr, 2 * c0 - kPad, W,
                      geo.chunk_a, lane);
    }
    if (pl.u0 + t < pl.u1)
      copy_row<kTile>(gr + slot * kTile, gp + (size_t)(pl.u0 + t) * OW, c0, OW, geo.chunk_b,
                      lane);
  };
  for (int d = 0; d < D; ++d) {
    if (d < steps) issue(d);
    cp_commit();
  }
  float gs[R][kStrip];  // g's strip of row u0 + t - d
#pragma unroll
  for (int d = 0; d < R; ++d)
#pragma unroll
    for (int s = 0; s < kStrip; ++s) gs[d][s] = 0.f;
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    const int slot = t & (NS - 1);
    cp_wait(NS);
    __syncwarp();
#pragma unroll
    for (int d = R - 1; d > 0; --d)
#pragma unroll
      for (int s = 0; s < kStrip; ++s) gs[d][s] = gs[d - 1][s];
    if (pl.u0 + t < pl.u1)
      ld4(gr + slot * kTile + kStrip * lane, gs[0]);
    else
#pragma unroll
      for (int s = 0; s < kStrip; ++s) gs[0][s] = 0.f;
    if (t + D < steps) issue(t + D);
    cp_commit();
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float win[4 * NG];  // x at columns 2q - 4 .. of row 2(u0 + t) - P + e
      load_groups<NG>(xr + (2 * slot + e) * kRow2 + 2 * kStrip * lane + kPad - 4, win);
      // phase corr
      // x row 2(u0 + t) - P + e pairs with g row u0 + t - d at tap row i = 2d + e
#pragma unroll
      for (int d = 0; d <= P; ++d)
        if (2 * d + e < K) {
#pragma unroll
          for (int j = 0; j < K; ++j)
#pragma unroll
            for (int s = 0; s < kStrip; ++s)
              acc[(2 * d + e) * K + j] =
                  fmaf(win[4 + 2 * s + j - P], gs[d][s], acc[(2 * d + e) * K + j]);
        }
      // end corr
    }
  }
}

// partial[c][n * blocks_per_plane + bp][K * K] = the block's sums of z (*) g for y =
// conv(z, w) at stride S: x is N*C planes of H x W in TI, u null or fp32 planes of UH x
// UW (z = x + up(u) by the plans' rows [0, H) and columns [H, H + W)), g planes of OH x
// OW in TG.
template <typename TI, typename TG, int K, int S>
__global__ void __launch_bounds__(kMaxThreads,  // no spills: 80 registers only f32 x, k < 7
                                  K == 7 ? 1 : (S == 1 && sizeof(TI) == 4 ? 3 : 2))
recconv_level_wgrad_kernel(const TI* __restrict__ x, const float* __restrict__ u,
                           const int4* __restrict__ plans, const TG* __restrict__ g,
                           float* __restrict__ partial, const Geometry geo, int N, int C,
                           int H, int W, int OH, int OW, int UH, int UW) {
  constexpr int KK = K * K;
  extern __shared__ __align__(16) float smem[];
  const Place pl = place_of(geo);
  if (S == 1 && u)  // the lerp plans of every row and column, once a block
    load_lerp_plans(reinterpret_cast<int2*>(smem + geo.plan_off), plans, H + W);
  float acc[KK];
#pragma unroll
  for (int e = 0; e < KK; ++e) acc[e] = 0.f;
  if (pl.tile < geo.tiles && pl.u0 < pl.u1) {
    if constexpr (S == 1) {
      if (u)
        wgrad_walk_s1<true, TI, TG, K>(x, u, g, geo, pl, H, W, UH, UW, acc);
      else
        wgrad_walk_s1<false, TI, TG, K>(x, u, g, geo, pl, H, W, UH, UW, acc);
    }
    else
      wgrad_walk_s2<TI, TG, K>(x, g, geo, pl, H, W, OH, OW, acc);
  }
  // phase sums
  float* const sums = smem + geo.sums_off;
  warp_sum<K>(acc, sums + (threadIdx.x >> 5) * kSumPad<K>);
  __syncthreads();
  const int n = pl.plane / C, c = pl.plane - n * C;
  for (int e = threadIdx.x; e < KK; e += blockDim.x) {  // the warps added in order
    float s = 0.f;
    for (int v = 0; v < (int)(blockDim.x >> 5); ++v) s += sums[v * kSumPad<K> + e];
    partial[(((size_t)c * N + n) * geo.blocks_per_plane + pl.bp) * KK + e] = s;
  }
  // end sums
}

// dw[c][e] = the sum over the rows r < rows of partial[c][r][e], in a fixed tree: one
// block per (c, e); thread i adds rows i, i + 256, ... in order, then the block halves.
__global__ void __launch_bounds__(kMaxThreads)
recconv_level_wgrad_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                               int rows, int KK) {
  __shared__ float s[kMaxThreads];
  const int c = blockIdx.x / KK, e = blockIdx.x - c * KK;
  const float* p = partial + (size_t)c * rows * KK + e;
  float v = 0.f;
  for (int r = threadIdx.x; r < rows; r += kMaxThreads) v += p[(size_t)r * KK];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int h = kMaxThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) dw[blockIdx.x] = s[0];
}

// ---- the forward level ------------------------------------------------------------------

// The down conv's walk: y(r, q + s) = sum over taps (i, j) of w[i][j] x(2r + i - k/2,
// 2(q + s) + j - k/2), fp32. Step t brings x rows 2m - k/2 and 2m - k/2 + 1 for the pair m
// = u0 + t, which feed the output rows m - d (d <= k/2) at tap rows 2d and 2d + 1; the
// k/2 + 1 rows of 4 sums that a pair feeds are registers (the step loop unrolled k/2 + 1
// times), and output row m - k/2 is whole after step t.
template <typename TI, int K>
__device__ __forceinline__ void level_walk_s2(const TI* x, const float (&wk)[K * K], float* y,
                                              const Geometry& geo, const Place& pl, int H,
                                              int W, int OH, int OW) {
  constexpr int P = K / 2, R = P + 1;
  constexpr int NG = (14 + P) / 4;  // groups of 4 that cover a strip's x window
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int c0 = pl.tile * kTile, q = c0 + kStrip * lane;
  TI* const xr = reinterpret_cast<TI*>(smem + (threadIdx.x >> 5) * geo.warp_words + geo.a_off);
  const TI* xp = x + (size_t)pl.plane * H * W;
  float* const yp = y + (size_t)pl.plane * OH * OW;
  const int NS = geo.stages, D = NS - 1;
  const int x0 = 2 * pl.u0 - P, steps = pl.u1 - pl.u0 + P;
  auto issue = [&](int t) {
    const int slot = t & (NS - 1);
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int rho = x0 + 2 * t + e;
      copy_row<kRow2>(xr + (2 * slot + e) * kRow2,
                      rho >= 0 && rho < H ? xp + (size_t)rho * W : nullptr, 2 * c0 - kPad, W,
                      geo.chunk_a, lane);
    }
  };
  for (int d = 0; d < D; ++d) {
    if (d < steps) issue(d);
    cp_commit();
  }
  float acc[R][kStrip];  // output row u0 + t - d in acc[(t - d) % R]
#pragma unroll
  for (int d = 0; d < R; ++d)
#pragma unroll
    for (int s = 0; s < kStrip; ++s) acc[d][s] = 0.f;
  for (int t0 = 0; t0 < steps; t0 += R) {
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int t = t0 + u;
      if (t < steps) {
        const int slot = t & (NS - 1);
        cp_wait(NS);
        __syncwarp();
        if (t + D < steps) issue(t + D);
        cp_commit();
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float win[4 * NG];  // x at columns 2q - 4 .. of row 2(u0 + t) - P + e
          load_groups<NG>(xr + (2 * slot + e) * kRow2 + 2 * kStrip * lane + kPad - 4, win);
          // phase conv
          // output row u0 + t - d at tap row i = 2d + e, taps j in order
#pragma unroll
          for (int d = 0; d <= P; ++d)
            if (2 * d + e < K) {
#pragma unroll
              for (int j = 0; j < K; ++j)
#pragma unroll
                for (int s = 0; s < kStrip; ++s)
                  acc[(u - d + R) % R][s] = fmaf(wk[(2 * d + e) * K + j],
                                                 win[4 + 2 * s + j - P], acc[(u - d + R) % R][s]);
            }
          // end conv
        }
        const int r = pl.u0 + t - P;  // whole: its last tap row has passed
        if (r >= pl.u0)
          store_strip(yp, nullptr, (size_t)r * OW + q, q, OW, geo.vec, acc[(u + 1) % R]);
#pragma unroll
        for (int s = 0; s < kStrip; ++s) acc[(u + 1) % R][s] = 0.f;
      }
    }
  }
}

// The stride-1 conv's walk: y(r, q + s) = sum over taps (i, j) of w[i][j] z(r + i - k/2,
// q + s + j - k/2), z = x (+ up(u) with UP), rounded once to TO. Step t brings z row
// u0 - k/2 + t (built a row ahead into one of two shared rows with UP, else read from
// x's ring), which feeds the output rows u0 + t - i at tap row i; their k rows of 4 sums
// are registers, and output row u0 + t - 2(k/2) is whole after step t. The sums shift
// down a row each step (k x 4 moves): the loop is not unrolled, so that one copy of its
// code, the build's included, stays in the instruction cache, and it fits 80 registers
// (three blocks of 8 warps an SM at k <= 5).
template <bool UP, typename TI, typename TO, int K>
__device__ __forceinline__ void level_walk_s1(const TI* x, const float (&wk)[K * K],
                                              const float* u, TO* y, const Geometry& geo,
                                              const Place& pl, int H, int W, int UH, int UW) {
  constexpr int P = K / 2;
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31;
  const int c0 = pl.tile * kTile, q = c0 + kStrip * lane;
  float* const region = smem + (threadIdx.x >> 5) * geo.warp_words;
  TI* const xr = reinterpret_cast<TI*>(region + geo.a_off);
  float* const ur = region + geo.u_off;
  float* const zrows = region + geo.z_off;  // two rows
  const int2* const rplan = reinterpret_cast<const int2*>(smem + geo.plan_off);
  const int2* const cplan = rplan + H;
  const TI* xp = x + (size_t)pl.plane * H * W;
  const float* up = UP ? u + (size_t)pl.plane * UH * UW : nullptr;
  TO* const yp = y + (size_t)pl.plane * H * W;
  const int NS = geo.stages, D = NS - 1, U = geo.uring;  // powers of two
  const int z0 = pl.u0 - P, steps = pl.u1 - pl.u0 + 2 * P;
  // the next coarse row of u to copy: the first that the band's first z row reads
  int next = 0;
  if constexpr (UP) next = min(rplan[max(z0, 0)].x & 0xffff, rplan[max(z0, 0)].x >> 16);
  auto issue = [&](int t) {
    const int rho = z0 + t;
    const bool in = rho >= 0 && rho < H;
    copy_row<kRow1>(xr + (t & (NS - 1)) * kRow1, in ? xp + (size_t)rho * W : nullptr,
                    c0 - kPad, W, geo.chunk_a, lane);
    if (UP && in) copy_u_rows(ur, up, rplan, rho, next, U, UW, c0, geo.chunk_u, lane);
  };
  auto build = [&](int t) {  // z row z0 + t into zrows[t & 1]
    build_z<K>(zrows + (t & 1) * kRow1, xr + (t & (NS - 1)) * kRow1, ur, rplan, cplan, z0 + t,
               H, W, U, c0, lane);
  };
  for (int d = 0; d < D; ++d) {
    if (d < steps) issue(d);
    cp_commit();
  }
  if constexpr (UP) {
    cp_wait(NS);  // row 0 has landed
    __syncwarp();
    build(0);
  }
  float acc[K][kStrip];  // output row u0 + t - i in acc[i]
#pragma unroll
  for (int i = 0; i < K; ++i)
#pragma unroll
    for (int s = 0; s < kStrip; ++s) acc[i][s] = 0.f;
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    if constexpr (UP)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // row t + 1 too (NS = 4)
    else
      cp_wait(NS);
    __syncwarp();
    float win[12];  // z at columns q - 4 .. q + 7 of row z0 + t
    if constexpr (UP)
      load_groups<3>(zrows + (t & 1) * kRow1 + kStrip * lane + kPad - 4, win);
    else
      load_groups<3>(xr + (t & (NS - 1)) * kRow1 + kStrip * lane + kPad - 4, win);
    if (t + D < steps) issue(t + D);
    cp_commit();
    if constexpr (UP) build(t + 1);  // the next row's z, while this row's multiply-adds run
    // phase conv
    // output row u0 + t - i at tap row i
#pragma unroll
    for (int i = 0; i < K; ++i)
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int s = 0; s < kStrip; ++s)
          acc[i][s] = fmaf(wk[i * K + j], win[4 + s + j - P], acc[i][s]);
    // end conv
    const int r = pl.u0 + t - 2 * P;  // whole: its last tap row has passed
    if (r >= pl.u0) store_strip(yp, nullptr, (size_t)r * W + q, q, W, geo.vec, acc[K - 1]);
#pragma unroll
    for (int i = K - 1; i > 0; --i)
#pragma unroll
      for (int s = 0; s < kStrip; ++s) acc[i][s] = acc[i - 1][s];
#pragma unroll
    for (int s = 0; s < kStrip; ++s) acc[0][s] = 0.f;
  }
}

// y = conv(x + up(u), w) at stride S, zero padding k/2, for one level of a plane too
// large for recconv_kernel: x is N*C planes of H x W in TI, w fp32 (C, K, K), u null or
// (S = 1) fp32 planes of UH x UW upsampled to H x W by the plans' rows [0, H) and
// columns [H, H + W), y planes of OH x OW, fp32 at stride 2 and TI at stride 1.
template <typename TI, typename TO, int K, int S>
__global__ void __launch_bounds__(kMaxThreads, K == 7 ? 1 : 3)
recconv_level_kernel(const TI* __restrict__ x, const float* __restrict__ w,
                     const float* __restrict__ u, const int4* __restrict__ plans,
                     TO* __restrict__ y, const Geometry geo, int C, int H, int W, int OH,
                     int OW, int UH, int UW) {
  extern __shared__ __align__(16) float smem[];
  const Place pl = place_of(geo);
  if (S == 1 && u)  // the lerp plans of every row and column, once a block
    load_lerp_plans(reinterpret_cast<int2*>(smem + geo.plan_off), plans, H + W);
  if (pl.tile >= geo.tiles || pl.u0 >= pl.u1) return;
  float wk[K * K];
  const float* wc = w + (size_t)(pl.plane % C) * K * K;
#pragma unroll
  for (int i = 0; i < K * K; ++i) wk[i] = __ldg(wc + i);
  if constexpr (S == 2)
    level_walk_s2<TI, K>(x, wk, y, geo, pl, H, W, OH, OW);
  else if (u)
    level_walk_s1<true, TI, TO, K>(x, wk, u, y, geo, pl, H, W, UH, UW);
  else
    level_walk_s1<false, TI, TO, K>(x, wk, u, y, geo, pl, H, W, UH, UW);
}

// ---- the up-step's adjoint ---------------------------------------------------------------

// The adjoint's stores: du[o + 32 s] = v[s] for the columns q + 32 s < W (one row of a
// band, a lane's 4 columns).
__device__ __forceinline__ void store_cols(float* y, size_t o, int q, int W,
                                           const float (&v)[kStrip]) {
  // phase store
#pragma unroll
  for (int s = 0; s < kStrip; ++s)
    if (q + 32 * s < W) y[o + 32 * s] = v[s];
  // end store
}

// du[a, b] = sum_{e, f} wr[a, e] wc[b, f] dz[ri[a, e], ci[b, f]]: dz is planes of H x W,
// du planes of UH x UW, both fp32; plans holds (fine index, weight bits) entries,
// kMaxFan a coarse row from entry 0 and kMaxFan a coarse column from entry UH kMaxFan
// (ops/cuda/recconv_bwd.py:transposed_plan_table), in ascending fine index, the zero
// weights last. A warp walks a band of coarse rows [u0, u1) down a tile of kTile coarse
// columns. Step t takes the column sums of the fine rows that coarse row u0 + t reads
// first (they have landed), then its sum; after them it copies the fine rows up to the
// last that coarse row u0 + t + stages - 1 reads into the ring of `gring` rows, enough
// for those from the least that row u0 + t + 1 reads.
__global__ void __launch_bounds__(kMaxThreads, 3)
recconv_up_adjoint_kernel(const float* __restrict__ dz, const int2* __restrict__ plans,
                          float* __restrict__ du, const Geometry geo, int H, int W, int UH,
                          int UW) {
  extern __shared__ __align__(16) float smem[];
  int2* const table = reinterpret_cast<int2*>(smem + geo.plan_off);
  for (int i = threadIdx.x; i < (UH + UW) * kMaxFan; i += blockDim.x) table[i] = __ldg(plans + i);
  __syncthreads();
  const Place pl = place_of(geo);
  if (pl.tile >= geo.tiles || pl.u0 >= pl.u1) return;
  const int lane = threadIdx.x & 31;
  const int2* const rows = table;
  const int2* const cols = table + UH * kMaxFan;
  const int b0 = pl.tile * kTile + lane;  // the lane's columns b0 + 32 s
  // the groups of 32 columns that hold a column of the plane (the rest are skipped)
  const int live = min(kStrip, (UW - pl.tile * kTile + 31) / 32);
  const int fcol0 = 2 * pl.tile * kTile - kPad;  // a ring row's first fine column
  float* const region = smem + (threadIdx.x >> 5) * geo.warp_words;
  float* const ring = region + geo.a_off;
  float* const sums = region + geo.b_off;  // kMaxFan rows of kTile column sums
  const float* zp = dz + (size_t)pl.plane * H * W;
  const int NS = geo.stages, D = NS - 1, R = geo.gring;  // R a power of two
  // the lane's column entries for the tile: ring offsets and weights (0: no term)
  int off[kStrip][kMaxFan];
  float wc[kStrip][kMaxFan];
#pragma unroll
  for (int s = 0; s < kStrip; ++s)
#pragma unroll
    for (int f = 0; f < kMaxFan; ++f) {
      const int2 ce = cols[min(b0 + 32 * s, UW - 1) * kMaxFan + f];
      wc[s][f] = __int_as_float(ce.y);
      off[s][f] = wc[s][f] != 0.f ? ce.x - fcol0 : 0;
    }
  auto last = [&](int a) {  // the last fine row that coarse row a reads
    int hi = -1;
#pragma unroll
    for (int e = 0; e < kMaxFan; ++e)
      if (__int_as_float(rows[a * kMaxFan + e].y) != 0.f) hi = max(hi, rows[a * kMaxFan + e].x);
    return hi;
  };
  int next = rows[pl.u0 * kMaxFan].x;  // the next fine row to copy: the band's first
  int summed = next;                   // ... and to take the column sums of
  const int steps = pl.u1 - pl.u0;
  auto issue = [&](int t) {  // the fine rows up to the last that coarse row u0 + t reads
    for (const int hi = last(pl.u0 + t); next <= hi; ++next)
      copy_row<kRow2>(ring + (next & (R - 1)) * kRow2, zp + (size_t)next * W, fcol0, W,
                      geo.chunk_a, lane);
  };
  for (int d = 0; d < D; ++d) {
    if (d < steps) issue(d);
    cp_commit();
  }
  float* const dup = du + (size_t)pl.plane * UH * UW;
#pragma unroll 1
  for (int t = 0; t < steps; ++t) {
    cp_wait(NS);
    __syncwarp();
    const int a = pl.u0 + t;
    float acc[kStrip];
#pragma unroll
    for (int s = 0; s < kStrip; ++s) acc[s] = 0.f;
    // phase conv
#pragma unroll 1
    for (const int hi = last(a); summed <= hi; ++summed) {  // each fine row's sums once
      const float* fr = ring + (summed & (R - 1)) * kRow2;
      float* const sr = sums + (summed & (kMaxFan - 1)) * kTile + lane;
#pragma unroll
      for (int s = 0; s < kStrip; ++s)
        if (s < live) {
          float row = 0.f;
#pragma unroll
          for (int f = 0; f < kMaxFan; ++f)
            if (wc[s][f] != 0.f) row = fmaf(wc[s][f], fr[off[s][f]], row);
          sr[32 * s] = row;  // the lane's own column: no other lane reads it
        }
    }
#pragma unroll
    for (int e = 0; e < kMaxFan; ++e) {
      const int2 re = rows[a * kMaxFan + e];
      const float wr = __int_as_float(re.y);
      if (wr == 0.f) continue;
      const float* sr = sums + (re.x & (kMaxFan - 1)) * kTile + lane;
#pragma unroll
      for (int s = 0; s < kStrip; ++s)
        if (s < live) acc[s] = fmaf(wr, sr[32 * s], acc[s]);
    }
    // end conv
    __syncwarp();  // the ring rows this step read are free
    if (t + D < steps) issue(t + D);
    cp_commit();
    store_cols(dup, (size_t)a * UW + b0, b0, UW, acc);
  }
}

using bf16 = __nv_bfloat16;

template <int K, int S>
const void* dgrad_for(int g_bf16, int out_bf16) {
  switch (g_bf16 * 2 + out_bf16) {
    case 0: return reinterpret_cast<const void*>(recconv_level_dgrad_kernel<float, float, K, S>);
    case 1: return reinterpret_cast<const void*>(recconv_level_dgrad_kernel<float, bf16, K, S>);
    case 2: return reinterpret_cast<const void*>(recconv_level_dgrad_kernel<bf16, float, K, S>);
    default: return reinterpret_cast<const void*>(recconv_level_dgrad_kernel<bf16, bf16, K, S>);
  }
}

template <int K, int S>
const void* wgrad_for(int x_bf16, int g_bf16) {
  switch (x_bf16 * 2 + g_bf16) {
    case 0: return reinterpret_cast<const void*>(recconv_level_wgrad_kernel<float, float, K, S>);
    case 1: return reinterpret_cast<const void*>(recconv_level_wgrad_kernel<float, bf16, K, S>);
    case 2: return reinterpret_cast<const void*>(recconv_level_wgrad_kernel<bf16, float, K, S>);
    default: return reinterpret_cast<const void*>(recconv_level_wgrad_kernel<bf16, bf16, K, S>);
  }
}

// The forward's instantiation for (stride, input type, output type), or null: the
// stride-2 down conv writes fp32; the stride-1 conv writes its input's type.
template <int K>
const void* level_for(int stride, int in_bf16, int out_bf16) {
  if (stride == 2 && !out_bf16)
    return in_bf16 ? reinterpret_cast<const void*>(recconv_level_kernel<bf16, float, K, 2>)
                   : reinterpret_cast<const void*>(recconv_level_kernel<float, float, K, 2>);
  if (stride == 1 && in_bf16 == out_bf16)
    return in_bf16 ? reinterpret_cast<const void*>(recconv_level_kernel<bf16, bf16, K, 1>)
                   : reinterpret_cast<const void*>(recconv_level_kernel<float, float, K, 1>);
  return nullptr;
}

// The instantiation of kernel `kind` (0 dgrad, 1 wgrad, 2 the up adjoint, 3 the forward
// level) for (k, stride, the two dtype flags), or null.
const void* kernel_for(int kind, int k, int stride, int a_bf16, int b_bf16) {
  if (kind == 2) return reinterpret_cast<const void*>(recconv_up_adjoint_kernel);
  if ((stride != 1 && stride != 2) || (a_bf16 | b_bf16) > 1 || a_bf16 < 0 || b_bf16 < 0 ||
      kind < 0 || kind > 3)
    return nullptr;
#define RECCONV_LEVEL_BWD_CASE(KS)                                                   \
  case KS:                                                                           \
    if (kind == 3) return level_for<KS>(stride, a_bf16, b_bf16);                     \
    if (kind == 0)                                                                   \
      return stride == 1 ? dgrad_for<KS, 1>(a_bf16, b_bf16) : dgrad_for<KS, 2>(a_bf16, b_bf16); \
    return stride == 1 ? wgrad_for<KS, 1>(a_bf16, b_bf16) : wgrad_for<KS, 2>(a_bf16, b_bf16);
  switch (k) {
    RECCONV_LEVEL_BWD_CASE(3)
    RECCONV_LEVEL_BWD_CASE(5)
    RECCONV_LEVEL_BWD_CASE(7)
    default: return nullptr;
  }
#undef RECCONV_LEVEL_BWD_CASE
}

// The block's threads and the grid for `planes` planes, or an error; sets the kernel's
// dynamic shared memory (all of the SM's shared memory, the least L1).
cudaError_t prepare(const void* fn, const Geometry& geo, int planes, int smem, int* threads,
                    int* blocks) {
  *threads = 32 * geo.tiles_pb * geo.per_block;
  if (geo.tiles_pb < 1 || geo.per_block < 1 || *threads > kMaxThreads ||
      (geo.stages != 2 && geo.stages != 4) || geo.band < 1 || geo.blocks_per_plane < 1 ||
      smem <= 0)
    return cudaErrorInvalidValue;
  if ((long long)planes * geo.blocks_per_plane > INT_MAX) return cudaErrorInvalidConfiguration;
  *blocks = planes * geo.blocks_per_plane;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  return e;
}

bool read_geometry(const int* geometry, int geom_len, Geometry* geo) {
  if (geom_len != (int)(sizeof(Geometry) / sizeof(int))) return false;
  std::memcpy(geo, geometry, sizeof(Geometry));
  return true;
}

}  // namespace

extern "C" {

// y = conv^T(g) (+ add) for the depthwise k x k conv at `stride` (1 or 2) with zero
// padding k/2, whose input is H x W: g contiguous planes = N * C planes of ceil(H /
// stride) x ceil(W / stride), f32 (g_bf16 = 0) or bf16; w contiguous fp32 C x 1 x k x
// k; add null or contiguous fp32 planes of H x W; y planes of H x W, f32 (out_bf16 = 0)
// or bf16; geometry: `geom_len` ints in the field order of Geometry (host memory);
// smem: the block's dynamic shared bytes. Launches on `stream` and returns
// cudaGetLastError().
int recconv_level_dgrad(const void* g, const void* w, const void* add, void* y, int planes,
                        int C, int H, int W, int k, int stride, int g_bf16, int out_bf16,
                        const int* geometry, int geom_len, int smem, void* stream) {
  const void* fn = kernel_for(0, k, stride, g_bf16, out_bf16);
  Geometry geo;
  if (!fn || !read_geometry(geometry, geom_len, &geo) || planes <= 0 || C <= 0 || H <= 0 ||
      W <= 0)
    return (int)cudaErrorInvalidValue;
  int OH = (H + stride - 1) / stride, OW = (W + stride - 1) / stride, threads = 0, blocks = 0;
  cudaError_t e = prepare(fn, geo, planes, smem, &threads, &blocks);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&g, &w, &add, &y, &geo, &C, &H, &W, &OH, &OW};
  e = cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, smem,
                       static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// dw = the weight gradient of y = conv(z, w) at `stride`, z = x + up(u): x contiguous
// planes = N * C planes of H x W, f32 (x_bf16 = 0) or bf16; u null, or (stride 1 only)
// fp32 planes of ceil(H/2) x ceil(W/2) with `plans` the device lerp-plan table of that
// up-step (ops/cuda/recconv.py:lerp_plan_table(H, W, 1)); g planes of the output size
// in f32 (g_bf16 = 0) or bf16; partial fp32 scratch of C x N x blocks_per_plane x k x
// k; dw fp32 C x 1 x k x k; geometry and smem as recconv_level_dgrad's. Two launches on
// `stream` (the blocks' partial sums, then their sum); returns cudaGetLastError().
int recconv_level_wgrad(const void* x, const void* u, const void* plans, const void* g,
                        void* partial, void* dw, int N, int C, int H, int W, int k,
                        int stride, int x_bf16, int g_bf16, const int* geometry,
                        int geom_len, int smem, void* stream) {
  const void* fn = kernel_for(1, k, stride, x_bf16, g_bf16);
  Geometry geo;
  if (!fn || !read_geometry(geometry, geom_len, &geo) || N <= 0 || C <= 0 || H <= 0 ||
      W <= 0 || (u && (stride != 1 || !plans)))
    return (int)cudaErrorInvalidValue;
  if ((long long)N * C > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  int UH = (H + 1) / 2, UW = (W + 1) / 2;
  int OH = stride == 1 ? H : UH, OW = stride == 1 ? W : UW, threads = 0, blocks = 0;
  cudaError_t e = prepare(fn, geo, N * C, smem, &threads, &blocks);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&x, &u, &plans, &g, &partial, &geo, &N, &C, &H, &W, &OH, &OW, &UH, &UW};
  e = cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, smem, s);
  if (e != cudaSuccess || (e = cudaGetLastError()) != cudaSuccess) return (int)e;
  // phase tile_sum
  const int KK = k * k, rows = N * geo.blocks_per_plane;
  recconv_level_wgrad_sum_kernel<<<C * KK, kMaxThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), rows, KK);
  // end tile_sum
  return (int)cudaGetLastError();
}

// y = conv(x + up(u), w) at `stride` for one level of a peeled pyramid: x contiguous
// planes = N * C planes of H x W, f32 (in_bf16 = 0) or bf16; w contiguous fp32 C x 1 x k
// x k; u null, or (stride 1 only) contiguous fp32 planes of ceil(H/2) x ceil(W/2) with
// `plans` the device lerp-plan table of that up-step (ops/cuda/recconv.py:
// lerp_plan_table(H, W, 1)); y planes of the output size, fp32 at stride 2 (out_bf16 =
// 0), x's type at stride 1; geometry and smem as recconv_level_dgrad's. Launches on
// `stream` and returns cudaGetLastError().
int recconv_level_forward(const void* x, const void* w, const void* u, const void* plans,
                          void* y, int planes, int C, int H, int W, int k, int stride,
                          int in_bf16, int out_bf16, const int* geometry, int geom_len,
                          int smem, void* stream) {
  const void* fn = kernel_for(3, k, stride, in_bf16, out_bf16);
  Geometry geo;
  if (!fn || !read_geometry(geometry, geom_len, &geo) || planes <= 0 || C <= 0 || H <= 0 ||
      W <= 0 || (u && (stride != 1 || !plans)))
    return (int)cudaErrorInvalidValue;
  int UH = (H + 1) / 2, UW = (W + 1) / 2;
  int OH = stride == 1 ? H : UH, OW = stride == 1 ? W : UW, threads = 0, blocks = 0;
  cudaError_t e = prepare(fn, geo, planes, smem, &threads, &blocks);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&x, &w, &u, &plans, &y, &geo, &C, &H, &W, &OH, &OW, &UH, &UW};
  e = cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, smem,
                       static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// du = up^T(dz) for the up-step ceil(H/2) x ceil(W/2) -> H x W: dz contiguous fp32
// planes of H x W, du fp32 planes of the coarse size; plans the device transposed plan
// table of that up-step (ops/cuda/recconv_bwd.py:transposed_plan_table(H, W, 1));
// geometry and smem as recconv_level_dgrad's. Launches on `stream` and returns
// cudaGetLastError().
int recconv_up_adjoint(const void* dz, const void* plans, void* du, int planes, int H,
                       int W, const int* geometry, int geom_len, int smem, void* stream) {
  const void* fn = kernel_for(2, 0, 1, 0, 0);
  Geometry geo;
  if (!read_geometry(geometry, geom_len, &geo) || planes <= 0 || H <= 0 || W <= 0 || !plans)
    return (int)cudaErrorInvalidValue;
  int UH = (H + 1) / 2, UW = (W + 1) / 2, threads = 0, blocks = 0;
  cudaError_t e = prepare(fn, geo, planes, smem, &threads, &blocks);
  if (e != cudaSuccess) return (int)e;
  void* args[] = {&dz, &plans, &du, &geo, &H, &W, &UH, &UW};
  e = cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, smem,
                       static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// Registers per thread and local bytes per thread of kernel `kind` (0 dgrad: a_bf16
// for g, b_bf16 for the output; 1 wgrad: a_bf16 for x, b_bf16 for g; 2 the up adjoint;
// 3 the forward level: a_bf16 for x, b_bf16 for y).
int recconv_level_bwd_attributes(int kind, int k, int stride, int a_bf16, int b_bf16,
                                 int* registers, int* local_bytes) {
  const void* fn = kernel_for(kind, k, stride, a_bf16, b_bf16);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

const char* recconv_level_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
