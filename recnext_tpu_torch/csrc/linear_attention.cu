// kv-first linear attention with an fp32 normaliser for Hopper (sm_90a): one launch.
//
// Replaces the TPU kernel recnext_tpu/ops/pallas/linear_attention.py:pallas_linear_attention
// and computes its function for every (batch, head), with fp32 arithmetic inside:
//   kv   = k^T v                              (D x DV)
//   ksum = sum_n k                            (D)
//   out  = (q kv) / (N * (q . ksum / N + eps))
// q, k: N x D and v: N x DV per head, taken after the feature map (as the TPU kernel
// does; the feature map stays a plain elementwise op). DV may differ from D. kv stays
// fp32 for the second product (the TPU kernel rounds it to the input dtype).
//
// Layout. Each head's q, k, v and out is one contiguous span of device memory, in one
// of two orders: n-fastest (D rows of N positions: the model's NCHW tensors, read in
// place, head h at channels [h*D, (h+1)*D)) or d-fastest (N rows of D values: the
// (BH, N, D) layout of the JAX package). A head's base is given by batch and head
// strides, so q and k may be the two halves of one tensor.
//
// Design. A team of T threads (16 to 256; ops/cuda/linear_attention.py:launch_config
// picks it from N) owns one head, and a block holds several teams on consecutive heads
// where T is at most a warp. Each team walks N in tiles (one tile where the head fits
// its share of shared memory):
//   - a tile of k and v, then of q, arrives by cp.async in 16-byte chunks of the
//     contiguous spans, in the input dtype, into one of two staging buffers: the next
//     tile (and, after the last k/v tile, q's first) is in flight while this one is
//     computed. A d-fastest tile is one span; an n-fastest tile is D row pieces, one
//     span each, laid so that every row keeps the same offset within its chunk;
//   - pass 1: each thread owns an 8 x 8 block of kv for every splits-th position of
//     the tile, reading 16 values per 64 multiply-adds from rows a fixed stride apart
//     (the tiles hold whole blocks of rows; those past D and DV are read and dropped);
//     the threads of one block (consecutive lanes) sum theirs by warp shuffles, and
//     one adds the sum into kv in shared memory. The lanes left over sum k's rows
//     into ksum;
//   - pass 2: each thread takes 2 positions (a stride apart, so a warp's stores fall on
//     consecutive addresses in the NCHW order) by 8 output columns, with q . ksum for
//     the normaliser: 2 scalar and 3 broadcast loads per 18 multiply-adds (2 positions
//     share the load better over a team's lanes than 4: measured, PERF.md); it
//     scales by the fp32 normaliser's inverse and stores out in its dtype.
// Device memory sees q, k and v read once and out written once.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at recnext_a1's stage 0 (batch 256, 2 heads, N = 784, D = DV = 24, bf16)
// the function moves 77 MB and does ~0.93 GFLOP, so bytes bound it (23 us; 3.8 us at
// stage 3). The fp32 products run on the CUDA cores, which serve f32 and bf16 alike;
// their work (~14 us at stage 0) stays below the bytes' time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxDim = 128;  // D and DV
constexpr int kBD = 8;        // kv rows of one pass-1 item (ops/cuda/linear_attention.py: KV_BLOCK)
constexpr int kBE = 8;        // kv columns of one pass-1 item, out columns of a pass-2 item
constexpr int kBN = 2;        // positions of one pass-2 item (OUT_ROWS)

// One launch's layout, as ops/cuda/linear_attention.py:launch_config builds it (the
// field order is the Python tuple's). Offsets are bytes within a team's region.
struct Geometry {
  int n, d, dv;
  int n_fastest;          // 1: a head is D rows of N positions; 0: N rows of D values
  int team, heads_per_block;
  int tile, tiles;        // positions per tile (the last may be shorter), tiles per head
  int pitch;              // bytes between the row pieces of an n-fastest tile; 0: one span
  int v_off;              // bytes from a staging buffer to its v tile
  int buf0, buf1, kv, ks;  // the two staging buffers, kv (fp32, D x kv_pitch), ksum (D)
  int kv_pitch;           // floats per kv row, a multiple of kBE
  int team_bytes;         // bytes of one team's region (a multiple of 16)
  int splits;             // pass-1 lanes per kv block, each on every splits-th position
                          // (a power of two, at most 32)
  int ks_parts;           // pass-1 lanes per row of ksum
};

// Element strides of batch and head of q, k, v and out, in that order.
struct Strides {
  long long qb, qh, kb, kh, vb, vh, ob, oh;
};

__device__ __forceinline__ float ld(const char* p, float) {
  return *reinterpret_cast<const float*>(p);
}
__device__ __forceinline__ float ld(const char* p, __nv_bfloat16) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// cp.async: 16 bytes from device memory to shared memory, not waited for here
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// every group but the most recent one has landed
__device__ __forceinline__ void copy_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// a team of at most a warp synchronises its own lanes; a larger one is the block
__device__ __forceinline__ void team_sync(int team, unsigned mask) {
  if (team <= 32) __syncwarp(mask);
  else __syncthreads();
}

__device__ __forceinline__ int misalign(const char* p) {
  return static_cast<int>(reinterpret_cast<size_t>(p) & 15);
}

// A tile of one operand in a staging buffer: element (row r, position n) at byte
// at + r * rs + n * ns of shared memory (at counts from the start of smem).
struct Tile {
  int at, rs, ns;
};

// The tile of `rows` rows from position n0 of the operand whose head starts at src,
// as fetch_tile lays it out at byte `dst` of shared memory.
template <typename T>
__device__ __forceinline__ Tile tile_of(int dst, const char* src, int rows, int n0,
                                        const Geometry& g) {
  constexpr int sz = sizeof(T);
  if (g.n_fastest)
    return {dst + misalign(src + (size_t)n0 * sz), g.pitch ? g.pitch : g.n * sz, sz};
  return {dst + misalign(src + (size_t)n0 * rows * sz), sz, rows * sz};
}

// Start copying the tile (rows x len, from position n0) of the operand whose head
// starts at src into shared memory at byte dst: the 16-byte chunks of one span, or
// of each row piece of an n-fastest tile (row r's chunks at dst + r * pitch, shifted
// so that its data starts at the same offset in its chunk as row 0's).
template <typename T>
__device__ __forceinline__ void fetch_tile(char* smem, int dst, const char* src, int rows,
                                           int n0, int len, const Geometry& g, int tid) {
  constexpr int sz = sizeof(T);
  if (g.n_fastest && g.pitch) {
    const char* s0 = src + (size_t)n0 * sz;
    const int c = misalign(s0), bytes = len * sz, per_row = (bytes + 30) >> 4;
    const long long row = (long long)g.n * sz;
    for (int i = tid; i < rows * per_row; i += g.team) {
      const int r = i / per_row, j = i - r * per_row;
      const char* s = s0 + r * row;
      const int sh = misalign(s);
      if (j < ((sh + bytes + 15) >> 4))
        copy_async16(smem + dst + r * g.pitch + c - sh + 16 * j, s - sh + 16 * j);
    }
  } else {
    const char* s0 = g.n_fastest ? src : src + (size_t)n0 * rows * sz;
    const int sh = misalign(s0);
    const int chunks = (sh + (g.n_fastest ? g.n : len) * rows * sz + 15) >> 4;
    for (int i = tid; i < chunks; i += g.team) copy_async16(smem + dst + 16 * i, s0 - sh + 16 * i);
  }
}

template <typename T>
__global__ void __launch_bounds__(256, 2)
linear_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, const Strides s,
                        int heads, int H, const Geometry g, float eps) {
  extern __shared__ __align__(16) char smem[];
  const int T_ = g.team;
  const int team = threadIdx.x / T_, tid = threadIdx.x - team * T_;
  const int head = blockIdx.x * g.heads_per_block + team;
  if (head >= heads) return;  // a whole team, and a whole warp or block where T >= 32
  // the lanes of a team of at most a warp (team_sync)
  const unsigned mask = T_ >= 32 ? 0xffffffffu
                                 : ((1u << T_) - 1) << ((threadIdx.x & 31) & ~(T_ - 1));
  const int N = g.n, D = g.d, DV = g.dv;
  const int bi = head / H, hi = head - bi * H;
  const char* qh = reinterpret_cast<const char*>(q + bi * s.qb + hi * s.qh);
  const char* kh = reinterpret_cast<const char*>(k + bi * s.kb + hi * s.kh);
  const char* vh = reinterpret_cast<const char*>(v + bi * s.vb + hi * s.vh);
  T* oh = o + bi * s.ob + hi * s.oh;
  const int base = team * g.team_bytes;
  const int buf0 = base + g.buf0, buf1 = base + g.buf1;
  const auto buf = [buf0, buf1](int i) { return (i & 1) ? buf1 : buf0; };
  float* kv = reinterpret_cast<float*>(smem + base + g.kv);
  float* ks = reinterpret_cast<float*>(smem + base + g.ks);

  fetch_tile<T>(smem, buf(0), kh, D, 0, min(g.tile, N), g, tid);
  fetch_tile<T>(smem, buf(0) + g.v_off, vh, DV, 0, min(g.tile, N), g, tid);
  copy_async_commit();
  for (int i = tid; i < D * g.kv_pitch; i += T_) kv[i] = 0.f;
  for (int i = tid; i < D; i += T_) ks[i] = 0.f;

  // 1. kv and ksum. A kv item = (kv block, split): rows d0.. of k by rows e0.. of v,
  //    positions sp, sp + splits, ... of the tile. A ksum item = (row, part): one row
  //    of k summed over positions part, part + ks_parts, ... (the lanes left over).
  const int nbe = (DV + kBE - 1) / kBE;
  const int kv_items = (D + kBD - 1) / kBD * nbe * g.splits;
  const int items = kv_items + D * g.ks_parts;
  for (int t = 0; t < g.tiles; ++t) {
    const int n0 = t * g.tile, len = min(g.tile, N - n0);
    if (t + 1 < g.tiles) {
      const int n1 = n0 + g.tile, len1 = min(g.tile, N - n1);
      fetch_tile<T>(smem, buf(t + 1), kh, D, n1, len1, g, tid);
      fetch_tile<T>(smem, buf(t + 1) + g.v_off, vh, DV, n1, len1, g, tid);
    } else {
      fetch_tile<T>(smem, buf(t + 1), qh, D, 0, min(g.tile, N), g, tid);
    }
    copy_async_commit();
    copy_async_wait_prior();
    team_sync(T_, mask);
    const Tile kt = tile_of<T>(buf(t), kh, D, n0, g);
    const Tile vt = tile_of<T>(buf(t) + g.v_off, vh, DV, n0, g);
    for (int it = tid; it < items; it += T_) {
      if (it >= kv_items) {
        const int i = it - kv_items, d = i / g.ks_parts, part = i - d * g.ks_parts;
        const char* kp = smem + kt.at + d * kt.rs + part * kt.ns;
        const int step = g.ks_parts * kt.ns;
        float sum[4] = {0.f, 0.f, 0.f, 0.f};  // four chains in flight
        int n = part;
        for (; n + 3 * g.ks_parts < len; n += 4 * g.ks_parts, kp += 4 * step)
#pragma unroll
          for (int u = 0; u < 4; ++u) sum[u] += ld(kp + u * step, T());
        for (; n < len; n += g.ks_parts, kp += step) sum[0] += ld(kp, T());
        atomicAdd(ks + d, (sum[0] + sum[1]) + (sum[2] + sum[3]));
        continue;
      }
      const int blk = it / g.splits, sp = it - blk * g.splits;
      const int db = blk / nbe, d0 = db * kBD, e0 = (blk - db * nbe) * kBE;
      // rows d0.. of k and e0.. of v: whole blocks of rows lie in the staging buffer
      // (launch_config pads the tiles), and k and v rows are the same stride apart
      const int rs = kt.rs;
      const char* kp = smem + kt.at + d0 * rs + sp * kt.ns;
      const char* vp = smem + vt.at + e0 * rs + sp * vt.ns;
      const int kstep = g.splits * kt.ns, vstep = g.splits * vt.ns;
      float acc[kBD][kBE];
#pragma unroll
      for (int i = 0; i < kBD; ++i)
#pragma unroll
        for (int j = 0; j < kBE; ++j) acc[i][j] = 0.f;
      for (int n = sp; n < len; n += g.splits, kp += kstep, vp += vstep) {
        float vx[kBE];
#pragma unroll
        for (int j = 0; j < kBE; ++j) vx[j] = ld(vp + j * rs, T());
#pragma unroll
        for (int i = 0; i < kBD; ++i) {
          const float kx = ld(kp + i * rs, T());
#pragma unroll
          for (int j = 0; j < kBE; ++j) acc[i][j] = fmaf(kx, vx[j], acc[i][j]);
        }
      }
      // the splits of a block are consecutive lanes of one warp (a power of two, at
      // most 32): a butterfly sums their blocks, and the first lane adds the sum to kv
      for (int off = g.splits >> 1; off > 0; off >>= 1) {
        const unsigned group = ((2u << (g.splits - 1)) - 1) << ((threadIdx.x & 31) & ~(g.splits - 1));
#pragma unroll
        for (int i = 0; i < kBD; ++i)
#pragma unroll
          for (int j = 0; j < kBE; ++j) acc[i][j] += __shfl_xor_sync(group, acc[i][j], off);
      }
      if (sp != 0) continue;
#pragma unroll
      for (int i = 0; i < kBD; ++i) {
        if (d0 + i >= D) break;
#pragma unroll
        for (int j = 0; j < kBE; ++j)
          if (e0 + j < DV) kv[(d0 + i) * g.kv_pitch + e0 + j] += acc[i][j];
      }
    }
    team_sync(T_, mask);  // buffer t is free, and after the last tile kv is whole
  }

  // 2. out = (q kv) / (N * (q . ksum / N + eps)). Item = (column block, position
  //    group): kBN positions ns, ns + S, ... of the tile by kBE columns.
  const int nbe2 = (DV + kBE - 1) / kBE;
  const long long on = g.n_fastest ? 1 : DV, oe = g.n_fastest ? N : 1;
  for (int t = 0; t < g.tiles; ++t) {
    const int n0 = t * g.tile, len = min(g.tile, N - n0);
    if (t + 1 < g.tiles)
      fetch_tile<T>(smem, buf(g.tiles + t + 1), qh, D, n0 + g.tile,
                    min(g.tile, N - n0 - g.tile), g, tid);
    copy_async_commit();
    copy_async_wait_prior();
    team_sync(T_, mask);
    const Tile qt = tile_of<T>(buf(g.tiles + t), qh, D, n0, g);
    const int S = (len + kBN - 1) / kBN;
    for (int it = tid; it < nbe2 * S; it += T_) {
      const int eb = it / S, ns = it - eb * S, e0 = eb * kBE;
      int qr[kBN];
#pragma unroll
      for (int j = 0; j < kBN; ++j) qr[j] = qt.at + min(ns + j * S, len - 1) * qt.ns;
      float acc[kBN][kBE], dot[kBN];
#pragma unroll
      for (int j = 0; j < kBN; ++j) {
        dot[j] = 0.f;
#pragma unroll
        for (int e = 0; e < kBE; ++e) acc[j][e] = 0.f;
      }
#pragma unroll 2
      for (int d = 0; d < D; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(kv + d * g.kv_pitch + e0);
        const float4 b = *reinterpret_cast<const float4*>(kv + d * g.kv_pitch + e0 + 4);
        const float kd = ks[d];
        const float w[kBE] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
        for (int j = 0; j < kBN; ++j) {
          const float qx = ld(smem + qr[j] + d * qt.rs, T());
          dot[j] = fmaf(qx, kd, dot[j]);
#pragma unroll
          for (int e = 0; e < kBE; ++e) acc[j][e] = fmaf(qx, w[e], acc[j][e]);
        }
      }
#pragma unroll
      for (int j = 0; j < kBN; ++j) {
        const int n = ns + j * S;
        if (n >= len) break;
        const float r = 1.f / ((dot[j] / (float)N + eps) * (float)N);  // one division a row
        T* op = oh + (n0 + n) * on + e0 * oe;
#pragma unroll
        for (int e = 0; e < kBE; ++e)
          if (e0 + e < DV) st(op + e * oe, acc[j][e] * r);
      }
    }
    team_sync(T_, mask);  // buffer g.tiles + t is free
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Strides& s,
                   int heads, int H, const Geometry& g, int smem, float eps,
                   cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        linear_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  const int blocks = (heads + g.heads_per_block - 1) / g.heads_per_block;
  linear_attention_kernel<T><<<blocks, g.team * g.heads_per_block, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, heads, H, g, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out = linear_attention(q, k, v) for every (batch, head). q, k: (B, H, N, D); v, out:
// (B, H, N, DV); all fp32 (is_bf16 = 0) or all bf16, each head one contiguous span in
// the order the geometry names. strides: 8 element strides, the (batch, head) strides
// of q, k, v and out in that order; heads = B * H; geometry: `geom_len` ints in the
// field order of Geometry (host memory); smem: dynamic shared bytes of a block.
// Launches on `stream` and returns cudaGetLastError().
int linear_attention_forward(const void* q, const void* k, const void* v, void* out,
                             const long long* strides, int heads, int H, const int* geometry,
                             int geom_len, int smem, float eps, int is_bf16, void* stream) {
  Geometry g;
  if (geom_len != (int)(sizeof(Geometry) / sizeof(int))) return (int)cudaErrorInvalidValue;
  std::memcpy(&g, geometry, sizeof(Geometry));
  if (heads <= 0 || H <= 0 || g.n <= 0 || g.d <= 0 || g.dv <= 0 || g.d > kMaxDim ||
      g.dv > kMaxDim || g.team < 16 || g.team > 256 || (g.team & (g.team - 1)) ||
      g.heads_per_block < 1 || g.team * g.heads_per_block > 256 ||
      (g.team > 32 && g.heads_per_block != 1) || g.tile < 1 || g.splits < 1 ||
      g.splits > 32 || (g.splits & (g.splits - 1)) || g.splits > g.team || g.ks_parts < 1 ||
      (long long)(g.tiles - 1) * g.tile >= g.n || (long long)g.tiles * g.tile < g.n ||
      g.kv_pitch % kBE || g.team_bytes % 16 || smem < g.team_bytes * g.heads_per_block)
    return (int)cudaErrorInvalidValue;
  const Strides s = {strides[0], strides[1], strides[2], strides[3],
                     strides[4], strides[5], strides[6], strides[7]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, s, heads, H, g, smem, eps, st)
              : launch<float>(q, k, v, out, s, heads, H, g, smem, eps, st);
  return (int)e;
}

// Registers per thread and local (spill and stack) bytes per thread of the kernel
// instantiated for the dtype.
int linear_attention_kernel_attributes(int is_bf16, int* registers, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e =
      is_bf16 ? cudaFuncGetAttributes(
                    &a, reinterpret_cast<const void*>(linear_attention_kernel<__nv_bfloat16>))
              : cudaFuncGetAttributes(&a, reinterpret_cast<const void*>(linear_attention_kernel<float>));
  if (e != cudaSuccess) return (int)e;
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

const char* linear_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
