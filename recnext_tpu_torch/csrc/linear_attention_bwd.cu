// Backward of kv-first linear attention with an fp32 normaliser, for Hopper (sm_90a).
//
// The gradient of recnext_tpu/ops/attention.py:linear_attention_kv_first (and of
// _qk_first, the same function), which the JAX package takes by autodiff: it has no
// Pallas backward. It is the gradient of what csrc/linear_attention.cu (K2) computes,
// with kv kept in fp32. Per (batch, head), with s2 = 1/N, q, k: N x D, v: N x DV and
// g = dL/dout: N x DV, it recomputes what it needs from q, k, v and g:
//   pass 1: kv = s2 k^T v (D x DV) and m = mean_n k (D), fp32;
//   pass 2, per position n: r_n = 1 / (q_n . m + eps) and t_n = kv g_n (D), then
//           b_n = -r_n^2 (q_n . t_n), which is -r_n (g_n . o_n) for o_n = r_n q_n kv,
//           so o is never formed, and
//           dq_n = r_n t_n + b_n m;
//           it accumulates dKV = sum_n q_n^T a_n with a_n = r_n g_n, and dm = sum_n b_n q_n;
//   pass 3, per position n: dk_n = s2 dKV v_n + dm / N and dv_n = s2 dKV^T k_n.
// Inputs and outputs are f32 or bf16; everything inside is fp32, the normaliser terms
// (r, b) included (the JAX package documents them as bf16-unstable).
//
// Layout. Each head's q, k, v, g, dq, dk and dv is one contiguous span in one of K2's
// two orders: n-fastest (D rows of N positions: the model's NCHW tensors, read in
// place) or d-fastest (N rows of D values: the (BH, N, D) layout). A head's base is
// given by batch and head strides, so q and k (and dq and dk) may be the two halves
// of one tensor. Elements are read and written one at a time, so a head may start at
// any alignment.
//
// Design. One block of `team` threads (32 to 256; ops/cuda/linear_attention_bwd.py:
// launch_config picks it from N) owns one head and walks N in tiles, three times.
// Shared memory holds, in fp32: kv^T (pass 2) then dKV^T (pass 3) as DV rows of D,
// dKV as D rows of DV, m and dm, and one tile of positions of the operands a pass
// reads (q, k, g or v, rows of `tile` positions), t, r and b. The outer products
// (kv, dKV) give each lane an 8 x 8 block and every `splits`-th position of the
// tile; the lanes of a block (consecutive lanes of one warp) sum their blocks by a
// butterfly of shuffles, and one lane adds the sum into shared memory, tile after
// tile. The row sums (m, dm) take one lane per row, over the tile's positions in
// order. The products by a matrix (t, dk, dv) give each lane 2 positions by 8
// outputs. There are no atomics, and every sum runs in one fixed order: the same
// inputs give the same bits on every run.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at recnext_a1's stage 0 in training (batch 128, 2 heads, N = 784,
// D = DV = 24, bf16) it reads q, k, v, g and writes dq, dk, dv, 67 MB (20 us), and
// does ~10 N D DV fp32 operations a head, 1.2 GFLOP (17 us): bytes and operations
// about equally. This first form reads k and v twice (the second time mostly from
// L2), loads one element per lane and does not overlap a tile's loads with the
// previous tile's arithmetic.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace {

constexpr int kMaxDim = 128;  // D and DV
constexpr int kB = 8;         // rows and columns of an outer-product block; outputs of a
                              // product item (ops/cuda/linear_attention_bwd.py: BLOCK)
constexpr int kP = 2;         // positions of a product item (POSITIONS)

// One launch's layout, as ops/cuda/linear_attention_bwd.py:launch_config builds it
// (the field order is the Python tuple's). Offsets count floats of shared memory.
struct Geometry {
  int n, d, dv;
  int n_fastest;     // 1: a head is D rows of N positions; 0: N rows of D values
  int team;          // threads of a block, which owns one head
  int tile, tiles;   // positions per tile (the last may be shorter), tiles per head
  int tp;            // floats per tile row (odd: lanes on consecutive rows miss banks)
  int dp, dvp;       // D and DV rounded up to kB: the pitches of the two matrices
  int mt;            // kv^T, then dKV^T: DV rows of dp floats
  int mk;            // dKV: D rows of dvp floats
  int vm, vdm;       // m, dm: dp floats each
  int ta, tb, tt;    // tiles: a (q or k, dp rows), b (g/a or v, dvp rows), t (dp rows)
  int tr, tbn;       // r_n and b_n of the tile's positions
  int floats;        // floats of shared memory (the block's dynamic shared bytes / 4)
  int splits;        // lanes per outer-product block (a power of two, at most 32)
};

// Element strides of batch and head of q, k, v, g, dq, dk and dv, in that order.
struct Strides {
  long long s[14];
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// Copy positions n0 .. n0+len of a head's `rows` rows (src: the head's span) into a
// tile (row r, position n at dst[r * tp + n]), in fp32, in the order of the span.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows, int n0,
                                          int len, const Geometry& g) {
  const int total = rows * len;
  if (g.n_fastest) {
    for (int i = threadIdx.x; i < total; i += g.team) {
      const int r = i / len, n = i - r * len;
      dst[r * g.tp + n] = ld(src + (size_t)r * g.n + n0 + n);
    }
  } else {
    const T* s0 = src + (size_t)n0 * rows;  // the tile is one span
    for (int i = threadIdx.x; i < total; i += g.team) {
      const int n = i / rows, r = i - n * rows;
      dst[r * g.tp + n] = ld(s0 + i);
    }
  }
}

// dst[a * sa + b * sb] += sum_{n < len} A[a][n] B[b][n] for a < RA, b < RB, and
// rowsum[a] += sum_{n < len} A[a][n] w[n] (w[n] = 1 where w is null); A and B are
// tiles of dp and dvp rows. Items: (8 x 8 block, split) first, then one per row.
__device__ __forceinline__ void outer_accumulate(const float* A, int RA, const float* B,
                                                 int RB, int len, float* dst, int sa, int sb,
                                                 float* rowsum, const float* w,
                                                 const Geometry& g) {
  const int tp = g.tp, splits = g.splits;
  const int nbb = (RB + kB - 1) / kB;
  const int block_items = (RA + kB - 1) / kB * nbb * splits;
  const int items = block_items + RA;
  for (int it = threadIdx.x; it < items; it += g.team) {
    if (it >= block_items) {
      const int a = it - block_items;
      const float* ap = A + a * tp;
      float s[2] = {0.f, 0.f};  // two chains in flight, added in a fixed order
      int n = 0;
      if (w) {
        for (; n + 1 < len; n += 2) {
          s[0] = fmaf(ap[n], w[n], s[0]);
          s[1] = fmaf(ap[n + 1], w[n + 1], s[1]);
        }
        if (n < len) s[0] = fmaf(ap[n], w[n], s[0]);
      } else {
        for (; n + 1 < len; n += 2) {
          s[0] += ap[n];
          s[1] += ap[n + 1];
        }
        if (n < len) s[0] += ap[n];
      }
      rowsum[a] += s[0] + s[1];
      continue;
    }
    const int blk = it / splits, sp = it - blk * splits;
    const int a0 = blk / nbb * kB, b0 = (blk - blk / nbb * nbb) * kB;
    const float* ap = A + a0 * tp;
    const float* bp = B + b0 * tp;
    float acc[kB][kB];
#pragma unroll
    for (int i = 0; i < kB; ++i)
#pragma unroll
      for (int j = 0; j < kB; ++j) acc[i][j] = 0.f;
    for (int n = sp; n < len; n += splits) {
      float bx[kB];
#pragma unroll
      for (int j = 0; j < kB; ++j) bx[j] = bp[j * tp + n];
#pragma unroll
      for (int i = 0; i < kB; ++i) {
        const float ax = ap[i * tp + n];
#pragma unroll
        for (int j = 0; j < kB; ++j) acc[i][j] = fmaf(ax, bx[j], acc[i][j]);
      }
    }
    // the splits of a block are consecutive lanes of one warp (block_items and the
    // team are multiples of splits): a butterfly sums their blocks in a fixed order
    if (splits > 1) {
      const unsigned group = ((2u << (splits - 1)) - 1) << ((threadIdx.x & 31) & ~(splits - 1));
      for (int off = splits >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < kB; ++i)
#pragma unroll
          for (int j = 0; j < kB; ++j) acc[i][j] += __shfl_xor_sync(group, acc[i][j], off);
      }
    }
    if (sp != 0) continue;
#pragma unroll
    for (int i = 0; i < kB; ++i) {
      if (a0 + i >= RA) break;
#pragma unroll
      for (int j = 0; j < kB; ++j)
        if (b0 + j < RB) dst[(a0 + i) * sa + (b0 + j) * sb] += acc[i][j];
    }
  }
}

// acc[p][o] = sum_{j < J} M[j * mp + o0 + o] X[j][np[p]]: kB outputs at kP positions
// of a tile X, by a matrix M of rows of mp floats (16-byte aligned rows).
__device__ __forceinline__ void product(const float* M, int mp, int o0, const float* X,
                                        int J, const int (&np)[kP], float (&acc)[kP][kB],
                                        int tp) {
#pragma unroll
  for (int p = 0; p < kP; ++p)
#pragma unroll
    for (int o = 0; o < kB; ++o) acc[p][o] = 0.f;
#pragma unroll 2
  for (int j = 0; j < J; ++j) {
    const float4 u = *reinterpret_cast<const float4*>(M + j * mp + o0);
    const float4 w = *reinterpret_cast<const float4*>(M + j * mp + o0 + 4);
    const float c[kB] = {u.x, u.y, u.z, u.w, w.x, w.y, w.z, w.w};
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const float x = X[j * tp + np[p]];
#pragma unroll
      for (int o = 0; o < kB; ++o) acc[p][o] = fmaf(x, c[o], acc[p][o]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
linear_attention_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ gr,
                            T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                            const Strides s, int H, const Geometry g, float eps) {
  extern __shared__ __align__(16) float sm[];
  const int tid = threadIdx.x, team = g.team;
  const int head = blockIdx.x, bi = head / H, hi = head - bi * H;
  const int N = g.n, D = g.d, DV = g.dv, tp = g.tp;
  const T* qh = q + bi * s.s[0] + hi * s.s[1];
  const T* kh = k + bi * s.s[2] + hi * s.s[3];
  const T* vh = v + bi * s.s[4] + hi * s.s[5];
  const T* gh = gr + bi * s.s[6] + hi * s.s[7];
  T* dqh = dq + bi * s.s[8] + hi * s.s[9];
  T* dkh = dk + bi * s.s[10] + hi * s.s[11];
  T* dvh = dv + bi * s.s[12] + hi * s.s[13];
  float* mt = sm + g.mt;
  float* mk = sm + g.mk;
  float* m = sm + g.vm;
  float* dm = sm + g.vdm;
  float* A = sm + g.ta;
  float* B = sm + g.tb;
  float* Tt = sm + g.tt;
  float* R = sm + g.tr;
  float* Bn = sm + g.tbn;
  const float inv_n = 1.f / (float)N;
  // a (d, n) element of a head: n-fastest or d-fastest, `rows` values a position
  const long long dn = g.n_fastest ? 1 : D, dd = g.n_fastest ? N : 1;
  const long long vn = g.n_fastest ? 1 : DV, ve = g.n_fastest ? N : 1;

  // every float zeroed once: the sums start at 0, and the tiles' rows past D and DV
  // (read by whole blocks, their results dropped) hold finite values
  for (int i = tid; i < g.floats; i += team) sm[i] = 0.f;
  __syncthreads();

  // 1. kv^T (into mt: entry (d, e) at e * dp + d) and ksum (into m)
  for (int t = 0; t < g.tiles; ++t) {
    const int n0 = t * g.tile, len = min(g.tile, N - n0);
    load_tile(A, kh, D, n0, len, g);
    load_tile(B, vh, DV, n0, len, g);
    __syncthreads();
    outer_accumulate(A, D, B, DV, len, mt, 1, g.dp, m, nullptr, g);
    __syncthreads();
  }
  for (int i = tid; i < DV * g.dp; i += team) mt[i] *= inv_n;  // s2 k^T v
  for (int i = tid; i < D; i += team) m[i] *= inv_n;           // mean_n k
  __syncthreads();

  // 2. dq, and the sums dKV (into mk: (d, e) at d * dvp + e) and dm
  const int nbd = (D + kB - 1) / kB, nbv = (DV + kB - 1) / kB;
  for (int t = 0; t < g.tiles; ++t) {
    const int n0 = t * g.tile, len = min(g.tile, N - n0);
    load_tile(A, qh, D, n0, len, g);
    load_tile(B, gh, DV, n0, len, g);
    __syncthreads();
    // t_n = kv g_n (items: d block by position pair), and r_n (one item a position)
    const int S = (len + kP - 1) / kP;
    for (int it = tid; it < nbd * S + len; it += team) {
      if (it >= nbd * S) {
        const int n = it - nbd * S;
        float dot = 0.f;
        for (int d = 0; d < D; ++d) dot = fmaf(A[d * tp + n], m[d], dot);
        R[n] = 1.f / (dot + eps);
        continue;
      }
      const int ob = it / S, ns = it - ob * S, o0 = ob * kB;
      const int np[kP] = {ns, min(ns + S, len - 1)};
      float acc[kP][kB];
      product(mt, g.dp, o0, B, DV, np, acc, tp);
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        if (ns + p * S >= len) break;
#pragma unroll
        for (int o = 0; o < kB; ++o) Tt[(o0 + o) * tp + ns + p * S] = acc[p][o];
      }
    }
    __syncthreads();
    // b_n = -r_n^2 (q_n . t_n)
    for (int n = tid; n < len; n += team) {
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(A[d * tp + n], Tt[d * tp + n], dot);
      Bn[n] = -R[n] * R[n] * dot;
    }
    __syncthreads();
    // dq_n = r_n t_n + b_n m, stored in the span's order; a_n = r_n g_n in place of g
    const int total = D * len;
    for (int i = tid; i < total; i += team) {
      int d, n;
      if (g.n_fastest) { d = i / len; n = i - d * len; }
      else { n = i / D; d = i - n * D; }
      st(dqh + (n0 + n) * dn + d * dd, fmaf(R[n], Tt[d * tp + n], Bn[n] * m[d]));
    }
    for (int i = tid; i < DV * len; i += team) {
      const int e = i / len, n = i - e * len;
      B[e * tp + n] *= R[n];
    }
    __syncthreads();
    outer_accumulate(A, D, B, DV, len, mk, g.dvp, 1, dm, Bn, g);
    __syncthreads();
  }
  // s2 dKV into mk and, transposed, into mt (kv^T is no longer needed); dm / N
  for (int i = tid; i < D * DV; i += team) {
    const int d = i / DV, e = i - d * DV;
    const float x = mk[d * g.dvp + e] * inv_n;
    mk[d * g.dvp + e] = x;
    mt[e * g.dp + d] = x;
  }
  for (int i = tid; i < D; i += team) dm[i] *= inv_n;
  __syncthreads();

  // 3. dk_n = s2 dKV v_n + dm / N (dKV^T's rows by v) and dv_n = s2 dKV^T k_n (dKV's
  //    rows by k); items: output block by position pair, dk's then dv's
  for (int t = 0; t < g.tiles; ++t) {
    const int n0 = t * g.tile, len = min(g.tile, N - n0);
    load_tile(A, kh, D, n0, len, g);
    load_tile(B, vh, DV, n0, len, g);
    __syncthreads();
    const int S = (len + kP - 1) / kP;
    for (int it = tid; it < (nbd + nbv) * S; it += team) {
      const bool is_dk = it < nbd * S;
      const int j = is_dk ? it : it - nbd * S;
      const int ob = j / S, ns = j - ob * S, o0 = ob * kB;
      const int np[kP] = {ns, min(ns + S, len - 1)};
      float acc[kP][kB];
      if (is_dk) product(mt, g.dp, o0, B, DV, np, acc, tp);
      else product(mk, g.dvp, o0, A, D, np, acc, tp);
      const int O = is_dk ? D : DV;
      T* out = is_dk ? dkh : dvh;
      const long long on = is_dk ? dn : vn, oo = is_dk ? dd : ve;
#pragma unroll
      for (int p = 0; p < kP; ++p) {
        const int n = ns + p * S;
        if (n >= len) break;
#pragma unroll
        for (int o = 0; o < kB; ++o)
          if (o0 + o < O)
            st(out + (n0 + n) * on + (o0 + o) * oo, is_dk ? acc[p][o] + dm[o0 + o] : acc[p][o]);
      }
    }
    __syncthreads();  // the tiles are free
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* g, void* dq,
                   void* dk, void* dv, const Strides& s, int heads, int H, const Geometry& geo,
                   int smem, float eps, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        linear_attention_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  linear_attention_bwd_kernel<T><<<heads, geo.team, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      s, H, geo, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// (dq, dk, dv) = the gradient of linear_attention(q, k, v) against g = dL/dout, for
// every (batch, head). q, k, dq, dk: (B, H, N, D); v, g, dv: (B, H, N, DV); all fp32
// (is_bf16 = 0) or all bf16, each head one contiguous span in the order the geometry
// names. strides: 14 element strides, the (batch, head) strides of q, k, v, g, dq, dk
// and dv in that order; heads = B * H; geometry: `geom_len` ints in the field order of
// Geometry (host memory); smem: dynamic shared bytes of a block. Launches on `stream`
// and returns cudaGetLastError().
int linear_attention_backward(const void* q, const void* k, const void* v, const void* g,
                              void* dq, void* dk, void* dv, const long long* strides, int heads,
                              int H, const int* geometry, int geom_len, int smem, float eps,
                              int is_bf16, void* stream) {
  Geometry geo;
  if (geom_len != (int)(sizeof(Geometry) / sizeof(int))) return (int)cudaErrorInvalidValue;
  std::memcpy(&geo, geometry, sizeof(Geometry));
  const auto aligned = [](int off) { return off >= 0 && off % 4 == 0; };
  if (heads <= 0 || H <= 0 || geo.n <= 0 || geo.d <= 0 || geo.dv <= 0 || geo.d > kMaxDim ||
      geo.dv > kMaxDim || geo.team < 32 || geo.team > 256 || (geo.team & (geo.team - 1)) ||
      geo.tile < 1 || (long long)(geo.tiles - 1) * geo.tile >= geo.n ||
      (long long)geo.tiles * geo.tile < geo.n || geo.tp < geo.tile ||
      geo.dp % kB || geo.dvp % kB || geo.dp < geo.d || geo.dvp < geo.dv ||
      !aligned(geo.mt) || !aligned(geo.mk) || geo.splits < 1 || geo.splits > 32 ||
      (geo.splits & (geo.splits - 1)) || (long long)geo.floats * 4 > smem)
    return (int)cudaErrorInvalidValue;
  Strides s;
  for (int i = 0; i < 14; ++i) s.s[i] = strides[i];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, g, dq, dk, dv, s, heads, H, geo, smem, eps, st)
              : launch<float>(q, k, v, g, dq, dk, dv, s, heads, H, geo, smem, eps, st);
  return (int)e;
}

// Registers per thread and local (spill and stack) bytes per thread of the kernel
// instantiated for the dtype.
int linear_attention_backward_attributes(int is_bf16, int* registers, int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e =
      is_bf16 ? cudaFuncGetAttributes(
                    &a, reinterpret_cast<const void*>(linear_attention_bwd_kernel<__nv_bfloat16>))
              : cudaFuncGetAttributes(
                    &a, reinterpret_cast<const void*>(linear_attention_bwd_kernel<float>));
  if (e != cudaSuccess) return (int)e;
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

const char* linear_attention_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
