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
// of one tensor, and a head may start at any alignment.
//
// Two routes, chosen on the host before the launch (ops/cuda/linear_attention_bwd.py:
// launch_config) and written into the launch record; both are one launch:
//
// - resident (linear_attention_bwd_resident): a team of 32-256 threads holds a slice
//   of a head's positions in fp32 shared memory, q, k, v and g alike, for all three
//   passes, so k and v are read from device memory once. Where a head fits, the
//   slice is the whole head and a 256-thread block packs 256 / team heads ("packed";
//   a1's N = 16 and 49). Where it does not, the head is split over the 2-8 blocks of
//   a thread-block cluster ("cluster"; a1's N = 196 and 784): each block sums its
//   slice's kv, m, dKV and dm, and after a cluster barrier every block adds the
//   blocks' partial sums from their shared memory (distributed shared memory) in
//   rank order, so all blocks hold the same bits. Each thread loads 16-byte chunks
//   that cover a slice's contiguous spans (at any alignment: the chunk is aligned
//   and the elements outside the span are dropped), four chunks in flight, and
//   stores them in fp32 rows of `pn` floats, positions padded with zeros to a
//   multiple of 4 (and rows to a multiple of 4) so that every sum may read whole
//   blocks. The outer products (kv, dKV) give each lane a 4 x 4 block of strided
//   rows (b, b + nb, b + 2 nb, b + 3 nb) and every splits-th pair of positions,
//   read as float2 and kept in registers over the whole slice; one butterfly of
//   shuffles per pass adds the splits. The products by a matrix (t, dk, dv) give
//   each lane 4 outputs by 4 positions, read as float4. r_n and b_n are dots over
//   D: each lane of t's items adds its 4 rows' share, and the lanes of a position
//   sum the shares in row-block order. There are no atomics; every sum runs in one
//   fixed order, so the same inputs give the same bits on every run. The teams of a
//   block meet at named barriers of their own; registers are held to 64 a thread
//   (__launch_bounds__(256, 4)), so an SM holds 32 warps where shared memory
//   allows (at every a1 shape).
// - tiled (linear_attention_bwd_tiled): one block per head walks N in tiles of at
//   most 128 positions three times, with scalar loads: for heads whose slice cannot
//   be resident even over 8 blocks, such as D = DV = 128 at N = 784.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at recnext_a1's stage 0 in training (batch 128, 2 heads, N = 784,
// D = DV = 24, bf16) it reads q, k, v, g and writes dq, dk, dv, 67 MB (20 us), and
// does ~10 N D DV fp32 operations a head, 1.2 GFLOP (17 us): bytes and operations
// about equally. The products are 24 wide and run on the CUDA cores in fp32: the
// tensor cores' TF32 would keep about 3 decimal digits, and the f32 gradients are
// held to 2e-5 of their largest value.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxDim = 128;  // D and DV
constexpr int kB = 8;         // tiled: rows and columns of an outer-product block; outputs
                              // of a product item (ops/cuda/linear_attention_bwd.py: BLOCK)
constexpr int kP = 2;         // tiled: positions of a product item (POSITIONS)
constexpr int kR = 4;         // resident: rows of an outer-product block, outputs of a
                              // product item (ROWS)
constexpr int kQ = 4;         // resident: positions of a product item (QUAD)
constexpr int kBatch = 4;     // resident: 16-byte loads a thread has in flight
constexpr int kTiled = 0, kResident = 1;  // the first int of a launch's geometry

// The tiled route's layout, as ops/cuda/linear_attention_bwd.py:tiled_config builds it
// (the field order is the Python tuple's). Offsets count floats of shared memory.
struct TiledGeometry {
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

// The resident route's layout, as ops/cuda/linear_attention_bwd.py:resident_config
// builds it. Offsets count floats within a team's region. kv and dKV are dr rows
// of dvr floats, each row's entries in block order (column e at (e % nbe) * kR +
// e / nbe for nbe = dvr / kR), so that a lane's 4 strided columns are 4 floats in a
// row; m and dm follow them, dr floats each.
struct ResidentGeometry {
  int n, d, dv;
  int n_fastest;        // 1: a head is D rows of N positions; 0: N rows of D values
  int team;             // threads of a team, which owns one slice of one head
  int heads_per_block;  // teams of a block (1 where cluster > 1)
  int cluster;          // blocks of a head: 1, or a cluster of 2-8 blocks
  int len;              // positions of a slice (the last rank's may be shorter)
  int pn;               // floats per position row: len rounded up to kQ, or more
  int dr, dvr;          // D and DV rounded up to kR
  int splits;           // lanes per outer-product block (a power of two, at most 32)
  int k, v, q, g;       // operand rows: k and q dr rows, v and g dvr rows, of pn floats
  int x1, x2;           // this block's sums: kv and m; dKV and dm (scaled by s2 where
                        // cluster == 1)
  int f1, f2;           // the head's sums, scaled by s2 (x1 and x2 where cluster == 1)
  int pm, pt;           // shares of q_n . m and q_n . t_n: dr / kR rows of pn floats
  int bn;               // b_n: pn floats
  int team_floats;      // floats of a team's region (a multiple of 4)
};

// Element strides of batch and head of q, k, v, g, dq, dk and dv, in that order.
struct Strides {
  long long s[14];
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// every store of the resident route's dq, dk and dv (tools/k2_bwd_phases.py replaces
// the marked line with a store that never runs, so that what feeds it stays live)
template <typename T>
__device__ __forceinline__ void store(T* p, float v) {
  // phase store
  st(p, v);
  // end store
}

// ---- the tiled route ----

// Copy positions n0 .. n0+len of a head's `rows` rows (src: the head's span) into a
// tile (row r, position n at dst[r * tp + n]), in fp32, in the order of the span.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int rows, int n0,
                                          int len, const TiledGeometry& g) {
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
                                                 const TiledGeometry& g) {
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
linear_attention_bwd_tiled(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const T* __restrict__ gr,
                            T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                            const Strides s, int H, const TiledGeometry g, float eps) {
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
cudaError_t launch_tiled(const void* q, const void* k, const void* v, const void* g, void* dq,
                   void* dk, void* dv, const Strides& s, int heads, int H, const TiledGeometry& geo,
                   int smem, float eps, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        linear_attention_bwd_tiled<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  linear_attention_bwd_tiled<T><<<heads, geo.team, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(g), static_cast<T*>(dq), static_cast<T*>(dk), static_cast<T*>(dv),
      s, H, geo, eps);
  return cudaGetLastError();
}


// ---- the resident route ----

// the lanes of one team meet at a barrier of their own (id 1 + team's index)
__device__ __forceinline__ void team_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ int misalign(const void* p) {
  return static_cast<int>(reinterpret_cast<size_t>(p) & 15);
}

// element e of a 16-byte chunk of T, as fp32
template <typename T>
__device__ __forceinline__ float chunk_elem(const uint4& c, int e);
template <>
__device__ __forceinline__ float chunk_elem<float>(const uint4& c, int e) {
  const unsigned w = e == 0 ? c.x : e == 1 ? c.y : e == 2 ? c.z : c.w;
  return __uint_as_float(w);
}
template <>
__device__ __forceinline__ float chunk_elem<__nv_bfloat16>(const uint4& c, int e) {
  const unsigned w = (e >> 1) == 0 ? c.x : (e >> 1) == 1 ? c.y : (e >> 1) == 2 ? c.z : c.w;
  return __uint_as_float((e & 1) ? (w & 0xffff0000u) : (w << 16));
}

// A slice of one operand: `pieces` contiguous pieces of `plen` elements, piece p
// starting at src + p * N; element i of piece p is (row, position) = (slow, fast) of
// p * plen + i in rows of the slice's length (n-fastest), or (fast, slow) in rows of
// the operand's rows (d-fastest).
template <typename T>
struct Slice {
  const T* src;
  float* dst;
  int pieces, plen, chunks;  // chunks: 16-byte chunks a piece may touch
};

template <typename T>
__device__ __forceinline__ Slice<T> slice_of(const T* head, float* dst, int rows, int n0,
                                             int L, const ResidentGeometry& g) {
  const bool rowwise = g.n_fastest && g.cluster > 1;  // a row piece per row
  Slice<T> s;
  s.src = head + (g.n_fastest ? (size_t)n0 : (size_t)n0 * rows);
  s.dst = dst;
  s.pieces = rowwise ? rows : 1;
  s.plen = rowwise ? L : rows * L;
  s.chunks = (30 + s.plen * (int)sizeof(T)) >> 4;
  return s;
}

template <typename V>
__device__ __forceinline__ V pick(int o, V a, V b, V c, V d) {
  return o == 0 ? a : o == 1 ? b : o == 2 ? c : d;
}

// Load the slices of k, v, q and g (s0 .. s3) into their fp32 rows: each thread takes
// chunks `team` apart across the four, kBatch loads in flight at a time.
template <typename T>
__device__ __forceinline__ void load_slices(const Slice<T> s0, const Slice<T> s1,
                                            const Slice<T> s2, const Slice<T> s3, int L, int D,
                                            int DV, const ResidentGeometry& g, int tid) {
  constexpr int sz = (int)sizeof(T), per = 16 / sz;
  const int e1 = s0.pieces * s0.chunks, e2 = e1 + s1.pieces * s1.chunks;
  const int e3 = e2 + s2.pieces * s2.chunks, total = e3 + s3.pieces * s3.chunks;
  // chunk `it`: its operand, piece, chunk index in the piece, the piece's start and length
  const auto locate = [&](int it, int& o, int& p, int& j, const T*& ps, int& plen) {
    o = (it >= e1) + (it >= e2) + (it >= e3);
    const int rel = it - pick(o, 0, e1, e2, e3);
    const int chunks = pick(o, s0.chunks, s1.chunks, s2.chunks, s3.chunks);
    p = rel / chunks;
    j = rel - p * chunks;
    ps = pick(o, s0.src, s1.src, s2.src, s3.src) + (size_t)p * g.n;
    plen = pick(o, s0.plen, s1.plen, s2.plen, s3.plen);
  };
  for (int it0 = tid; it0 < total; it0 += kBatch * g.team) {
    uint4 c[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int it = it0 + u * g.team;
      c[u] = make_uint4(0u, 0u, 0u, 0u);
      if (it < total) {
        int o, p, j, plen;
        const T* ps;
        locate(it, o, p, j, ps, plen);
        const int sh = misalign(ps);
        if (16 * j < sh + plen * sz)
          c[u] = __ldg(reinterpret_cast<const uint4*>(reinterpret_cast<const char*>(ps) - sh) + j);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int it = it0 + u * g.team;
      if (it >= total) break;
      int o, p, j, plen;
      const T* ps;
      locate(it, o, p, j, ps, plen);
      float* dst = pick(o, s0.dst, s1.dst, s2.dst, s3.dst);
      const int w = g.n_fastest ? L : ((o & 1) ? DV : D);  // the fast dimension's length
      const int i0 = (16 * j - misalign(ps)) / sz;  // the chunk's first element (may be < 0)
      const int lo = max(0, -i0);
      const int f = p * plen + i0 + lo;
      int slow = f / w, fast = f - slow * w;
#pragma unroll
      for (int e = 0; e < per; ++e) {
        if (e < lo || i0 + e >= plen) continue;
        const int row = g.n_fastest ? slow : fast, pos = g.n_fastest ? fast : slow;
        dst[row * g.pn + pos] = chunk_elem<T>(c[u], e);
        if (++fast == w) {
          fast = 0;
          ++slow;
        }
      }
    }
  }
}

// Zero positions L .. L4-1 of rows 0 .. rows-1 and every position below L4 of rows
// rows .. rows_r-1: what the sums read past the slice.
__device__ __forceinline__ void zero_pad(float* R, int rows, int rows_r, int L, int L4, int pn,
                                         int tid, int team) {
  const int w = L4 - L;
  for (int i = tid; i < rows * w; i += team) {
    const int r = i / w;
    R[r * pn + L + i - r * w] = 0.f;
  }
  for (int i = tid; i < (rows_r - rows) * L4; i += team) {
    const int r = i / L4;
    R[(rows + r) * pn + i - r * L4] = 0.f;
  }
}

// The sums over the slice's positions of A's rows by B's rows, times `scale`: for
// every 4 x 4 block (rows ab + i nba of A, bb + c nbb of B), dst[a * sd + b's block
// order] = scale sum_n A[a][n] B[b][n], and for every row a < ra of A, rowsum[a] =
// scale sum_n A[a][n] w[n] (w null: 1). Items: (block, split) first, each on every
// splits-th pair of positions, then one per row.
__device__ __forceinline__ void outer(const float* A, int nba, int ra, const float* B, int nbb,
                                      int L, int pn, int splits, float* dst, int sd,
                                      float* rowsum, const float* w, float scale, int tid,
                                      int team) {
  const int pairs = (L + 1) >> 1;  // a pad position holds 0
  const int block_items = nba * nbb * splits;
  for (int it = tid; it < block_items + ra; it += team) {
    if (it >= block_items) {
      const int a = it - block_items;
      const float2* ap = reinterpret_cast<const float2*>(A + a * pn);
      float s0 = 0.f, s1 = 0.f;  // even and odd positions, added once at the end
      if (w) {
        const float2* wp = reinterpret_cast<const float2*>(w);
        for (int j = 0; j < pairs; ++j) {
          const float2 x = ap[j], y = wp[j];
          s0 = fmaf(x.x, y.x, s0);
          s1 = fmaf(x.y, y.y, s1);
        }
      } else {
        for (int j = 0; j < pairs; ++j) {
          const float2 x = ap[j];
          s0 += x.x;
          s1 += x.y;
        }
      }
      rowsum[a] = (s0 + s1) * scale;
      continue;
    }
    const int blk = it / splits, sp = it - blk * splits;
    const int ab = blk / nbb, bb = blk - ab * nbb;
    const float* ap = A + ab * pn;
    const float* bp = B + bb * pn;
    const int ra_step = nba * pn, rb_step = nbb * pn;
    float acc[kR][kR];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int c = 0; c < kR; ++c) acc[i][c] = 0.f;
    for (int j = sp; j < pairs; j += splits) {
      float2 x[kR], y[kR];
#pragma unroll
      for (int i = 0; i < kR; ++i) x[i] = *reinterpret_cast<const float2*>(ap + i * ra_step + 2 * j);
#pragma unroll
      for (int c = 0; c < kR; ++c) y[c] = *reinterpret_cast<const float2*>(bp + c * rb_step + 2 * j);
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int c = 0; c < kR; ++c) {
          acc[i][c] = fmaf(x[i].x, y[c].x, acc[i][c]);
          acc[i][c] = fmaf(x[i].y, y[c].y, acc[i][c]);
        }
    }
    // phase butterfly
    // the splits of a block are consecutive lanes of one warp (the team is a multiple
    // of 32 and splits a power of two): a butterfly adds their blocks in one order
    if (splits > 1) {
      const unsigned group = ((2u << (splits - 1)) - 1) << ((threadIdx.x & 31) & ~(splits - 1));
      for (int off = splits >> 1; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < kR; ++i)
#pragma unroll
          for (int c = 0; c < kR; ++c) acc[i][c] += __shfl_xor_sync(group, acc[i][c], off);
      }
    }
    // end butterfly
    if (sp != 0) continue;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      float4* out = reinterpret_cast<float4*>(dst + (ab + i * nba) * sd + bb * kR);
      *out = make_float4(acc[i][0] * scale, acc[i][1] * scale, acc[i][2] * scale,
                         acc[i][3] * scale);
    }
  }
}

// acc[i][j] = sum_e M[(r0 + i rs) * mp + e's block order] P[e * pn + n + j] over e <
// 4 nbe: 4 rows of a matrix in block order (kv, dKV) by 4 positions of the rows P,
// 4 of P's rows (e = bb + c nbe) and a float4 of each of M's rows per step
__device__ __forceinline__ void product44(const float* M, int mp, int r0, int rs, const float* P,
                                          int nbe, int n, int pn, float (&acc)[kR][kQ]) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kQ; ++j) acc[i][j] = 0.f;
  for (int bb = 0; bb < nbe; ++bb) {
    float pv[kR][kQ];
#pragma unroll
    for (int c = 0; c < kR; ++c) {
      const float4 x = *reinterpret_cast<const float4*>(P + (bb + c * nbe) * pn + n);
      pv[c][0] = x.x, pv[c][1] = x.y, pv[c][2] = x.z, pv[c][3] = x.w;
    }
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float4 m = *reinterpret_cast<const float4*>(M + (r0 + i * rs) * mp + bb * kR);
      const float mv[kR] = {m.x, m.y, m.z, m.w};
#pragma unroll
      for (int c = 0; c < kR; ++c)
#pragma unroll
        for (int j = 0; j < kQ; ++j) acc[i][j] = fmaf(mv[c], pv[c][j], acc[i][j]);
    }
  }
}

// acc[i][j] = sum_{x < X} M[x * mp + o0 + i] * P[x * pn + n + j]: 4 outputs (a row of
// M's 4-float blocks) at 4 positions of the rows P
__device__ __forceinline__ void product4(const float* M, int mp, int o0, const float* P, int X,
                                         int n, int pn, float (&acc)[kR][kQ]) {
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kQ; ++j) acc[i][j] = 0.f;
#pragma unroll 2
  for (int x = 0; x < X; ++x) {
    const float4 a = *reinterpret_cast<const float4*>(M + x * mp + o0);
    const float4 b = *reinterpret_cast<const float4*>(P + x * pn + n);
    const float av[kR] = {a.x, a.y, a.z, a.w}, bv[kQ] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kQ; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <typename T>
__global__ void __launch_bounds__(256, 4)
linear_attention_bwd_resident(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v, const T* __restrict__ gr,
                              T* __restrict__ dq, T* __restrict__ dk, T* __restrict__ dv,
                              const Strides s, int heads, int H, const ResidentGeometry g,
                              float eps) {
  extern __shared__ __align__(16) float sm[];
  const int team = g.team, ti = threadIdx.x / team, tid = threadIdx.x - ti * team;
  const int C = g.cluster;
  int head, rank = 0;
  if (C > 1) {
    head = blockIdx.x / C;
    rank = (int)cg::this_cluster().block_rank();
  } else {
    head = blockIdx.x * g.heads_per_block + ti;
    if (head >= heads) return;  // a whole team
  }
  const int bar = 1 + ti;
  const int N = g.n, D = g.d, DV = g.dv, pn = g.pn, dr = g.dr, dvr = g.dvr;
  const int nbd = dr / kR, nbe = dvr / kR;
  const int n0 = rank * g.len, L = min(g.len, N - n0), L4 = (L + kQ - 1) / kQ * kQ;
  const int npg = L4 / kQ;  // position groups of a product
  const int bi = head / H, hi = head - bi * H;
  const T* qh = q + bi * s.s[0] + hi * s.s[1];
  const T* kh = k + bi * s.s[2] + hi * s.s[3];
  const T* vh = v + bi * s.s[4] + hi * s.s[5];
  const T* gh = gr + bi * s.s[6] + hi * s.s[7];
  T* dqh = dq + bi * s.s[8] + hi * s.s[9];
  T* dkh = dk + bi * s.s[10] + hi * s.s[11];
  T* dvh = dv + bi * s.s[12] + hi * s.s[13];
  float* base = sm + ti * g.team_floats;
  float* K = base + g.k;
  float* V = base + g.v;
  float* Q = base + g.q;
  float* G = base + g.g;
  float* X1 = base + g.x1;
  float* X2 = base + g.x2;
  float* F1 = base + g.f1;
  float* F2 = base + g.f2;
  float* PM = base + g.pm;
  float* PT = base + g.pt;
  float* Bn = base + g.bn;
  const float inv_n = 1.f / (float)N;
  // the head's element (row, slice position p) of a gradient with `rows` rows
  const auto at = [&](int row, int p, int rows) -> size_t {
    return g.n_fastest ? (size_t)row * N + n0 + p : (size_t)(n0 + p) * rows + row;
  };

  // phase load
  {
    load_slices<T>(slice_of(kh, K, D, n0, L, g), slice_of(vh, V, DV, n0, L, g),
                   slice_of(qh, Q, D, n0, L, g), slice_of(gh, G, DV, n0, L, g), L, D, DV, g,
                   tid);
  }
  // end load
  zero_pad(K, D, dr, L, L4, pn, tid, team);
  zero_pad(V, DV, dvr, L, L4, pn, tid, team);
  zero_pad(Q, D, dr, L, L4, pn, tid, team);
  zero_pad(G, DV, dvr, L, L4, pn, tid, team);
  team_sync(bar, team);

  // 1. this slice's k^T v (into X1: dr rows of dvr) and sum_n k (into X1 + dr * dvr),
  //    scaled by s2 where the slice is the head
  const float scale = C > 1 ? 1.f : inv_n;
  // phase pass1
  outer(K, nbd, dr, V, nbe, L, pn, g.splits, X1, dvr, X1 + dr * dvr, nullptr, scale, tid, team);
  // end pass1
  if (C > 1) {
    cg::this_cluster().sync();  // every block's sums are whole
    // phase combine
    for (int i = tid; i < dr * dvr + dr; i += team) {  // the head's sums, in rank order
      float x = 0.f;
      for (int r = 0; r < C; ++r) x += cg::this_cluster().map_shared_rank(X1, r)[i];
      F1[i] = x * inv_n;
    }
    // end combine
  }
  team_sync(bar, team);

  // 2. Items (d block db: rows db + i nbd, positions n .. n+3), at most one a lane
  //    (launch_config): t_n = kv g_n, then each item's share of q_n . m and q_n . t_n
  const bool mine = tid < nbd * npg;
  const int db = mine ? tid / npg : 0, n = mine ? (tid - db * npg) * kQ : 0;
  float t[kR][kQ];
  float mv[kR] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kR; ++i)
#pragma unroll
    for (int j = 0; j < kQ; ++j) t[i][j] = 0.f;
  if (mine) {
    // phase t_dq
    product44(F1, dvr, db, nbd, G, nbe, n, pn, t);
    // end t_dq
#pragma unroll
    for (int i = 0; i < kR; ++i) mv[i] = F1[dr * dvr + db + i * nbd];
    // phase dots
    float sm4[kQ] = {0.f, 0.f, 0.f, 0.f}, st4[kQ] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const float4 x = *reinterpret_cast<const float4*>(Q + (db + i * nbd) * pn + n);
      const float xv[kQ] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        sm4[j] = fmaf(xv[j], mv[i], sm4[j]);
        st4[j] = fmaf(xv[j], t[i][j], st4[j]);
      }
    }
    *reinterpret_cast<float4*>(PM + db * pn + n) = make_float4(sm4[0], sm4[1], sm4[2], sm4[3]);
    *reinterpret_cast<float4*>(PT + db * pn + n) = make_float4(st4[0], st4[1], st4[2], st4[3]);
    // end dots
  }
  team_sync(bar, team);
  if (mine) {
    // r_n and b_n: the shares of the position's items, in row-block order (every
    // item of a position computes the same bits)
    float r[kQ] = {0.f, 0.f, 0.f, 0.f}, b[kQ] = {0.f, 0.f, 0.f, 0.f};
    // phase dots
    {
      float sm4[kQ] = {0.f, 0.f, 0.f, 0.f}, st4[kQ] = {0.f, 0.f, 0.f, 0.f};
      for (int x = 0; x < nbd; ++x) {
        const float4 a = *reinterpret_cast<const float4*>(PM + x * pn + n);
        const float4 c = *reinterpret_cast<const float4*>(PT + x * pn + n);
        sm4[0] += a.x, sm4[1] += a.y, sm4[2] += a.z, sm4[3] += a.w;
        st4[0] += c.x, st4[1] += c.y, st4[2] += c.z, st4[3] += c.w;
      }
#pragma unroll
      for (int j = 0; j < kQ; ++j) {
        r[j] = 1.f / (sm4[j] + eps);
        b[j] = -r[j] * r[j] * st4[j];
      }
    }
    // end dots
    // phase t_dq
    // dq_n = r_n t_n + b_n m
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int d = db + i * nbd;
      if (d >= D) break;
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        if (n + j < L) store(dqh + at(d, n + j, D), fmaf(r[j], t[i][j], b[j] * mv[i]));
    }
    // end t_dq
    // phase dkv
    // a_n = r_n g_n in place of g (rows db, db + nbd, ...)
    for (int e = db; e < DV; e += nbd) {
      float4* gp = reinterpret_cast<float4*>(G + e * pn + n);
      float4 x = *gp;
      x.x *= r[0], x.y *= r[1], x.z *= r[2], x.w *= r[3];
      *gp = x;
    }
    // end dkv
    if (db == 0) *reinterpret_cast<float4*>(Bn + n) = make_float4(b[0], b[1], b[2], b[3]);
  }
  team_sync(bar, team);
  // this slice's dKV = q^T a (into X2, as kv) and dm = sum_n b_n q_n (into
  // X2 + dr * dvr), scaled by s2 where the slice is the head
  // phase dkv
  outer(Q, nbd, dr, G, nbe, L, pn, g.splits, X2, dvr, X2 + dr * dvr, Bn, scale, tid, team);
  // end dkv
  if (C > 1) {
    cg::this_cluster().sync();
    // phase combine
    for (int i = tid; i < dr * dvr + dr; i += team) {
      float x = 0.f;
      for (int r = 0; r < C; ++r) x += cg::this_cluster().map_shared_rank(X2, r)[i];
      F2[i] = x * inv_n;
    }
    // end combine
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
  }
  team_sync(bar, team);

  // 3. dk_n = s2 dKV v_n + dm / N (4 rows of dKV by v) and dv_n = s2 dKV^T k_n (4 of
  //    dKV's columns by k). Items: (output block, position group), dk's then dv's
  // phase pass3
  const int items_k = nbd * npg;
  for (int it = tid; it < items_k + nbe * npg; it += team) {
    const bool is_dk = it < items_k;
    const int j0 = is_dk ? it : it - items_k;
    const int ob = j0 / npg, p0 = (j0 - ob * npg) * kQ;
    float acc[kR][kQ];
    if (is_dk) {
      product44(F2, dvr, ob, nbd, V, nbe, p0, pn, acc);
#pragma unroll
      for (int i = 0; i < kR; ++i) {
        const float dmi = F2[dr * dvr + ob + i * nbd];
#pragma unroll
        for (int j = 0; j < kQ; ++j) acc[i][j] += dmi;
      }
    } else {
      product4(F2, dvr, ob * kR, K, D, p0, pn, acc);
    }
    const int rows = is_dk ? D : DV, nb = is_dk ? nbd : nbe;
    T* out = is_dk ? dkh : dvh;
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = ob + i * nb;
      if (row >= rows) break;
#pragma unroll
      for (int j = 0; j < kQ; ++j)
        if (p0 + j < L) store(out + at(row, p0 + j, rows), acc[i][j]);
    }
  }
  // end pass3
  // a block's shared memory stays until every peer has read its sums
  if (C > 1) asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

template <typename T>
cudaError_t launch_resident(const void* q, const void* k, const void* v, const void* g,
                            void* dq, void* dk, void* dv, const Strides& s, int heads, int H,
                            const ResidentGeometry& geo, int smem, float eps,
                            cudaStream_t stream) {
  const auto kernel = linear_attention_bwd_resident<T>;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(geo.cluster > 1
                         ? heads * geo.cluster
                         : (heads + geo.heads_per_block - 1) / geo.heads_per_block);
  cfg.blockDim = dim3(geo.team * geo.heads_per_block);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = geo.cluster > 1 ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(g), static_cast<T*>(dq),
      static_cast<T*>(dk), static_cast<T*>(dv), s, heads, H, geo, eps);
  return e != cudaSuccess ? e : cudaGetLastError();
}

bool valid(const ResidentGeometry& g, int smem) {
  const auto pow2 = [](int x) { return x > 0 && (x & (x - 1)) == 0; };
  const auto fits = [&g](int off, long long size) {
    return off >= 0 && off % 4 == 0 && off + size <= g.team_floats;
  };
  const long long mat = (long long)g.dr * g.dvr + g.dr;
  const int len4 = (g.len + kQ - 1) / kQ * kQ;
  return g.n > 0 && g.d > 0 && g.dv > 0 && g.d <= kMaxDim && g.dv <= kMaxDim &&
         (g.team == 32 || g.team == 64 || g.team == 128 || g.team == 256) &&
         g.heads_per_block >= 1 && g.team * g.heads_per_block <= 256 && g.cluster >= 1 &&
         g.cluster <= 8 && (g.cluster == 1 || g.heads_per_block == 1) && g.len >= 1 &&
         (long long)g.len * g.cluster >= g.n && (long long)(g.cluster - 1) * g.len < g.n &&
         g.pn % 4 == 0 && g.pn >= len4 && g.dr % kR == 0 && g.dvr % kR == 0 &&
         g.dr >= g.d && g.dr < g.d + kR && g.dvr >= g.dv && g.dvr < g.dv + kR &&
         pow2(g.splits) && g.splits <= 32 && g.dr / kR * (len4 / kQ) <= g.team &&
         fits(g.k, (long long)g.dr * g.pn) && fits(g.v, (long long)g.dvr * g.pn) &&
         fits(g.q, (long long)g.dr * g.pn) && fits(g.g, (long long)g.dvr * g.pn) &&
         fits(g.x1, mat) && fits(g.x2, mat) && fits(g.f1, mat) && fits(g.f2, mat) &&
         (g.cluster > 1 || (g.f1 == g.x1 && g.f2 == g.x2)) &&
         fits(g.pm, (long long)g.dr / kR * g.pn) && fits(g.pt, (long long)g.dr / kR * g.pn) &&
         fits(g.bn, g.pn) && g.team_floats % 4 == 0 &&
         (long long)g.team_floats * 4 * g.heads_per_block <= smem;
}

bool valid(const TiledGeometry& geo, int smem) {
  const auto aligned = [](int off) { return off >= 0 && off % 4 == 0; };
  return geo.n > 0 && geo.d > 0 && geo.dv > 0 && geo.d <= kMaxDim && geo.dv <= kMaxDim &&
         geo.team >= 32 && geo.team <= 256 && !(geo.team & (geo.team - 1)) && geo.tile >= 1 &&
         (long long)(geo.tiles - 1) * geo.tile < geo.n &&
         (long long)geo.tiles * geo.tile >= geo.n && geo.tp >= geo.tile && geo.dp % kB == 0 &&
         geo.dvp % kB == 0 && geo.dp >= geo.d && geo.dvp >= geo.dv && aligned(geo.mt) &&
         aligned(geo.mk) && geo.splits >= 1 && geo.splits <= 32 &&
         !(geo.splits & (geo.splits - 1)) && (long long)geo.floats * 4 <= smem;
}

template <typename T>
const void* kernel_of(int route) {
  return route == kTiled ? reinterpret_cast<const void*>(linear_attention_bwd_tiled<T>)
                         : reinterpret_cast<const void*>(linear_attention_bwd_resident<T>);
}

}  // namespace

extern "C" {

// (dq, dk, dv) = the gradient of linear_attention(q, k, v) against g = dL/dout, for
// every (batch, head). q, k, dq, dk: (B, H, N, D); v, g, dv: (B, H, N, DV); all fp32
// (is_bf16 = 0) or all bf16, each head one contiguous span in the order the geometry
// names. strides: 14 element strides, the (batch, head) strides of q, k, v, g, dq, dk
// and dv in that order; heads = B * H; geometry: `geom_len` ints (host memory), the
// route (0 tiled, 1 resident) then the fields of its geometry struct in order; smem:
// dynamic shared bytes of a block. Launches on `stream` and returns the launch's
// error (cudaErrorInvalidValue, before any launch, for a geometry it does not take).
int linear_attention_backward(const void* q, const void* k, const void* v, const void* g,
                              void* dq, void* dk, void* dv, const long long* strides, int heads,
                              int H, const int* geometry, int geom_len, int smem, float eps,
                              int is_bf16, void* stream) {
  if (heads <= 0 || H <= 0 || geom_len < 1) return (int)cudaErrorInvalidValue;
  Strides s;
  for (int i = 0; i < 14; ++i) s.s[i] = strides[i];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (geometry[0] == kTiled) {
    TiledGeometry geo;
    if (geom_len != 1 + (int)(sizeof(geo) / sizeof(int))) return (int)cudaErrorInvalidValue;
    std::memcpy(&geo, geometry + 1, sizeof(geo));
    if (!valid(geo, smem)) return (int)cudaErrorInvalidValue;
    e = is_bf16 ? launch_tiled<__nv_bfloat16>(q, k, v, g, dq, dk, dv, s, heads, H, geo, smem, eps, st)
                : launch_tiled<float>(q, k, v, g, dq, dk, dv, s, heads, H, geo, smem, eps, st);
  } else if (geometry[0] == kResident) {
    ResidentGeometry geo;
    if (geom_len != 1 + (int)(sizeof(geo) / sizeof(int))) return (int)cudaErrorInvalidValue;
    std::memcpy(&geo, geometry + 1, sizeof(geo));
    if (!valid(geo, smem)) return (int)cudaErrorInvalidValue;
    e = is_bf16 ? launch_resident<__nv_bfloat16>(q, k, v, g, dq, dk, dv, s, heads, H, geo, smem,
                                                 eps, st)
                : launch_resident<float>(q, k, v, g, dq, dk, dv, s, heads, H, geo, smem, eps, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)e;
}

// Registers per thread and local (spill and stack) bytes per thread of the route's
// kernel (0 tiled, 1 resident) instantiated for the dtype.
int linear_attention_backward_attributes(int is_bf16, int route, int* registers,
                                         int* local_bytes) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(
      &a, is_bf16 ? kernel_of<__nv_bfloat16>(route) : kernel_of<float>(route));
  if (e != cudaSuccess) return (int)e;
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// Blocks of `threads` threads and `smem` dynamic shared bytes that one SM holds at
// once, for the route's kernel instantiated for the dtype.
int linear_attention_backward_resident(int is_bf16, int route, int threads, int smem,
                                       int* blocks) {
  const void* f = is_bf16 ? kernel_of<__nv_bfloat16>(route) : kernel_of<float>(route);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(f, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, f, threads, smem);
}

const char* linear_attention_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
