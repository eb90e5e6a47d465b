// RecConv2d backward for Hopper (sm_90a): dx and the weight gradients in one launch,
// and a second launch of this source that sums the weight gradients over the batch.
//
// The gradient of recnext_tpu/ops/recconv.py:rec_conv2d (bias-free, bilinear with
// align_corners=False or nearest up-steps), the function the JAX package trains the
// M family through; it has no Pallas backward there (JAX's autodiff takes it). With
// weights W_d (the shared stride-2 down conv) and W_0 .. W_L (W_0 at the coarsest
// level), f_0 = x, f_j = D(f_{j-1}), h_L = f_L, h_j = f_j + up(conv(h_{j+1}, W_{L-j-1}))
// and y = conv(h_0, W_L), given g = dL/dy:
//   sweep 1, fine to coarse: dW_L = corr(h_0, g), dh_0 = convT(g, W_L); then for
//     j = 1..L: dy_j = upT(dh_{j-1}), dW_{L-j} = corr(h_j, dy_j), dh_j = convT(dy_j, W_{L-j});
//   sweep 2, coarse to fine: df_L = dh_L; for j = L..1: dW_d += corr_s2(f_{j-1}, df_j),
//     df_{j-1} = dh_{j-1} + DT(df_j); dx = df_0.
// convT is the stride-1 conv with the kernel rotated by 180 degrees, DT the stride-2
// conv's adjoint, upT the resize's adjoint.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): the function must read x and g and write dx, and do about three times the
// forward's fp32 operations (the recomputed forward, convT and corr at every level, and
// DT with corr_s2 at every downsample), so at m1's shapes the fp32 operations bound it
// (0.55 ms over an m1 train step at batch 128). There is no matrix product for the
// tensor cores. In practice what bounds it is the rate of shared-memory loads and
// shuffles (one warp-wide instruction a clock an SM, against four warp-wide multiply-
// adds), the lanes left idle by small planes and coarse levels, and the planes an SM
// holds at once, which shared memory limits: the backward keeps two to three fp32
// pyramids a plane, about three times the forward's.
//
// Design. Every (n, c) plane is independent. The kernel recomputes the pyramid f and
// the sums h from x in fp32 shared memory (the forward saves only x and the weights),
// then walks the gradient pyramid; every adjoint is a gather, so it uses no atomics and
// gives the same bits on every run. Its design, in the three steps it was built in:
//   1. Teams, and planes of one channel per block. A team of T threads (8 to 256, a
//      power of two; ops/cuda/recconv_bwd.py:team_size picks it from the plane's area)
//      owns one plane, and a block of 256 threads holds 256/T teams, which take the
//      planes (n, c) of one channel c at consecutive n: the block loads the channel's
//      (L+2) k*k weights once for them. The grid is one wave of resident blocks that
//      walk over the items (c, group of n). A team synchronises alone (__syncwarp
//      within a warp, a named barrier above). Each weight gradient is summed over a
//      team's lanes by a reduce-scatter of log2(lanes) shuffle stages (about k*k
//      shuffles, not k*k log2(lanes)) into one row per fragment (a team's lanes within
//      one warp) in shared memory; at an item's end the block adds the rows in order
//      into a (C, groups, L+2, k, k) buffer, and recconv_bwd_sum_kernel adds the
//      groups of each channel in order. Small planes no longer run 64-thread blocks of
//      mostly idle lanes through block-wide barriers and sums.
//   2. Weights in registers and register strips. Each conv, its adjoint (the conv
//      with the weights loaded rotated) and the down conv's adjoint load their k*k
//      weights into registers, and every conv and correlation computes a strip of 4
//      outputs along a row with each tap row's window in registers: (4 + k - 1) loads
//      for 4k multiply-adds, not 2 loads a multiply-add. The down conv's adjoint
//      resolves its tap parities per strip at compile time (the rows' by a's parity,
//      the columns' by the position in the strip). Consecutive lanes take consecutive
//      rows and every row pitch is odd, so one load's lanes hit distinct banks (teams
//      within one warp are spaced by T modulo 32 words).
//   3. Shared-memory cuts. Every step writes only the interiors of its haloed
//      buffers, so each team zeroes its halo rings once a block. Level 0 holds two
//      buffers (x, h_0 in place, dh_0, df_0; and scratch, g, scratch, x read again for
//      sweep 2), and each level l > 0 three (f_l; h_l then dh_l; scratch then dy_l),
//      as ops/cuda/recconv_bwd.py:_team_layout lays them out and passes the offsets as
//      `Geometry`. Each block copies the plan tables into shared memory; the loops
//      walk rows and columns without a division.
// upT reads, for each coarse index, the fine indices and weights that read it (at most
// 4 per axis), from a transposed plan table built on the host from the same per-axis
// plans as the forward kernel's (columns, then rows); DT keeps the taps u with
// (i + k/2 - u) even and reads (i + k/2 - u) / 2 inside the zero halo. x and g are f32
// or bf16 (one type); dx is written in that type; the weights are read as fp32 and the
// weight gradients are fp32. Planes whose backward does not fit in one block's shared
// memory are refused by the host before any launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>
#include <cstring>

namespace {

constexpr int kMaxLevel = 4;
constexpr int kLevels = kMaxLevel + 1;
constexpr int kMaxFan = 4;  // fine indices that read one coarse index, per axis
constexpr int kBlockThreads = 256;

// The block's shared-memory layout, in 4-byte words, as ops/cuda/recconv_bwd.py:
// launch_config builds it (the field order is the Python tuple's). A team's buffers
// are haloed: interior (r, c) of a level-l buffer at base + (r + k/2) * pitch[l] + c +
// k/2. Each holds several planes in turn, as the sweeps free them (dh_l is in F[0]
// at l = 0, in F[level] at l = level, else in H[l]):
struct Geometry {
  int level;
  int h[kLevels];
  int w[kLevels];
  int pitch[kLevels];
  int f[kLevels];      // F[0]: x, h_0, dh_0, df_0 = dx; F[l]: f_l (F[level]: then dh, df)
  int hb[kLevels];     // H[0]: the sums' lerp scratch, g, upT scratch, x; H[l], 0 < l <
                       // level: h_l, then dh_l, df_l
  int gb[kLevels];     // G[l], l > 0: the sums' conv output and lerp scratch, dy_l, then
                       // upT scratch
  int frows[kLevels];  // forward lerp table (int4 rows): up-step l -> l-1, row plan
  int fcols[kLevels];  // ... and column plan
  int brows[kLevels];  // transposed table (int2 entries): up-step l's row plan
  int bcols[kLevels];  // ... and column plan
  int team_words;      // words from one team's region to the next
  // block-wide, after the teams: the channel's (level + 2) k*k weights (down, conv0
  // .. conv{level}); one (level + 2) k*k row of weight-gradient sums for each fragment
  // of a team (the lanes of a team within one warp); copies of the two plan tables,
  // and their sizes in words
  int wts, slots, fplan, bplan, fplan_words, bplan_words;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int K>
__device__ __forceinline__ float* interior(float* sm, int base, int pitch) {
  return sm + base + (K / 2) * pitch + K / 2;
}

// The threads of one team: a team of at most 32 threads lies within one warp; larger
// teams wait at their own named barrier (1 + team; 0 is __syncthreads').
struct Team {
  int tid, nt, id;
  __device__ __forceinline__ void sync() const {
    if (nt <= 32)
      __syncwarp();
    else if (nt == (int)blockDim.x)
      __syncthreads();
    else
      asm volatile("bar.sync %0, %1;\n" ::"r"(id + 1), "r"(nt) : "memory");
  }
};

// A 2-D walk over an oh x ow grid by a team: a power-of-two number of threads along a
// row (the least that covers ow, at most the team), the rest down the rows.
struct Walk {
  int q0, dq, r0, dr;
};
__device__ __forceinline__ Walk walk(int ow, const Team& tm) {
  int lg = 0;
  while ((1 << lg) < ow && (2 << lg) <= tm.nt) ++lg;
  return {tm.tid & ((1 << lg) - 1), 1 << lg, tm.tid >> lg, tm.nt >> lg};
}

// dst[r * dpitch + q] = src[r * spitch + q] for an h x w plane, converted to dst's
// type. Consecutive threads take consecutive columns; each takes four rows at a time
// and loads all four before it stores.
template <typename D, typename S>
__device__ __forceinline__ void copy_plane(D* dst, int dpitch, const S* src, int spitch,
                                           int h, int w, const Team& tm) {
  const Walk wk = walk(w, tm);
  for (int q = wk.q0; q < w; q += wk.dq)
    for (int r = wk.r0; r < h; r += 4 * wk.dr) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = to_f32(src[min(r + u * wk.dr, h - 1) * spitch + q]);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r + u * wk.dr < h) store(dst + (r + u * wk.dr) * dpitch + q, v[u]);
    }
}

// Zero the k/2 ring around an h x w interior of a buffer with row pitch `pitch` (the
// columns right of the ring, which only dropped outputs read, too).
template <int P>
__device__ void zero_ring(float* b, int h, int w, int pitch, const Team& tm) {
  const Walk top = walk(pitch, tm);
  for (int r = top.r0; r < 2 * P; r += top.dr)
    for (int q = top.q0; q < pitch; q += top.dq) b[(r < P ? r : h + r) * pitch + q] = 0.f;
  const int side = pitch - w;  // P on the left, the rest on the right
  const Walk mid = walk(side, tm);
  for (int r = mid.r0; r < h; r += mid.dr)
    for (int q = mid.q0; q < side; q += mid.dq) b[(r + P) * pitch + (q < P ? q : w + q)] = 0.f;
}

// Outputs one thread computes along a row (ops/cuda/recconv_bwd.py: STRIP).
constexpr int kStrip = 4;

// A walk over the strips of an oh x ow grid by a team: consecutive threads take
// consecutive rows (a power of two of them, the least that covers oh, at most a warp
// or the team), so with an odd row pitch one tap's loads fall in distinct banks; the
// rest take strips further along the rows.
struct Strips {
  int r0, dr, q0, dq;
};
__device__ __forceinline__ Strips strips(int oh, const Team& tm) {
  int lg = 0;
  while ((1 << lg) < oh && lg < 5 && (2 << lg) <= tm.nt) ++lg;
  return {tm.tid & ((1 << lg) - 1), 1 << lg, (tm.tid >> lg) * kStrip, (tm.nt >> lg) * kStrip};
}

// A conv's k*k weights from shared memory into registers; rotated by 180 degrees for
// the stride-1 conv's adjoint.
template <int K, bool ROTATE = false>
__device__ __forceinline__ void load_weights(float (&wk)[K * K], const float* src) {
#pragma unroll
  for (int i = 0; i < K * K; ++i) wk[i] = src[ROTATE ? K * K - 1 - i : i];
}

// kStrip outputs of a k x k conv of the given stride along one row. `src` is the
// top-left of the first output's window in a haloed buffer of row pitch `pitch`.
// Each tap row slides through registers: stride * (kStrip - 1) + k loads feed
// kStrip * k multiply-adds.
template <int K, int S>
__device__ __forceinline__ void conv_strip(const float* src, int pitch,
                                           const float (&wk)[K * K], float (&acc)[kStrip]) {
  constexpr int kWin = S * (kStrip - 1) + K;
#pragma unroll
  for (int s = 0; s < kStrip; ++s) acc[s] = 0.f;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    float win[kWin];
#pragma unroll
    for (int j = 0; j < kWin; ++j) win[j] = src[u * pitch + j];
#pragma unroll
    for (int s = 0; s < kStrip; ++s)
#pragma unroll
      for (int v = 0; v < K; ++v) acc[s] = fmaf(win[S * s + v], wk[u * K + v], acc[s]);
  }
}

// dst[q0 + s] = acc[s] for the outputs left of column ow
__device__ __forceinline__ void store_strip(float* dst, int q0, int ow,
                                            const float (&acc)[kStrip]) {
#pragma unroll
  for (int s = 0; s < kStrip; ++s)
    if (q0 + s < ow) dst[q0 + s] = acc[s];
}

// out(r, c) = sum_{u,v} wk[u][v] in(S r + u - k/2, S c + v - k/2) for an oh x ow
// output: in haloed (interior pointer; its row pitch covers the strips past the
// edge, whose outputs are dropped), out at out[r * op + c]. With the weights loaded
// rotated (load_weights<K, true>), the stride-1 conv is the adjoint of the stride-1
// conv: out(a, b) = sum w[u][v] dy(a - u + k/2, b - v + k/2).
template <int K, int S>
__device__ __forceinline__ void conv(const float* in, int ip, const float (&wk)[K * K],
                                     float* out, int op, int oh, int ow, const Team& tm) {
  constexpr int P = K / 2;
  const Strips st = strips(oh, tm);
  for (int r = st.r0; r < oh; r += st.dr)
    for (int q = st.q0; q < ow; q += st.dq) {
      float acc[kStrip];
      conv_strip<K, S>(in + (S * r - P) * ip + S * q - P, ip, wk, acc);
      store_strip(out + r * op, q, ow, acc);
    }
}

// acc[u][v] += sum_{r,c} dy(r, c) in(S r + u - k/2, S c + v - k/2) over this thread's
// strips of the oh x ow grid of dy: the weight gradient of a stride-S conv, in haloed.
// A strip's kStrip values of dy stay in registers (zero past the edge) and each tap
// row of `in` slides through registers.
template <int K, int S>
__device__ __forceinline__ void corr(const float* in, int ip, const float* dy, int dp,
                                     int oh, int ow, float (&acc)[K * K], const Team& tm) {
  constexpr int P = K / 2, kWin = S * (kStrip - 1) + K;
  const Strips st = strips(oh, tm);
  for (int r = st.r0; r < oh; r += st.dr)
    for (int q = st.q0; q < ow; q += st.dq) {
      float d[kStrip];
#pragma unroll
      for (int s = 0; s < kStrip; ++s) {
        const float v = dy[r * dp + q + s];  // the pitch covers the strip
        d[s] = q + s < ow ? v : 0.f;
      }
      const float* src = in + (S * r - P) * ip + S * q - P;
#pragma unroll
      for (int u = 0; u < K; ++u) {
        float win[kWin];
#pragma unroll
        for (int j = 0; j < kWin; ++j) win[j] = src[u * ip + j];
#pragma unroll
        for (int v = 0; v < K; ++v)
#pragma unroll
          for (int s = 0; s < kStrip; ++s)
            acc[u * K + v] = fmaf(d[s], win[S * s + v], acc[u * K + v]);
      }
    }
}

// The columns of df that a strip of the stride-2 conv's adjoint reads, relative to
// q0 / 2 for a strip that starts at an even column q0: output q0 + s reads the taps v
// with (s + k/2 - v) even at (s + k/2 - v) / 2.
template <int K>
__host__ __device__ constexpr int dt_lo() {
  int lo = K;
  for (int s = 0; s < kStrip; ++s)
    for (int v = 0; v < K; ++v)
      if ((s + K / 2 - v) % 2 == 0 && (s + K / 2 - v) / 2 < lo) lo = (s + K / 2 - v) / 2;
  return lo;
}
template <int K>
__host__ __device__ constexpr int dt_hi() {
  int hi = -K;
  for (int s = 0; s < kStrip; ++s)
    for (int v = 0; v < K; ++v)
      if ((s + K / 2 - v) % 2 == 0 && (s + K / 2 - v) / 2 > hi) hi = (s + K / 2 - v) / 2;
  return hi;
}

// One row a of the stride-2 conv's adjoint for a strip at even column q0, the taps u
// of parity PA = (a + k/2) & 1: rows (a + k/2 - u) / 2 of df.
template <int K, int PA>
__device__ __forceinline__ void down_t_strip(const float* df, int dp, int a, int q0,
                                             const float (&wk)[K * K],
                                             float (&acc)[kStrip]) {
  constexpr int P = K / 2, lo = dt_lo<K>(), n = dt_hi<K>() - lo + 1;
  const int a2 = (a + P - PA) / 2;  // row of df read by tap u = PA
#pragma unroll
  for (int u = PA; u < K; u += 2) {
    const float* row = df + (a2 - (u - PA) / 2) * dp + q0 / 2 + lo;
    float win[n];
#pragma unroll
    for (int j = 0; j < n; ++j) win[j] = row[j];
#pragma unroll
    for (int s = 0; s < kStrip; ++s)
#pragma unroll
      for (int v = (s + P) & 1; v < K; v += 2)
        acc[s] = fmaf(wk[u * K + v], win[(s + P - v) / 2 - lo], acc[s]);
  }
}

// out(a, b) += sum w[u][v] df((a + k/2 - u) / 2, (b + k/2 - v) / 2) over the taps whose
// (a + k/2 - u) and (b + k/2 - v) are even: the adjoint of the stride-2 conv, df haloed
// (the taps reach at most k/2 past its edge; its row pitch covers the strips past the
// edge). The tap parities are fixed for a strip: the rows' by a, the columns' by s.
template <int K>
__device__ __forceinline__ void down_t_add(const float* df, int dp, const float (&wk)[K * K],
                                           float* out, int op, int oh, int ow,
                                           const Team& tm) {
  constexpr int P = K / 2;
  const Strips st = strips(oh, tm);
  for (int a = st.r0; a < oh; a += st.dr)
    for (int q = st.q0; q < ow; q += st.dq) {
      float acc[kStrip];
#pragma unroll
      for (int s = 0; s < kStrip; ++s) acc[s] = 0.f;
      if ((a + P) & 1)
        down_t_strip<K, 1>(df, dp, a, q, wk, acc);
      else
        down_t_strip<K, 0>(df, dp, a, q, wk, acc);
      float* d = out + a * op + q;
#pragma unroll
      for (int s = 0; s < kStrip; ++s)
        if (q + s < ow) d[s] += acc[s];
    }
}

// The k*k sums padded to a power of two, at least 32: the length of a team sum.
template <int K>
constexpr int kPad = K * K <= 32 ? 32 : 64;

// out[t] (+)= the sum of acc[t] over the F lanes of this thread's fragment (the lanes
// of its team within one warp), for t < k*k, as a reduce-scatter: each of the log2(F)
// shuffle stages sends half of the values still held and adds the half received, so
// lane l of the fragment ends with the sums of entries [l m, (l + 1) m), m = kPad / F,
// and writes (or with `add`, adds) those; nothing of a team past the last plane.
// One stage of the reduce-scatter: lanes O apart swap halves of the M values held.
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

template <int K, int F>
__device__ __forceinline__ void team_sum_f(const float (&acc)[K * K], bool active, bool add,
                                           float* out) {
  constexpr int KK = K * K, N = kPad<K>;
  float v[N];
#pragma unroll
  for (int t = 0; t < N; ++t) v[t] = t < KK ? acc[t] : 0.f;
  const int lane = threadIdx.x & (F - 1);
  scatter_stage<N, F / 2, N>(v, lane);
  constexpr int M = N / F;
#pragma unroll
  for (int t = 0; t < M; ++t) {
    const int e = lane * M + t;
    if (e < KK) out[e] = (add ? out[e] : 0.f) + (active ? v[t] : 0.f);
  }
}

template <int K>
__device__ __forceinline__ void team_sum(const float (&acc)[K * K], int lanes, bool active,
                                         bool add, float* out) {
  // phase sums
  if (lanes == 8)
    team_sum_f<K, 8>(acc, active, add, out);
  else if (lanes == 16)
    team_sum_f<K, 16>(acc, active, add, out);
  else
    team_sum_f<K, 32>(acc, active, add, out);
  // end sums
}

template <typename T, int K>
__global__ void __launch_bounds__(256, K == 7 ? 2 : 3)  // k <= 5: 85 registers
recconv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                   const float* __restrict__ weights, const int4* __restrict__ fplans,
                   const int2* __restrict__ bplans, float* __restrict__ partial,
                   const Geometry geo, const int N, const int C, const int log2_team) {
  constexpr int KK = K * K, P = K / 2;
  extern __shared__ float smem[];
  __shared__ Geometry G;  // indexed by level at run time: kept in shared memory
  const int nt = 1 << log2_team;
  const Team tm = {(int)threadIdx.x & (nt - 1), nt, (int)threadIdx.x >> log2_team};
  const int per_block = blockDim.x >> log2_team;
  const int lanes = nt < 32 ? nt : 32;  // a fragment: the lanes of a team in one warp
  const int frags = blockDim.x / lanes, frag = threadIdx.x / lanes;
  const int groups = (N + per_block - 1) / per_block;  // groups of n per channel
  const int L = geo.level;
  float* const sm = smem + tm.id * geo.team_words;
  float* const wts = smem + geo.wts;
  float* const slots = smem + geo.slots;
  float* const slot = slots + frag * (L + 2) * KK;
  if (threadIdx.x == 0) G = geo;
  // once per block: the plan tables into shared memory, the halo rings zeroed
  const int4* const fplan = reinterpret_cast<const int4*>(smem + geo.fplan);
  const int2* const bplan = reinterpret_cast<const int2*>(smem + geo.bplan);
  {
    const float* src = reinterpret_cast<const float*>(fplans);
    for (int i = threadIdx.x; i < geo.fplan_words; i += blockDim.x) smem[geo.fplan + i] = src[i];
    src = reinterpret_cast<const float*>(bplans);
    for (int i = threadIdx.x; i < geo.bplan_words; i += blockDim.x) smem[geo.bplan + i] = src[i];
  }
  __syncthreads();
  for (int l = 0; l <= L; ++l) {
    zero_ring<P>(sm + G.f[l], G.h[l], G.w[l], G.pitch[l], tm);
    if (l < L) zero_ring<P>(sm + G.hb[l], G.h[l], G.w[l], G.pitch[l], tm);
    if (l > 0) zero_ring<P>(sm + G.gb[l], G.h[l], G.w[l], G.pitch[l], tm);
  }
  const int h0 = G.h[0], w0 = G.w[0], p0 = G.pitch[0];
  auto F = [&](int l) { return interior<K>(sm, G.f[l], G.pitch[l]); };
  auto H = [&](int l) { return interior<K>(sm, G.hb[l], G.pitch[l]); };
  auto Gb = [&](int l) { return interior<K>(sm, G.gb[l], G.pitch[l]); };
  auto dh = [&](int l) { return l == 0 || l == L ? F(l) : H(l); };  // dh_l, then df_l
  float* const F0 = F(0);
  float* const B0 = H(0);
  // A block walks over items (c, group of per_block consecutive n): its teams take the
  // planes (n, c) of one channel, whose weights the block loads once an item.
  for (int item = blockIdx.x; item < C * groups; item += gridDim.x) {
    const int c = item / groups;
    const int n = (item - c * groups) * per_block + tm.id;
    const bool active = n < N;  // a team past the last plane computes, unused
    const T* const xp = x + ((size_t)(active ? n : N - 1) * C + c) * h0 * w0;
    __syncthreads();  // the previous item's weights and slots are read
    for (int i = threadIdx.x; i < (L + 2) * KK; i += blockDim.x) {
      const int j = i / KK;
      wts[i] = weights[((size_t)j * C + c) * KK + (i - j * KK)];
    }
    __syncthreads();
    // phase load
    copy_plane(F0, p0, xp, w0, h0, w0, tm);
    // end load
    tm.sync();
    // phase pyramid: f_1 .. f_L
    {
      float wk[KK];
      load_weights<K>(wk, wts);
      for (int l = 1; l <= L; ++l) {
        conv<K, 2>(F(l - 1), G.pitch[l - 1], wk, F(l), G.pitch[l], G.h[l], G.w[l], tm);
        tm.sync();
      }
    }
    // end pyramid
    // phase h: the sums h_{L-1} .. h_0, the forward kernel's arithmetic: the level's
    // conv into G[j+1], the lerp along H into G[j] (H[0] at j = 0), the lerp along W
    // and the add into H[j] (F[0], in place, at j = 0)
    for (int j = L - 1; j >= 0; --j) {
      const int hj = G.h[j], wj = G.w[j], pj = G.pitch[j];
      const int hn = G.h[j + 1], wn = G.w[j + 1], pn = G.pitch[j + 1];
      float* const y = Gb(j + 1);
      {
        float wk[KK];
        load_weights<K>(wk, wts + (L - j) * KK);
        conv<K, 1>(j + 1 == L ? F(L) : H(j + 1), pn, wk, y, pn, hn, wn, tm);
      }
      tm.sync();
      float* const tmp = j == 0 ? B0 : Gb(j);
      {
        const int4* rows = fplan + G.frows[j + 1];
        const Walk wk = walk(wn, tm);
        for (int r = wk.r0; r < hj; r += wk.dr) {
          const int4 rp = rows[r];
          const float* t0 = y + rp.x * pn;
          const float* t1 = y + rp.y * pn;
          for (int q = wk.q0; q < wn; q += wk.dq)
            tmp[r * pj + q] = t0[q] + (t1[q] - t0[q]) * __int_as_float(rp.z);
        }
      }
      tm.sync();
      {
        const float* fj = F(j);
        float* hs = j == 0 ? F0 : H(j);
        const int4* cols = fplan + G.fcols[j + 1];
        const Walk wk = walk(wj, tm);
        for (int q = wk.q0; q < wj; q += wk.dq) {
          const int4 cp = cols[q];
          for (int r = wk.r0; r < hj; r += wk.dr) {
            const float* t = tmp + r * pj;
            hs[r * pj + q] =
                fj[r * pj + q] + (t[cp.x] + (t[cp.y] - t[cp.x]) * __int_as_float(cp.z));
          }
        }
      }
      tm.sync();
    }
    // end h
    // phase load
    copy_plane(B0, p0, g + (xp - x), w0, h0, w0, tm);
    // end load
    tm.sync();
    float acc[KK];
    // sweep 1: dW_L = corr(h_0, g); dh_0 = convT(g, W_L), into F[0] (h_0 is spent)
#pragma unroll
    for (int t = 0; t < KK; ++t) acc[t] = 0.f;
    // phase corr
    corr<K, 1>(F0, p0, B0, p0, h0, w0, acc, tm);
    // end corr
    team_sum<K>(acc, lanes, active, false, slot + (L + 1) * KK);
    tm.sync();
    // phase convt
    {
      float wk[KK];
      load_weights<K, true>(wk, wts + (L + 1) * KK);
      conv<K, 1>(B0, p0, wk, F0, p0, h0, w0, tm);
    }
    // end convt
    tm.sync();
    for (int j = 1; j <= L; ++j) {
      const int hp = G.h[j - 1], pp = G.pitch[j - 1];
      const int hj = G.h[j], wj = G.w[j], pj = G.pitch[j];
      const float* src = dh(j - 1);
      // upT along W into an (h_{j-1}, w_j) plane in H[0] (g is spent) at j = 1, else in
      // G[j-1] (dy_{j-1} is spent)
      float* const tw = j == 1 ? B0 : Gb(j - 1);
      // phase upt
      {
        const Walk wk = walk(wj, tm);
        for (int q = wk.q0; q < wj; q += wk.dq) {
          int2 e[kMaxFan];
#pragma unroll
          for (int t = 0; t < kMaxFan; ++t) e[t] = bplan[G.bcols[j] + q * kMaxFan + t];
          for (int r = wk.r0; r < hp; r += wk.dr) {
            const float* row = src + r * pp;
            float v = 0.f;
#pragma unroll
            for (int t = 0; t < kMaxFan; ++t) v = fmaf(__int_as_float(e[t].y), row[e[t].x], v);
            tw[r * pp + q] = v;
          }
        }
      }
      // end upt
      tm.sync();
      // upT along H: dy_j into G[j]
      float* const dy = Gb(j);
      // phase upt
      {
        const Walk wk = walk(wj, tm);
        for (int r = wk.r0; r < hj; r += wk.dr) {
          int2 e[kMaxFan];
#pragma unroll
          for (int t = 0; t < kMaxFan; ++t) e[t] = bplan[G.brows[j] + r * kMaxFan + t];
          for (int q = wk.q0; q < wj; q += wk.dq) {
            float v = 0.f;
#pragma unroll
            for (int t = 0; t < kMaxFan; ++t)
              v = fmaf(__int_as_float(e[t].y), tw[e[t].x * pp + q], v);
            dy[r * pj + q] = v;
          }
        }
      }
      // end upt
      tm.sync();
      // dW_{L-j} = corr(h_j, dy_j); dh_j = convT(dy_j) in h_j's place (h_j is spent)
#pragma unroll
      for (int t = 0; t < KK; ++t) acc[t] = 0.f;
      // phase corr
      corr<K, 1>(j == L ? F(L) : H(j), pj, dy, pj, hj, wj, acc, tm);
      // end corr
      team_sum<K>(acc, lanes, active, false, slot + (1 + L - j) * KK);
      tm.sync();
      // phase convt
      {
        float wk[KK];
        load_weights<K, true>(wk, wts + (1 + L - j) * KK);
        conv<K, 1>(dy, pj, wk, dh(j), pj, hj, wj, tm);
      }
      // end convt
      tm.sync();
    }
    // sweep 2: dW_d += corr_s2(f_{j-1}, df_j); df_{j-1} = dh_{j-1} + DT(df_j), in place;
    // f_0 = x again, into H[0] (the upT scratch is spent)
    // phase load
    copy_plane(B0, p0, xp, w0, h0, w0, tm);
    // end load
    tm.sync();
    // phase sweep2
    {
      float wk[KK];
      load_weights<K>(wk, wts);
      for (int j = L; j >= 1; --j) {
        const int pj = G.pitch[j], pp = G.pitch[j - 1];
        const float* df = dh(j);
#pragma unroll
        for (int t = 0; t < KK; ++t) acc[t] = 0.f;
        corr<K, 2>(j == 1 ? B0 : F(j - 1), pp, df, pj, G.h[j], G.w[j], acc, tm);
        team_sum<K>(acc, lanes, active, j < L, slot);
        down_t_add<K>(df, pj, wk, dh(j - 1), pp, G.h[j - 1], G.w[j - 1], tm);
        tm.sync();
      }
    }
    // end sweep2
    if (active) copy_plane(dx + (xp - x), w0, F0, p0, h0, w0, tm);
    __syncthreads();
    // the item's weight-gradient sums: the fragments' rows added in order
    float* const part = partial + (size_t)item * (L + 2) * KK;
    for (int i = threadIdx.x; i < (L + 2) * KK; i += blockDim.x) {
      float v = 0.f;
      for (int f = 0; f < frags; ++f) v += slots[f * (L + 2) * KK + i];
      part[i] = v;
    }
  }
}

// dw[j][c][t] = sum over the groups of channel c of partial[c][group][j][t], in
// group order: one thread an output.
__global__ void recconv_bwd_sum_kernel(const float* __restrict__ partial,
                                       float* __restrict__ dw, int groups, int C, int J,
                                       int KK) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= J * C * KK) return;
  const int t = i % KK, c = (i / KK) % C, j = i / (KK * C);
  float s = 0.f;
  for (int q = 0; q < groups; ++q) s += partial[(((size_t)c * groups + q) * J + j) * KK + t];
  dw[i] = s;
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* g, void* dx, const float* weights,
                   const int4* fplans, const int2* bplans, float* partial, float* dw,
                   const Geometry& geo, int N, int C, int team, int smem, cudaStream_t s) {
  // all of the SM's shared memory (and the least L1): otherwise the runtime may keep
  // a split that holds fewer blocks than the shared memory would
  cudaError_t e = cudaFuncSetAttribute(recconv_bwd_kernel<T, K>,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(recconv_bwd_kernel<T, K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int log2_team = 0;
  while ((1 << log2_team) < team) ++log2_team;
  const int per_block = kBlockThreads / team;
  const int groups = (N + per_block - 1) / per_block;
  // one wave of resident blocks, each walking over items
  int device = 0, sms = 0, resident = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, recconv_bwd_kernel<T, K>,
                                                         kBlockThreads, smem)) != cudaSuccess)
    return e;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int blocks = std::min(C * groups, sms * resident);
  recconv_bwd_kernel<T, K><<<blocks, kBlockThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx), weights,
      fplans, bplans, partial, geo, N, C, log2_team);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // phase batch_sum
  const int outputs = (geo.level + 2) * C * K * K;
  recconv_bwd_sum_kernel<<<(outputs + 255) / 256, 256, 0, s>>>(partial, dw, groups, C,
                                                               geo.level + 2, K * K);
  // end batch_sum
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(int k, const void* x, const void* g, void* dx, const float* weights,
                     const int4* fplans, const int2* bplans, float* partial, float* dw,
                     const Geometry& geo, int N, int C, int team, int smem,
                     cudaStream_t s) {
  switch (k) {
    case 3: return launch<T, 3>(x, g, dx, weights, fplans, bplans, partial, dw, geo, N, C,
                                team, smem, s);
    case 5: return launch<T, 5>(x, g, dx, weights, fplans, bplans, partial, dw, geo, N, C,
                                team, smem, s);
    case 7: return launch<T, 7>(x, g, dx, weights, fplans, bplans, partial, dw, geo, N, C,
                                team, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

// The backward kernel instantiated for k and the dtype, or null.
const void* kernel_for(int k, int is_bf16) {
  using bf16 = __nv_bfloat16;
  switch (k) {
    case 3: return is_bf16 ? reinterpret_cast<const void*>(recconv_bwd_kernel<bf16, 3>)
                           : reinterpret_cast<const void*>(recconv_bwd_kernel<float, 3>);
    case 5: return is_bf16 ? reinterpret_cast<const void*>(recconv_bwd_kernel<bf16, 5>)
                           : reinterpret_cast<const void*>(recconv_bwd_kernel<float, 5>);
    case 7: return is_bf16 ? reinterpret_cast<const void*>(recconv_bwd_kernel<bf16, 7>)
                           : reinterpret_cast<const void*>(recconv_bwd_kernel<float, 7>);
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// dx, dw = the gradient of RecConv2d at x for g = dL/dy. x, g, dx: contiguous
// N x C x H x W, fp32 (is_bf16 = 0) or bf16; weights: (level + 2) x C x k x k fp32
// (down, conv0 .. conv{level}); fplans: the forward kernel's lerp-plan table; bplans:
// the transposed plan table; partial: C x groups x (level + 2) x k x k fp32 scratch,
// groups = ceil(N / (256 / team)); dw: (level + 2) x C x k x k fp32; team: threads per
// plane, a power of two in 8 .. 256; geometry: `geom_len` ints in the field order of
// Geometry (host memory). Launches on `stream` and returns cudaGetLastError().
int recconv_backward(const void* x, const void* g, void* dx, const void* weights,
                     const void* fplans, const void* bplans, void* partial, void* dw,
                     const int* geometry, int geom_len, int N, int C, int k, int team,
                     int smem, int is_bf16, void* stream) {
  Geometry geo;
  if (geom_len != (int)(sizeof(Geometry) / sizeof(int))) return (int)cudaErrorInvalidValue;
  std::memcpy(&geo, geometry, sizeof(Geometry));
  if (geo.level < 1 || geo.level > kMaxLevel || N <= 0 || C <= 0 ||
      (team & (team - 1)) || team < 8 || team > kBlockThreads || smem <= 0)
    return (int)cudaErrorInvalidValue;
  if ((long long)N * C > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* w = static_cast<const float*>(weights);
  const int4* fp = static_cast<const int4*>(fplans);
  const int2* bp = static_cast<const int2*>(bplans);
  float* part = static_cast<float*>(partial);
  float* out = static_cast<float*>(dw);
  const cudaError_t e =
      is_bf16 ? launch_k<__nv_bfloat16>(k, x, g, dx, w, fp, bp, part, out, geo, N, C,
                                        team, smem, s)
              : launch_k<float>(k, x, g, dx, w, fp, bp, part, out, geo, N, C, team, smem, s);
  return (int)e;
}

// Registers per thread and local (spill and stack) bytes per thread of the backward
// kernel instantiated for k and the dtype.
int recconv_backward_attributes(int k, int is_bf16, int* registers, int* local_bytes) {
  const void* fn = kernel_for(k, is_bf16);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, fn);
  if (e != cudaSuccess) return (int)e;
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

// Blocks of the backward kernel (k, dtype) with `smem` bytes of dynamic shared memory
// that one SM holds at once.
int recconv_backward_resident(int k, int is_bf16, int smem, int* blocks) {
  const void* fn = kernel_for(k, is_bf16);
  if (!fn) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, fn, kBlockThreads, smem);
  return (int)e;
}

const char* recconv_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
