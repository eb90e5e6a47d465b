// Fused RecConv2d pyramid for Hopper (sm_90a): one launch for the whole pyramid.
//
// Replaces the TPU kernel recnext_tpu/ops/pallas/recconv.py:pallas_rec_conv2d and
// computes exactly recnext_tpu/ops/recconv.py:rec_conv2d(mode="bilinear") without
// biases (the M-family token mixer), with fp32 arithmetic inside:
//   1. `level` stride-2 k x k depthwise downsamples with one shared `down` kernel,
//      zero padding k/2, each level of size ceil(prev/2);
//   2. from the coarsest level up: acc = up(conv_l(f_l + acc)), bilinear with
//      align_corners=False to the size recorded before that level's downsample;
//   3. y = conv_level(x + acc).
//
// Design. Every (n, c) plane of an NCHW tensor is independent and contiguous. A
// team of T threads (8 to 256, a power of two; ops/cuda/recconv.py:team_size picks
// it from the plane's area) owns one plane, and a block of 256 threads holds 256/T
// teams on consecutive planes, so its planes are one contiguous span of x and of y.
// The grid is one wave of resident blocks, each walking over such groups of planes:
//   - the span of x arrives in shared memory by cp.async, the next group's while this
//     one is computed; each team converts its plane to fp32 into its level-0 buffer;
//   - the whole pyramid stays in shared memory as fp32, every level buffer with a
//     zero halo of k/2 (the ring is zeroed once per block), so the tap loops have no
//     bounds checks;
//   - each thread computes a strip of kStrip outputs along a row: the conv's k*k
//     weights sit in registers, and each tap row's window slides through registers,
//     (kStrip + k - 1) shared loads for kStrip * k multiply-adds. Consecutive lanes
//     take consecutive rows, and every row pitch is odd, so one load's 32 lanes hit
//     32 banks (teams within one warp are spaced by an odd multiple of T words);
//   - y is written once in the input dtype: straight from the strips as 4- to
//     16-byte vectors where W is even, else staged and written as 16-byte vectors.
// Device memory sees x read once and y written once. The host lays out shared
// memory (ops/cuda/recconv.py:launch_config, passed as `Geometry`) and packs the
// bilinear lerp plans into one table (ops/cuda/recconv.py:lerp_plan_table), which
// each block copies into shared memory.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at recnext_m1's stage 0 (256 x 48 x 56 x 56, level 4, bf16) the kernel must
// move ~154 MB (x in, y out) and do ~1.6 G fp32 multiply-adds (3.2 GFLOP), so the
// memory bound (~46 us) and the fp32 bound (~48 us) are nearly equal; at the smaller planes of
// stages 1-3 the operations bound. There is no matrix product to put on the tensor
// cores. The ceiling in practice is the rate of shared-memory instructions (one
// warp-wide load per clock per SM against four warp-wide multiply-adds) and the
// per-stage cost of small levels, where few lanes have work: the strips and the
// small teams are aimed at those.
//
// Planes whose pyramid does not fit in one block's shared memory (m1's stage 0 at a
// 640^2 input, COCO-sized inputs) unroll their outer levels (ops/recconv.py:
// rec_conv2d_peeled); each unrolled level runs through recconv_level_bwd.cu's
// recconv_level_kernel, beside the peeled level's backward kernels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstring>

namespace {

constexpr int kMaxLevel = 4;
constexpr int kLevels = kMaxLevel + 1;

struct Weights {
  const void* w[kMaxLevel + 2];  // down, convs[0] .. convs[level]
  // w[j] for a j known only at run time, without an indexed (local-memory) copy
  __device__ __forceinline__ const void* at(int j) const {
    const void* p = w[0];
#pragma unroll
    for (int i = 1; i < kMaxLevel + 2; ++i) p = j == i ? w[i] : p;
    return p;
  }
};

// One team's shared-memory layout, in 4-byte words, as ops/cuda/recconv.py:
// launch_config builds it (the field order is the Python tuple's).
struct Geometry {
  int level;
  int h[kLevels], w[kLevels];  // level sizes; [0] is the input plane
  int pitch[kLevels];          // row pitch of each padded level buffer
  int buf[kLevels];            // offset of each padded level buffer
  int rows[kLevels];           // plan-table row of the row plan of up-step l -> l-1
  int cols[kLevels];           // ... and of its column plan
  int tmp, tmp_pitch;          // conv output at one level (<= level 1)
  int out, out_pitch;          // the output plane in fp32
  int wts;                     // (level + 2) convs' fp32 weights, kTaps4 words each
  int team_words;              // words of one team
  // block-wide, after the teams: the 16-byte chunks of the next span of x, the span
  // of y in its dtype, and a copy of the lerp-plan table (plan_rows int4 rows)
  int xraw, yraw, plan, plan_rows;
};

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}

// A 2-D walk over an oh x ow grid by nt threads: a power-of-two number of threads
// along a row (the least that covers ow, at most nt), the rest down the rows.
struct Walk {
  int q0, dq, r0, dr;
};
__device__ __forceinline__ Walk walk(int ow, int tid, int nt) {
  int lg = 0;
  while ((1 << lg) < ow && (2 << lg) <= nt) ++lg;
  return {tid & ((1 << lg) - 1), 1 << lg, tid >> lg, nt >> lg};
}

__device__ __forceinline__ void put(float* p, int i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, int i, float v) {
  p[i] = __float2bfloat16(v);
}

// dst[r * dpitch + q] = src[r * spitch + q] for an h x w plane, converted to dst's
// type. Consecutive threads take consecutive columns; each takes four rows at a time
// and loads all four before it stores.
template <typename D, typename S>
__device__ __forceinline__ void copy_plane(D* dst, int dpitch, const S* src, int spitch,
                                           int h, int w, int tid, int nt) {
  const Walk wk = walk(w, tid, nt);
  for (int q = wk.q0; q < w; q += wk.dq)
    for (int r = wk.r0; r < h; r += 4 * wk.dr) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v[u] = load_f32(src, min(r + u * wk.dr, h - 1) * spitch + q);
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r + u * wk.dr < h) put(dst, (r + u * wk.dr) * dpitch + q, v[u]);
    }
}

// Zero the k/2 ring around an h x w interior of a buffer with row pitch `pitch`
// (the columns right of the ring, which only dropped outputs read, too).
template <int P>
__device__ void zero_ring(float* b, int h, int w, int pitch, int tid, int nt) {
  const Walk top = walk(pitch, tid, nt);
  for (int r = top.r0; r < 2 * P; r += top.dr)
    for (int q = top.q0; q < pitch; q += top.dq)
      b[(r < P ? r : h + r) * pitch + q] = 0.f;
  const int side = pitch - w;  // P on the left, the rest on the right
  const Walk mid = walk(side, tid, nt);
  for (int r = mid.r0; r < h; r += mid.dr)
    for (int q = mid.q0; q < side; q += mid.dq)
      b[(r + P) * pitch + (q < P ? q : w + q)] = 0.f;
}

// Each conv's k*k weights take kTaps4<K> words in shared memory: 16-byte loads.
template <int K>
constexpr int kTaps4 = (K * K + 3) / 4 * 4;

template <int K>
__device__ __forceinline__ void load_weights(float (&wk)[K * K], const float* src) {
  const float4* src4 = reinterpret_cast<const float4*>(src);
#pragma unroll
  for (int i = 0; i < kTaps4<K> / 4; ++i) {
    const float4 v = src4[i];
    const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * i + j < K * K) wk[4 * i + j] = e[j];
  }
}

// Outputs one thread computes along a row (ops/cuda/recconv.py: STRIP).
constexpr int kStrip = 4;

// A walk over the strips of an oh x ow grid by nt threads: consecutive threads take
// consecutive rows (a power of two of them, the least that covers oh, at most a
// warp or nt), so with an odd row pitch one tap's loads fall in distinct banks; the
// rest take strips further along the rows.
struct Strips {
  int r0, dr, q0, dq;
};
__device__ __forceinline__ Strips strips(int oh, int tid, int nt) {
  int lg = 0;
  while ((1 << lg) < oh && lg < 5 && (2 << lg) <= nt) ++lg;
  return {tid & ((1 << lg) - 1), 1 << lg, (tid >> lg) * kStrip, (nt >> lg) * kStrip};
}

// kStrip outputs of a k x k conv of the given stride along one row. `src` is the
// top-left of the first output's window in a padded buffer of row pitch `pitch`.
// Each tap row slides through registers: stride * (kStrip - 1) + k loads feed
// kStrip * k multiply-adds.
template <int K, int STRIDE>
__device__ __forceinline__ void conv_strip(const float* src, int pitch,
                                           const float (&wk)[K * K], float (&acc)[kStrip]) {
  constexpr int kWin = STRIDE * (kStrip - 1) + K;
#pragma unroll
  for (int s = 0; s < kStrip; ++s) acc[s] = 0.f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy) {
    float win[kWin];
#pragma unroll
    for (int j = 0; j < kWin; ++j) win[j] = src[dy * pitch + j];
#pragma unroll
    for (int s = 0; s < kStrip; ++s)
#pragma unroll
      for (int dx = 0; dx < K; ++dx)
        acc[s] = fmaf(win[STRIDE * s + dx], wk[dy * K + dx], acc[s]);
  }
}

// A strip's outputs a[0..3] to columns q..q+3 of a row of y that starts at an even
// element of 16-byte-aligned y, in a row of even width w: one vector when w is a
// multiple of 4 (the strip is whole and 4-element aligned), else two pairs, the
// second only when it lies inside the row.
static_assert(kStrip == 4, "store_row writes one strip");
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store4(float* p, const float (&a)[kStrip]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&a)[kStrip]) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(a[0], a[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a[2], a[3]);
  *reinterpret_cast<uint2*>(p) = make_uint2(*reinterpret_cast<const unsigned*>(&lo),
                                            *reinterpret_cast<const unsigned*>(&hi));
}
template <typename T>
__device__ __forceinline__ void store_row(T* row, int q, int w, const float (&a)[kStrip]) {
  if (w % kStrip == 0) {
    store4(row + q, a);
  } else {
    store2(row + q, a[0], a[1]);
    if (q + 2 < w) store2(row + q + 2, a[2], a[3]);
  }
}

// dst[r * pitch + q0 + s] = acc[s] for the outputs left of column ow
__device__ __forceinline__ void store_strip(float* dst, int q0, int ow,
                                            const float (&acc)[kStrip]) {
#pragma unroll
  for (int s = 0; s < kStrip; ++s)
    if (q0 + s < ow) dst[q0 + s] = acc[s];
}

// cp.async: 16 bytes from device memory to shared memory, not waited for here
__device__ __forceinline__ void copy_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void copy_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying the 16-byte chunks that cover `span` elements at p into shared
// memory at raw (the chunk that holds p's first byte lands at raw).
template <typename T>
__device__ __forceinline__ void fetch_span(char* raw, const T* p, int span) {
  const char* lo = reinterpret_cast<const char*>(reinterpret_cast<size_t>(p) & ~size_t(15));
  const int chunks = (int)((reinterpret_cast<const char*>(p + span) - lo + 15) >> 4);
  for (int i = threadIdx.x; i < chunks; i += blockDim.x) copy_async16(raw + 16 * i, lo + 16 * i);
  copy_async_commit();
}

template <typename T, int K>
__global__ void __launch_bounds__(256, K == 7 ? 3 : 4)  // 64 (80) registers, no spills
recconv_kernel(const T* __restrict__ x, T* __restrict__ y, Weights wp,
               const int4* __restrict__ plans, const Geometry g, int planes, int C,
               int log2_team) {
  extern __shared__ float smem[];
  constexpr int P = K / 2;
  const int level = g.level;
  const int nt = 1 << log2_team;  // threads of one team, which owns one plane
  const int team = threadIdx.x >> log2_team, tid = threadIdx.x & (nt - 1);
  const int per_block = blockDim.x >> log2_team;
  const int groups = (planes + per_block - 1) / per_block;
  const int H = g.h[0], W = g.w[0], HW = H * W;
  float* s = smem + team * g.team_words;
  float* wts = s + g.wts;
  char* xraw = reinterpret_cast<char*>(smem + g.xraw);
  char* yraw = reinterpret_cast<char*>(smem + g.yraw);
  auto team_sync = [nt] {  // a team of at most 32 threads lies within one warp
    if (nt <= 32) __syncwarp(); else __syncthreads();
  };

  // The block walks over groups of per_block consecutive planes (one per team): one
  // contiguous span of x and of y each. The halo rings stay zero throughout.
  const int first = blockIdx.x, stride = gridDim.x;
  int4* splan = reinterpret_cast<int4*>(smem + g.plan);
  for (int i = threadIdx.x; i < g.plan_rows; i += blockDim.x) splan[i] = __ldg(plans + i);
  if (first < groups)
    fetch_span(xraw, x + (size_t)first * per_block * HW,
               min(per_block, planes - first * per_block) * HW);
  for (int l = 0; l <= level; ++l)
    zero_ring<P>(s + g.buf[l], g.h[l], g.w[l], g.pitch[l], tid, nt);
  for (int grp = first; grp < groups; grp += stride) {
    const int plane0 = grp * per_block;
    const int span = min(per_block, planes - plane0) * HW;
    const size_t base = (size_t)plane0 * HW;
    const int c = (plane0 + team) % C;  // a team past the last plane computes unused
    // the channel's weights, four loads in flight per thread
    for (int i = tid; i < (level + 2) * K * K; i += 4 * nt) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = min(i + u * nt, (level + 2) * K * K - 1), j = e / (K * K);
        v[u] = load_f32(static_cast<const T*>(wp.at(j)), (size_t)c * K * K + e - j * K * K);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = i + u * nt, j = e / (K * K);
        if (e < (level + 2) * K * K) wts[j * kTaps4<K> + e - j * K * K] = v[u];
      }
    }
    copy_async_wait();
    __syncthreads();
    // this team's plane from the fetched chunks into the level-0 interior
    {
      const T* xs = reinterpret_cast<const T*>(
          xraw + (reinterpret_cast<size_t>(x + base) & 15)) + team * HW;
      float* b0 = s + g.buf[0] + P * g.pitch[0] + P;
      if (team * HW < span) copy_plane(b0, g.pitch[0], xs, W, H, W, tid, nt);
    }
    __syncthreads();
    // the next group's span is fetched while this one is computed
    if (grp + stride < groups) {
      const int next = (grp + stride) * per_block;
      fetch_span(xraw, x + (size_t)next * HW, min(per_block, planes - next) * HW);
    }

    // 1. downsample pyramid: f_l = down(f_{l-1}), stride 2
    {
      float wk[K * K], acc[kStrip];
      load_weights<K>(wk, wts);
      for (int l = 1; l <= level; ++l) {
        const float* src = s + g.buf[l - 1];
        const int spitch = g.pitch[l - 1], dpitch = g.pitch[l];
        float* dst = s + g.buf[l] + P * dpitch + P;
        const Strips st = strips(g.h[l], tid, nt);
        for (int r = st.r0; r < g.h[l]; r += st.dr)
          for (int q = st.q0; q < g.w[l]; q += st.dq) {
            conv_strip<K, 2>(src + 2 * r * spitch + 2 * q, spitch, wk, acc);
            store_strip(dst + r * dpitch, q, g.w[l], acc);
          }
        team_sync();
      }
    }

    // 2. walk back up: tmp = conv_l(f_l + acc); f_{l-1} += up(tmp)
    float* tmp = s + g.tmp;
    const int tp = g.tmp_pitch;
    for (int l = level; l >= 1; --l) {
      {
        float wk[K * K], acc[kStrip];
        load_weights<K>(wk, wts + (1 + level - l) * kTaps4<K>);  // convs[level - l]
        const float* src = s + g.buf[l];
        const int spitch = g.pitch[l];
        const Strips st = strips(g.h[l], tid, nt);
        for (int r = st.r0; r < g.h[l]; r += st.dr)
          for (int q = st.q0; q < g.w[l]; q += st.dq) {
            conv_strip<K, 1>(src + r * spitch + q, spitch, wk, acc);
            store_strip(tmp + r * tp, q, g.w[l], acc);
          }
      }
      team_sync();

      const int4* rows = splan + g.rows[l];  // (idx0, idx1, w1, 0) per output row
      const int4* cols = splan + g.cols[l];  // ... and per output column
      const int dpitch = g.pitch[l - 1], ow = g.w[l - 1];
      float* dst = s + g.buf[l - 1] + P * dpitch + P;
      const Strips st = strips(g.h[l - 1], tid, nt);
      for (int r = st.r0; r < g.h[l - 1]; r += st.dr) {
        const int4 rp = rows[r];
        const float* t0 = tmp + rp.x * tp;
        const float* t1 = tmp + rp.y * tp;
        const float wr = __int_as_float(rp.z);
        for (int q0 = st.q0; q0 < ow; q0 += st.dq) {
          float up[kStrip];
#pragma unroll
          for (int j = 0; j < kStrip; ++j) {
            const int4 cp = cols[min(q0 + j, ow - 1)];  // past the edge: computed, dropped
            // along H first, then along W, as resize_bilinear does
            const float left = t0[cp.x] + (t1[cp.x] - t0[cp.x]) * wr;
            const float right = t0[cp.y] + (t1[cp.y] - t0[cp.y]) * wr;
            up[j] = left + (right - left) * __int_as_float(cp.z);
          }
          float* d = dst + r * dpitch + q0;
          float was[kStrip];
#pragma unroll
          for (int j = 0; j < kStrip; ++j) was[j] = d[j];  // the pitch covers the strip
#pragma unroll
          for (int j = 0; j < kStrip; ++j)
            if (q0 + j < ow) d[j] = was[j] + up[j];
        }
      }
      team_sync();
    }

    // 3. y = conv_level(x + acc). Where W is even (g.out_pitch == 0), each strip goes
    // straight to y in vector stores; else into the team's staging rows.
    const bool direct = g.out_pitch == 0;
    {
      float wk[K * K], acc[kStrip];
      load_weights<K>(wk, wts + (1 + level) * kTaps4<K>);
      const float* src = s + g.buf[0];
      const int pitch = g.pitch[0];
      float* out = s + g.out;
      T* yp = y + base + (size_t)team * HW;
      const bool active = team * HW < span;
      const Strips st = strips(H, tid, nt);
      for (int r = st.r0; r < H; r += st.dr)
        for (int q = st.q0; q < W; q += st.dq) {
          conv_strip<K, 1>(src + r * pitch + q, pitch, wk, acc);
          if (!direct)
            store_strip(out + r * g.out_pitch, q, W, acc);
          else if (active)
            store_row(yp + r * W, q, W, acc);
        }
    }
    __syncthreads();
    if (direct) continue;

    // 4. (odd W) y: each team's plane in the input dtype into the staged span, then
    // the span written once: 16-byte vectors, scalars at its ragged ends
    const int yoff = (int)(reinterpret_cast<size_t>(y + base) & 15);
    {
      T* ys = reinterpret_cast<T*>(yraw + yoff) + team * HW;
      const float* out = s + g.out;
      if (team * HW < span) copy_plane(ys, W, out, g.out_pitch, H, W, tid, nt);
    }
    __syncthreads();
    {
      constexpr int V = 16 / sizeof(T);
      const int head = min(span, ((16 - yoff) & 15) / (int)sizeof(T));
      const int vecs = (span - head) / V, tail = head + vecs * V;
      const T* ys = reinterpret_cast<const T*>(yraw + yoff);
      for (int e = threadIdx.x; e < head; e += blockDim.x) y[base + e] = ys[e];
      for (int e = tail + threadIdx.x; e < span; e += blockDim.x) y[base + e] = ys[e];
      for (int v = threadIdx.x; v < vecs; v += blockDim.x)
        reinterpret_cast<uint4*>(y + base + head)[v] = reinterpret_cast<const uint4*>(ys + head)[v];
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, void* y, const Weights& wp, const int4* plans,
                   const Geometry& g, int planes, int C, int team, int per_block,
                   int smem, cudaStream_t stream) {
  // all of the SM's shared memory (and the least L1): otherwise the runtime may keep
  // a split that holds fewer blocks than the shared memory would
  cudaError_t e = cudaFuncSetAttribute(recconv_kernel<T, K>,
                                       cudaFuncAttributePreferredSharedMemoryCarveout,
                                       cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(recconv_kernel<T, K>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  int log2_team = 0;
  while ((1 << log2_team) < team) ++log2_team;
  // one wave of resident blocks, each walking over groups of planes
  int device = 0, sms = 0, resident = 0;
  if ((e = cudaGetDevice(&device)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, recconv_kernel<T, K>,
                                                         team * per_block, smem)) != cudaSuccess)
    return e;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const int blocks = std::min((planes + per_block - 1) / per_block, sms * resident);
  recconv_kernel<T, K><<<blocks, team * per_block, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), wp, plans, g, planes, C, log2_team);
  return cudaGetLastError();
}

template <typename T, int K>
cudaError_t attributes(cudaFuncAttributes* a) {
  return cudaFuncGetAttributes(a, reinterpret_cast<const void*>(recconv_kernel<T, K>));
}

template <typename T>
cudaError_t launch_k(const void* x, void* y, const Weights& wp, const int4* plans,
                     const Geometry& g, int planes, int C, int k, int team, int per_block,
                     int smem, cudaStream_t stream) {
  switch (k) {
    case 3: return launch<T, 3>(x, y, wp, plans, g, planes, C, team, per_block, smem,
                                       stream);
    case 5: return launch<T, 5>(x, y, wp, plans, g, planes, C, team, per_block, smem,
                                       stream);
    case 7: return launch<T, 7>(x, y, wp, plans, g, planes, C, team, per_block, smem,
                                       stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// y = RecConv2d(x). x, y: contiguous N x C x H x W, fp32 (is_bf16 = 0) or bf16;
// down, conv0..conv{level}: contiguous C x 1 x k x k in the same dtype (unused conv
// pointers may be null); plans: the device lerp-plan table; geometry: `geom_len`
// ints in the field order of Geometry (host memory). `planes` = N * C. Launches on
// `stream` and returns cudaGetLastError().
int recconv_forward(const void* x, void* y, const void* down, const void* conv0,
                    const void* conv1, const void* conv2, const void* conv3,
                    const void* conv4, const void* plans, const int* geometry,
                    int geom_len, int planes, int C, int k, int team,
                    int planes_per_block, int smem, int is_bf16, void* stream) {
  Geometry g;
  if (geom_len != (int)(sizeof(Geometry) / sizeof(int))) return (int)cudaErrorInvalidValue;
  std::memcpy(&g, geometry, sizeof(Geometry));
  if (g.out_pitch == 0 && (reinterpret_cast<size_t>(y) & 15))  // y takes vector stores
    return (int)cudaErrorMisalignedAddress;
  if (g.level < 1 || g.level > kMaxLevel || planes <= 0 || C <= 0 ||
      (team & (team - 1)) || team < 8 || team > 256 || planes_per_block < 1 ||
      team * planes_per_block > 256)
    return (int)cudaErrorInvalidValue;
  const Weights wp = {{down, conv0, conv1, conv2, conv3, conv4}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int4* pl = static_cast<const int4*>(plans);
  const cudaError_t e =
      is_bf16 ? launch_k<__nv_bfloat16>(x, y, wp, pl, g, planes, C, k, team,
                                        planes_per_block, smem, s)
              : launch_k<float>(x, y, wp, pl, g, planes, C, k, team, planes_per_block, smem, s);
  return (int)e;
}

// Registers per thread and local (spill and stack) bytes per thread of the kernel
// instantiated for k and the dtype.
int recconv_kernel_attributes(int k, int is_bf16, int* registers, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaErrorInvalidValue;
  switch (k * 2 + (is_bf16 ? 1 : 0)) {
    case 6: e = attributes<float, 3>(&a); break;
    case 7: e = attributes<__nv_bfloat16, 3>(&a); break;
    case 10: e = attributes<float, 5>(&a); break;
    case 11: e = attributes<__nv_bfloat16, 5>(&a); break;
    case 14: e = attributes<float, 7>(&a); break;
    case 15: e = attributes<__nv_bfloat16, 7>(&a); break;
  }
  if (e != cudaSuccess) return (int)e;
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

const char* recconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
