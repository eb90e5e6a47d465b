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
// Design: one block per (n, c) plane, all in fp32 shared memory. The block recomputes
// the pyramid f and the sums h from x (so the forward saves only x and the weights),
// then keeps the gradient pyramid beside them: three fp32 pyramids with zero halos of
// k/2 and one level-1 scratch plane (ops/cuda/recconv_bwd.py:launch_config lays them
// out and passes the offsets as `Geometry`). Every adjoint is a gather, so the kernel
// uses no atomics and gives the same bits on every run:
//   - convT and DT read the halo-padded gradient at the taps that reach an output;
//     DT keeps the taps u with (i + k/2 - u) even and reads (i + k/2 - u) / 2;
//   - upT reads, for each coarse index, the fine indices and weights that read it
//     (at most 4 per axis), from a transposed plan table built on the host from the
//     same per-axis plans as the forward kernel's (columns, then rows);
//   - each weight gradient is a sum over the plane: each thread keeps k*k partial sums
//     in registers over a fixed set of pixels, then a fixed tree of warp shuffles and
//     one row per warp in shared memory add them.
// The block writes its (L+2) k*k weight-gradient partials in fp32 to an
// (N*C, L+2, k, k) buffer; recconv_bwd_sum_kernel adds them over N in a fixed order.
// x and g are f32 or bf16 (one type); dx is written in that type; the weights are read
// as fp32 and the weight gradients are fp32.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): the function must read x and g and write dx, and do about three times the
// forward's fp32 operations (the recomputed forward, convT and corr at every level, and
// DT with corr_s2 at every downsample), so at m1's shapes the fp32 operations bound it,
// as they bound the forward kernel. The design does nothing yet about the rate of
// shared-memory loads (k*k loads per output of each conv and corr, one warp-wide load
// per clock per SM), nor about the few lanes busy at the coarse levels, nor about the
// occupancy that ~68 KB a block (m1's 56^2 plane) allows: it is the simple and right
// first form. Planes whose backward does not fit in one block's shared memory are
// refused by the host before any launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstring>

namespace {

constexpr int kMaxLevel = 4;
constexpr int kLevels = kMaxLevel + 1;
constexpr int kMaxFan = 4;  // fine indices that read one coarse index, per axis

// The block's shared-memory layout, in 4-byte words, as ops/cuda/recconv_bwd.py:
// launch_config builds it (the field order is the Python tuple's). Buffers are haloed:
// interior (r, c) of a level-l buffer at base + (r + k/2) * pitch[l] + c + k/2.
struct Geometry {
  int level;
  int h[kLevels];
  int w[kLevels];
  int pitch[kLevels];
  int f[kLevels];      // F[l]: the pyramid f_l (f_0 = x)
  int hb[kLevels];     // H[l], l < level: h_l (then dh_0 and df_0 in H[0])
  int gb[kLevels];     // G[l]: dh_l, then df_l
  int frows[kLevels];  // forward lerp table (int4 rows): up-step l -> l-1, row plan
  int fcols[kLevels];  // ... and column plan
  int brows[kLevels];  // transposed table (int2 entries): up-step l's row plan
  int bcols[kLevels];  // ... and column plan
  int s1;              // dy scratch, level 1's haloed size
  int wts;             // (level + 2) k*k weights: down, conv0 .. conv{level}
  int red;             // one k*k row per warp for the block sums
  int zero_words;      // F, H, G and the scratch: zeroed first
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int K>
__device__ __forceinline__ float* interior(float* sm, int base, int pitch) {
  return sm + base + (K / 2) * pitch + K / 2;
}

__device__ __forceinline__ void zero(float* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0.f;
}

// out(r, c) = sum_{u,v} w[u][v] in(S r + u - k/2, S c + v - k/2): in haloed (interior
// pointer), out at out[r * op + c].
template <int K, int S>
__device__ __forceinline__ void conv(const float* in, int ip, const float* w, float* out,
                                     int op, int oh, int ow) {
  constexpr int P = K / 2;
  for (int i = threadIdx.x; i < oh * ow; i += blockDim.x) {
    const int r = i / ow, c = i - r * ow;
    const float* s = in + (S * r - P) * ip + S * c - P;
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < K; ++u)
#pragma unroll
      for (int v = 0; v < K; ++v) acc = fmaf(w[u * K + v], s[u * ip + v], acc);
    out[r * op + c] = acc;
  }
}

// out(a, b) = sum_{u,v} w[u][v] dy(a - u + k/2, b - v + k/2): the adjoint of the
// stride-1 conv, dy haloed.
template <int K>
__device__ __forceinline__ void conv_t(const float* dy, int dp, const float* w, float* out,
                                       int op, int oh, int ow) {
  constexpr int P = K / 2;
  for (int i = threadIdx.x; i < oh * ow; i += blockDim.x) {
    const int a = i / ow, b = i - a * ow;
    const float* s = dy + (a + P) * dp + b + P;
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < K; ++u)
#pragma unroll
      for (int v = 0; v < K; ++v) acc = fmaf(w[u * K + v], s[-u * dp - v], acc);
    out[a * op + b] = acc;
  }
}

// acc[u][v] += sum_{r,c} dy(r, c) in(S r + u - k/2, S c + v - k/2) over this thread's
// pixels: the weight gradient of a stride-S conv, in haloed.
template <int K, int S>
__device__ __forceinline__ void corr(const float* in, int ip, const float* dy, int dp,
                                     int oh, int ow, float (&acc)[K * K]) {
  constexpr int P = K / 2;
  for (int i = threadIdx.x; i < oh * ow; i += blockDim.x) {
    const int r = i / ow, c = i - r * ow;
    const float d = dy[r * dp + c];
    const float* s = in + (S * r - P) * ip + S * c - P;
#pragma unroll
    for (int u = 0; u < K; ++u)
#pragma unroll
      for (int v = 0; v < K; ++v) acc[u * K + v] = fmaf(d, s[u * ip + v], acc[u * K + v]);
  }
}

// out(a, b) += sum w[u][v] df((a + k/2 - u) / 2, (b + k/2 - v) / 2) over the taps whose
// (a + k/2 - u) and (b + k/2 - v) are even: the adjoint of the stride-2 conv, df haloed
// (the taps reach at most k/2 past its edge).
template <int K>
__device__ __forceinline__ void down_t_add(const float* df, int dp, const float* w,
                                           float* out, int op, int oh, int ow) {
  constexpr int P = K / 2;
  for (int i = threadIdx.x; i < oh * ow; i += blockDim.x) {
    const int a = i / ow, b = i - a * ow;
    const int pu = (a + P) & 1, pv = (b + P) & 1;
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < K; ++u) {
      if ((u & 1) != pu) continue;
      const float* row = df + ((a + P - u) / 2) * dp;
#pragma unroll
      for (int v = 0; v < K; ++v) {
        if ((v & 1) != pv) continue;
        acc = fmaf(w[u * K + v], row[(b + P - v) / 2], acc);
      }
    }
    out[a * op + b] += acc;
  }
}

// out[t] = the block's sum of acc[t], for t < k*k: warp shuffles, then one row per warp
// in shared memory, added in warp order by the first k*k threads.
template <int K>
__device__ __forceinline__ void block_sum(float (&acc)[K * K], float* red, float* out) {
  constexpr int KK = K * K;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int t = 0; t < KK; ++t) {
    float v = acc[t];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp * KK + t] = v;
  }
  __syncthreads();
  if (threadIdx.x < KK) {
    float s = 0.f;
    for (int wi = 0; wi < warps; ++wi) s += red[wi * KK + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

template <typename T, int K>
__global__ void __launch_bounds__(256)
recconv_bwd_kernel(const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
                   const float* __restrict__ weights, const int4* __restrict__ fplans,
                   const int2* __restrict__ bplans, float* __restrict__ partial,
                   const Geometry geo, const int C) {
  constexpr int KK = K * K;
  extern __shared__ float sm[];
  __shared__ Geometry G;  // indexed by level at run time: kept in shared memory
  const size_t plane = blockIdx.x;
  const int c = (int)(plane % C);
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) G = geo;
  const int L = geo.level;
  zero(sm, geo.zero_words);
  float* wts = sm + geo.wts;
  for (int i = tid; i < (L + 2) * KK; i += nt) {
    const int j = i / KK;
    wts[i] = weights[((size_t)j * C + c) * KK + (i - j * KK)];
  }
  __syncthreads();
  const int h0 = G.h[0], w0 = G.w[0], p0 = G.pitch[0];
  float* const H0 = interior<K>(sm, G.hb[0], p0);
  float* const G0 = interior<K>(sm, G.gb[0], p0);
  {
    float* f0 = interior<K>(sm, G.f[0], p0);
    const T* xp = x + plane * h0 * w0;
    for (int i = tid; i < h0 * w0; i += nt) {
      const int r = i / w0;
      f0[r * p0 + i - r * w0] = to_f32(xp[i]);
    }
  }
  __syncthreads();
  // the pyramid f_1 .. f_L
  for (int l = 1; l <= L; ++l) {
    conv<K, 2>(interior<K>(sm, G.f[l - 1], G.pitch[l - 1]), G.pitch[l - 1], wts,
               interior<K>(sm, G.f[l], G.pitch[l]), G.pitch[l], G.h[l], G.w[l]);
    __syncthreads();
  }
  // the sums h_{L-1} .. h_0, the forward kernel's arithmetic: the level's conv into a
  // dense plane (in G[j+1]), the lerp along H (into G[j]), the lerp along W and the add
  for (int j = L - 1; j >= 0; --j) {
    const int hj = G.h[j], wj = G.w[j], pj = G.pitch[j];
    const int hn = G.h[j + 1], wn = G.w[j + 1], pn = G.pitch[j + 1];
    const float* src = interior<K>(sm, j + 1 == L ? G.f[L] : G.hb[j + 1], pn);
    float* y = sm + G.gb[j + 1];
    conv<K, 1>(src, pn, wts + (L - j) * KK, y, wn, hn, wn);
    __syncthreads();
    float* tmp = sm + G.gb[j];
    for (int i = tid; i < hj * wn; i += nt) {
      const int r = i / wn, q = i - r * wn;
      const int4 rp = __ldg(fplans + G.frows[j + 1] + r);
      const float t0 = y[rp.x * wn + q], t1 = y[rp.y * wn + q];
      tmp[i] = t0 + (t1 - t0) * __int_as_float(rp.z);
    }
    __syncthreads();
    const float* fj = interior<K>(sm, G.f[j], pj);
    float* hs = interior<K>(sm, G.hb[j], pj);
    for (int i = tid; i < hj * wj; i += nt) {
      const int r = i / wj, q = i - r * wj;
      const int4 cp = __ldg(fplans + G.fcols[j + 1] + q);
      const float* t = tmp + r * wn;
      hs[r * pj + q] = fj[r * pj + q] + (t[cp.x] + (t[cp.y] - t[cp.x]) * __int_as_float(cp.z));
    }
    __syncthreads();
  }
  // the gradient pyramid starts at zero (halos included); g into G[0]
  zero(sm + G.gb[0], G.s1 - G.gb[0]);
  __syncthreads();
  {
    const T* gp = g + plane * h0 * w0;
    for (int i = tid; i < h0 * w0; i += nt) {
      const int r = i / w0;
      G0[r * p0 + i - r * w0] = to_f32(gp[i]);
    }
  }
  __syncthreads();
  float* const red = sm + G.red;
  float* const part = partial + plane * (L + 2) * KK;
  float acc[KK];
  // sweep 1: dW_L = corr(h_0, g); dh_0 = convT(g, W_L), into H[0] (h_0 is spent)
#pragma unroll
  for (int t = 0; t < KK; ++t) acc[t] = 0.f;
  corr<K, 1>(H0, p0, G0, p0, h0, w0, acc);
  block_sum<K>(acc, red, part + (L + 1) * KK);
  conv_t<K>(G0, p0, wts + (L + 1) * KK, H0, p0, h0, w0);
  __syncthreads();
  for (int j = 1; j <= L; ++j) {
    const int hp = G.h[j - 1], hj = G.h[j], wj = G.w[j], pj = G.pitch[j];
    // dh_{j-1}: in H[0] at j = 1, else in G[j-1]
    const float* src = j == 1 ? H0 : interior<K>(sm, G.gb[j - 1], G.pitch[j - 1]);
    const int sp = G.pitch[j - 1];
    // upT along W into a dense (h_{j-1}, w_j) plane: in G[0] (g is spent) at j = 1,
    // else in H[j-1] (h_{j-1} is spent)
    float* tw = sm + (j == 1 ? G.gb[0] : G.hb[j - 1]);
    for (int i = tid; i < hp * wj; i += nt) {
      const int r = i / wj, q = i - r * wj;
      const int2* e = bplans + G.bcols[j] + q * kMaxFan;
      const float* row = src + r * sp;
      float v = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxFan; ++t) {
        const int2 ent = __ldg(e + t);
        v = fmaf(__int_as_float(ent.y), row[ent.x], v);
      }
      tw[i] = v;
    }
    zero(sm + G.s1, G.wts - G.s1);
    __syncthreads();
    // upT along H: dy_j, haloed in the scratch plane
    float* dy = interior<K>(sm, G.s1, pj);
    for (int i = tid; i < hj * wj; i += nt) {
      const int r = i / wj, q = i - r * wj;
      const int2* e = bplans + G.brows[j] + r * kMaxFan;
      float v = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxFan; ++t) {
        const int2 ent = __ldg(e + t);
        v = fmaf(__int_as_float(ent.y), tw[ent.x * wj + q], v);
      }
      dy[r * pj + q] = v;
    }
    __syncthreads();
    const float* hsj = interior<K>(sm, j == L ? G.f[L] : G.hb[j], pj);
#pragma unroll
    for (int t = 0; t < KK; ++t) acc[t] = 0.f;
    corr<K, 1>(hsj, pj, dy, pj, hj, wj, acc);
    block_sum<K>(acc, red, part + (1 + L - j) * KK);
    conv_t<K>(dy, pj, wts + (1 + L - j) * KK, interior<K>(sm, G.gb[j], pj), pj, hj, wj);
    __syncthreads();
  }
  // sweep 2: dW_d += corr_s2(f_{j-1}, df_j); df_{j-1} = dh_{j-1} + DT(df_j), in place
#pragma unroll
  for (int t = 0; t < KK; ++t) acc[t] = 0.f;
  for (int j = L; j >= 1; --j) {
    const int pj = G.pitch[j], pp = G.pitch[j - 1];
    const float* df = interior<K>(sm, G.gb[j], pj);
    corr<K, 2>(interior<K>(sm, G.f[j - 1], pp), pp, df, pj, G.h[j], G.w[j], acc);
    float* dst = j == 1 ? H0 : interior<K>(sm, G.gb[j - 1], pp);
    down_t_add<K>(df, pj, wts, dst, pp, G.h[j - 1], G.w[j - 1]);
    __syncthreads();
  }
  block_sum<K>(acc, red, part);
  T* dxp = dx + plane * h0 * w0;
  for (int i = tid; i < h0 * w0; i += nt) {
    const int r = i / w0;
    store(dxp + i, H0[r * p0 + i - r * w0]);
  }
}

// dw[j][c][t] = sum over n of partial[n][c][j][t], n in order: one thread an output.
__global__ void recconv_bwd_sum_kernel(const float* __restrict__ partial,
                                       float* __restrict__ dw, int N, int C, int J, int KK) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= J * C * KK) return;
  const int t = i % KK, c = (i / KK) % C, j = i / (KK * C);
  float s = 0.f;
  for (int n = 0; n < N; ++n) s += partial[(((size_t)n * C + c) * J + j) * KK + t];
  dw[i] = s;
}

template <typename T, int K>
cudaError_t launch(const void* x, const void* g, void* dx, const float* weights,
                   const int4* fplans, const int2* bplans, float* partial, float* dw,
                   const Geometry& geo, int N, int C, int threads, int smem,
                   cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(recconv_bwd_kernel<T, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  recconv_bwd_kernel<T, K><<<N * C, threads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), static_cast<T*>(dx), weights,
      fplans, bplans, partial, geo, C);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int outputs = (geo.level + 2) * C * K * K;
  recconv_bwd_sum_kernel<<<(outputs + 255) / 256, 256, 0, s>>>(partial, dw, N, C,
                                                               geo.level + 2, K * K);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(int k, const void* x, const void* g, void* dx, const float* weights,
                     const int4* fplans, const int2* bplans, float* partial, float* dw,
                     const Geometry& geo, int N, int C, int threads, int smem,
                     cudaStream_t s) {
  switch (k) {
    case 3: return launch<T, 3>(x, g, dx, weights, fplans, bplans, partial, dw, geo, N, C,
                                threads, smem, s);
    case 5: return launch<T, 5>(x, g, dx, weights, fplans, bplans, partial, dw, geo, N, C,
                                threads, smem, s);
    case 7: return launch<T, 7>(x, g, dx, weights, fplans, bplans, partial, dw, geo, N, C,
                                threads, smem, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int K>
cudaError_t attributes(cudaFuncAttributes* a) {
  return cudaFuncGetAttributes(a, recconv_bwd_kernel<T, K>);
}

}  // namespace

extern "C" {

// dx, dw = the gradient of RecConv2d at x for g = dL/dy. x, g, dx: contiguous
// N x C x H x W, fp32 (is_bf16 = 0) or bf16; weights: (level + 2) x C x k x k fp32
// (down, conv0 .. conv{level}); fplans: the forward kernel's lerp-plan table; bplans:
// the transposed plan table; partial: N*C x (level + 2) x k x k fp32 scratch; dw:
// (level + 2) x C x k x k fp32; geometry: `geom_len` ints in the field order of
// Geometry (host memory). Launches on `stream` and returns cudaGetLastError().
int recconv_backward(const void* x, const void* g, void* dx, const void* weights,
                     const void* fplans, const void* bplans, void* partial, void* dw,
                     const int* geometry, int geom_len, int N, int C, int k, int threads,
                     int smem, int is_bf16, void* stream) {
  Geometry geo;
  if (geom_len != (int)(sizeof(Geometry) / sizeof(int))) return (int)cudaErrorInvalidValue;
  std::memcpy(&geo, geometry, sizeof(Geometry));
  if (geo.level < 1 || geo.level > kMaxLevel || N <= 0 || C <= 0 ||
      (threads != 64 && threads != 128 && threads != 256) || smem <= 0)
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
                                        threads, smem, s)
              : launch_k<float>(k, x, g, dx, w, fp, bp, part, out, geo, N, C, threads, smem, s);
  return (int)e;
}

// Registers per thread and local (spill and stack) bytes per thread of the backward
// kernel instantiated for k and the dtype.
int recconv_backward_attributes(int k, int is_bf16, int* registers, int* local_bytes) {
  cudaFuncAttributes a;
  cudaError_t e = cudaErrorInvalidValue;
  switch (k * 2 + (is_bf16 ? 1 : 0)) {
    case 6: e = attributes<float, 3>(&a); break;
    case 7: e = attributes<__nv_bfloat16, 3>(&a); break;
    case 10: e = attributes<float, 5>(&a); break;
    case 11: e = attributes<__nv_bfloat16, 5>(&a); break;
    case 14: e = attributes<float, 7>(&a); break;
    case 15: e = attributes<__nv_bfloat16, 7>(&a); break;
    default: break;
  }
  if (e != cudaSuccess) return (int)e;
  *registers = a.numRegs;
  *local_bytes = (int)a.localSizeBytes;
  return 0;
}

const char* recconv_backward_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
