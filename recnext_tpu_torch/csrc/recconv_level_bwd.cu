// The backward of one peeled RecConv2d level for Hopper (sm_90a): three tiled kernels
// that take any plane size, for planes whose whole backward does not fit in the
// shared memory of recconv_bwd.cu's kernel.
//
// The forward peels outer levels by the recursion
//   RecConv_L(x) = conv_L(z),  z = x + up(y),  y = RecConv_{L-1}(d),  d = down(x)
// (ops/recconv.py:rec_conv2d_peeled; csrc/recconv.cu:recconv_level_kernel computes
// each level). The backward walks the same recursion (ops/recconv.py:
// rec_conv2d_peeled_backward): given g = dL/d out, with d and y recomputed in fp32,
//   dz = conv_L^T(g)                      recconv_level_dgrad_kernel, stride 1
//   dW_L = sum z (*) g                    recconv_level_wgrad_kernel, stride 1, z built
//                                         from x + up(y) in its window
//   dy = up^T(dz)                         recconv_up_adjoint_kernel
//   (dd, dW_down, dW_0 .. dW_{L-1}) = the inner backward at (d, dy)
//   dx = dz + down^T(dd)                  recconv_level_dgrad_kernel, stride 2, adding dz
//   dW_down += sum x (*)_2 dd             recconv_level_wgrad_kernel, stride 2
// Every kernel accumulates in fp32 and is a gather (no atomics), so it gives the same
// bits on every run.
//
//   recconv_level_dgrad_kernel: the adjoint of the depthwise k x k conv at stride S
//     with zero padding k/2: dx[r, q] = sum_{i, j} w[i, j] g[(r + P - i) / S,
//     (q + P - j) / S] over the taps whose quotients are whole and inside g. A block
//     takes a 32 x 32 tile of dx, loads the window of g the tile reads (zero outside
//     g) into shared memory as fp32, and each thread computes 4 rows of one column. At
//     stride 2 a thread's rows share a parity, so each output keeps the taps i with
//     (r + P - i) even (the odd sizes ceil(H/2) come from the window's bounds, not
//     from a special case). It may add a second fine-grid fp32 gradient, so that
//     dx = dz + down^T(dd) is one pass, and writes f32 or bf16.
//   recconv_level_wgrad_kernel: the weight gradient of y = conv(z, w) at stride S. A
//     block takes a 32 x 32 tile of g and fills the fp32 window of z that the tile's
//     outputs read, as recconv_level_kernel does (its halo reaches k/2 past the tile,
//     S (32 - 1) + k rows and columns; where u is given, z = x + up(u) from the
//     forward's lerp plans, along H first, then along W), so z is never written out.
//     Each thread multiplies its 4 outputs' g into k*k register sums; the block adds
//     them by a warp butterfly and then the 8 warps in order, into one row of k*k
//     partial sums per (plane, tile). recconv_level_wgrad_sum_kernel adds a channel's
//     rows in a fixed tree (one block per channel and tap).
//   recconv_up_adjoint_kernel: du = up^T(dz), one thread per coarse element, gathered
//     through the transposed plan table (ops/cuda/recconv_bwd.py:transposed_plan_table:
//     for each coarse index, the fine indices and weights that read it, at most 4 per
//     axis; bilinear with align_corners=False or nearest).
//
// What bounds them on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): each reads its inputs once and writes its outputs once, with k*k multiply-
// adds per element (dgrad at stride 2: about k*k/4 per fine element); at k = 5 the
// bytes bound them. They are the simple forms: no register strips, no cp.async.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>

namespace {

constexpr int kTile = 32;     // outputs per side of a tile: 32 columns by 8 rows of
constexpr int kThreads = 256;  // threads, each thread 4 rows
constexpr int kMaxFan = 4;     // fine indices that read one coarse index, per axis

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void put(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}
// floor(a / S) for S in {1, 2} and any sign of a
template <int S>
__device__ __forceinline__ int floor_div(int a) {
  return S == 1 ? a : (a >> 1);
}

// dx = conv^T(g) (+ add) for the k x k depthwise conv at stride S: g is N*C planes of
// OH x OW in TG, w fp32 (C, K, K), add null or fp32 planes of H x W, y planes of H x W
// in TO.
template <typename TG, typename TO, int K, int S>
__global__ void __launch_bounds__(kThreads)
recconv_level_dgrad_kernel(const TG* __restrict__ g, const float* __restrict__ w,
                           const float* __restrict__ add, TO* __restrict__ y, int C, int H,
                           int W, int OH, int OW, int tiles_w, int tiles) {
  constexpr int P = K / 2;
  constexpr int R = (kTile - 1 + 2 * P) / S + 2;  // rows and columns of the g window
  constexpr int RP = R | 1;
  __shared__ float win[R * RP];
  const int plane = blockIdx.x / tiles, t = blockIdx.x - plane * tiles;
  const int r0 = t / tiles_w * kTile, q0 = t % tiles_w * kTile;
  // the first row and column of g that the tile reads: floor((r0 + P - (K - 1)) / S)
  const int or0 = floor_div<S>(r0 - P), oq0 = floor_div<S>(q0 - P);
  const TG* gp = g + (size_t)plane * OH * OW;
  for (int i = threadIdx.x; i < R * R; i += blockDim.x) {
    const int a = i / R, b = i - a * R, orow = or0 + a, ocol = oq0 + b;
    win[a * RP + b] = (orow >= 0 && orow < OH && ocol >= 0 && ocol < OW)
                          ? load_f32(gp, (size_t)orow * OW + ocol)
                          : 0.f;
  }
  float wk[K * K];
  const float* wc = w + (size_t)(plane % C) * K * K;
#pragma unroll
  for (int i = 0; i < K * K; ++i) wk[i] = __ldg(wc + i);
  __syncthreads();
  const int q = threadIdx.x % kTile, col = q0 + q;
  if (col >= W) return;
  const size_t base = (size_t)plane * H * W;
  for (int r = threadIdx.x / kTile; r < kTile && r0 + r < H; r += kThreads / kTile) {
    const int row = r0 + r;
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      if (S == 2 && ((row + P - i) & 1)) continue;
      const int a = floor_div<S>(row + P - i) - or0;
#pragma unroll
      for (int j = 0; j < K; ++j) {
        if (S == 2 && ((col + P - j) & 1)) continue;
        const int b = floor_div<S>(col + P - j) - oq0;
        acc = fmaf(win[a * RP + b], wk[i * K + j], acc);
      }
    }
    const size_t o = base + (size_t)row * W + col;
    if (add) acc += add[o];
    put(y, o, acc);
  }
}

// partial[c][n * tiles + tile][K * K] = the tile's sums of z (*) g for y = conv(z, w) at
// stride S: x is N*C planes of H x W in TI, u null or fp32 planes of UH x UW (z = x +
// up(u) by the plans' rows [0, H) and columns [H, H + W)), g planes of OH x OW in TG.
template <typename TI, typename TG, int K, int S>
__global__ void __launch_bounds__(kThreads)
recconv_level_wgrad_kernel(const TI* __restrict__ x, const float* __restrict__ u,
                           const int4* __restrict__ plans, const TG* __restrict__ g,
                           float* __restrict__ partial, int N, int C, int H, int W, int OH,
                           int OW, int UH, int UW, int tiles_w, int tiles) {
  constexpr int P = K / 2;
  constexpr int KK = K * K;
  constexpr int R = S * (kTile - 1) + K;  // rows and columns of the z window
  constexpr int RP = R | 1;
  __shared__ float win[R * RP];
  __shared__ float red[kThreads / 32][KK];
  const int plane = blockIdx.x / tiles, t = blockIdx.x - plane * tiles;
  const int r0 = t / tiles_w * kTile, q0 = t % tiles_w * kTile;
  const int gr0 = r0 * S - P, gq0 = q0 * S - P;
  const TI* xp = x + (size_t)plane * H * W;
  const float* up = u ? u + (size_t)plane * UH * UW : nullptr;
  for (int i = threadIdx.x; i < R * R; i += blockDim.x) {
    const int r = i / R, q = i - r * R, gr = gr0 + r, gq = gq0 + q;
    float v = 0.f;
    if (gr >= 0 && gr < H && gq >= 0 && gq < W) {
      v = load_f32(xp, (size_t)gr * W + gq);
      if (up) {  // along H first, then along W, as recconv_level_kernel
        const int4 rp = __ldg(plans + gr), cp = __ldg(plans + H + gq);
        const float* t0 = up + rp.x * UW;
        const float* t1 = up + rp.y * UW;
        const float wr = __int_as_float(rp.z);
        const float left = t0[cp.x] + (t1[cp.x] - t0[cp.x]) * wr;
        const float right = t0[cp.y] + (t1[cp.y] - t0[cp.y]) * wr;
        v += left + (right - left) * __int_as_float(cp.z);
      }
    }
    win[r * RP + q] = v;
  }
  __syncthreads();
  float acc[KK];
#pragma unroll
  for (int e = 0; e < KK; ++e) acc[e] = 0.f;
  const int q = threadIdx.x % kTile;
  const TG* gp = g + (size_t)plane * OH * OW;
  if (q0 + q < OW) {
    for (int r = threadIdx.x / kTile; r < kTile && r0 + r < OH; r += kThreads / kTile) {
      const float gv = load_f32(gp, (size_t)(r0 + r) * OW + q0 + q);
#pragma unroll
      for (int i = 0; i < K; ++i)
#pragma unroll
        for (int j = 0; j < K; ++j)
          acc[i * K + j] = fmaf(win[(S * r + i) * RP + S * q + j], gv, acc[i * K + j]);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int e = 0; e < KK; ++e) {
    float v = acc[e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][e] = v;
  }
  __syncthreads();
  if (threadIdx.x < KK) {
    float s = 0.f;
#pragma unroll
    for (int v = 0; v < kThreads / 32; ++v) s += red[v][threadIdx.x];
    const int n = plane / C, c = plane - n * C;
    partial[(((size_t)c * N + n) * tiles + t) * KK + threadIdx.x] = s;
  }
}

// dw[c][e] = the sum over rows r < rows of partial[c][r][e], in a fixed tree: one block
// per (c, e); thread i adds rows i, i + 256, ... in order, then the block halves.
__global__ void __launch_bounds__(kThreads)
recconv_level_wgrad_sum_kernel(const float* __restrict__ partial, float* __restrict__ dw,
                               int rows, int KK) {
  __shared__ float s[kThreads];
  const int c = blockIdx.x / KK, e = blockIdx.x - c * KK;
  const float* p = partial + (size_t)c * rows * KK + e;
  float v = 0.f;
  for (int r = threadIdx.x; r < rows; r += kThreads) v += p[(size_t)r * KK];
  s[threadIdx.x] = v;
  __syncthreads();
  for (int h = kThreads / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) s[threadIdx.x] += s[threadIdx.x + h];
    __syncthreads();
  }
  if (threadIdx.x == 0) dw[blockIdx.x] = s[0];
}

// du[a, b] = sum_{e, f} wr[a, e] wc[b, f] dz[ri[a, e], ci[b, f]]: dz is planes of H x W,
// du planes of UH x UW, both fp32; plans holds (fine index, weight bits) entries,
// kMaxFan per coarse row from entry 0 and per coarse column from entry `col0`.
__global__ void __launch_bounds__(kThreads)
recconv_up_adjoint_kernel(const float* __restrict__ dz, const int2* __restrict__ plans,
                          float* __restrict__ du, long long total, int H, int W, int UH,
                          int UW, int col0) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int b = (int)(i % UW);
  const long long rest = i / UW;
  const int a = (int)(rest % UH);
  const float* zp = dz + (size_t)(rest / UH) * H * W;
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < kMaxFan; ++e) {
    const int2 re = __ldg(plans + a * kMaxFan + e);
    const float wr = __int_as_float(re.y);
    if (wr == 0.f) continue;
    float row = 0.f;
#pragma unroll
    for (int f = 0; f < kMaxFan; ++f) {
      const int2 ce = __ldg(plans + col0 + b * kMaxFan + f);
      const float wc = __int_as_float(ce.y);
      if (wc != 0.f) row = fmaf(wc, zp[(size_t)re.x * W + ce.x], row);
    }
    s = fmaf(wr, row, s);
  }
  du[i] = s;
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

// The instantiation of kernel `kind` (0 dgrad, 1 wgrad, 2 the up adjoint) for (k,
// stride, the two dtype flags), or null.
const void* kernel_for(int kind, int k, int stride, int a_bf16, int b_bf16) {
  if (kind == 2) return reinterpret_cast<const void*>(recconv_up_adjoint_kernel);
  if ((stride != 1 && stride != 2) || (a_bf16 | b_bf16) > 1 || a_bf16 < 0 || b_bf16 < 0)
    return nullptr;
#define RECCONV_LEVEL_BWD_CASE(KS)                                                   \
  case KS:                                                                           \
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

int tiles_of(int oh, int ow, int* tiles_w) {
  *tiles_w = (ow + kTile - 1) / kTile;
  return *tiles_w * ((oh + kTile - 1) / kTile);
}

}  // namespace

extern "C" {

// y = conv^T(g) (+ add) for the depthwise k x k conv at `stride` (1 or 2) with zero
// padding k/2, whose input is H x W: g contiguous planes = N * C planes of ceil(H /
// stride) x ceil(W / stride), f32 (g_bf16 = 0) or bf16; w contiguous fp32 C x 1 x k x
// k; add null or contiguous fp32 planes of H x W; y planes of H x W, f32 (out_bf16 = 0)
// or bf16. Launches on `stream` and returns cudaGetLastError().
int recconv_level_dgrad(const void* g, const void* w, const void* add, void* y, int planes,
                        int C, int H, int W, int k, int stride, int g_bf16, int out_bf16,
                        void* stream) {
  const void* fn = kernel_for(0, k, stride, g_bf16, out_bf16);
  if (!fn || planes <= 0 || C <= 0 || H <= 0 || W <= 0) return (int)cudaErrorInvalidValue;
  int OH = (H + stride - 1) / stride, OW = (W + stride - 1) / stride, tiles_w = 0;
  int tiles = tiles_of(H, W, &tiles_w);
  if ((long long)tiles * planes > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  void* args[] = {&g, &w, &add, &y, &C, &H, &W, &OH, &OW, &tiles_w, &tiles};
  const cudaError_t e = cudaLaunchKernel(fn, dim3(tiles * planes), dim3(kThreads), args, 0,
                                         static_cast<cudaStream_t>(stream));
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// dw = the weight gradient of y = conv(z, w) at `stride`, z = x + up(u): x contiguous
// planes = N * C planes of H x W, f32 (x_bf16 = 0) or bf16; u null, or (stride 1 only)
// fp32 planes of ceil(H/2) x ceil(W/2) with `plans` the device lerp-plan table of that
// up-step (ops/cuda/recconv.py:lerp_plan_table(H, W, 1)); g planes of the output size
// in f32 (g_bf16 = 0) or bf16; partial fp32 scratch of C x N x tiles x k x k (tiles =
// ceil(OH/32) ceil(OW/32)); dw fp32 C x 1 x k x k. Two launches on `stream` (the tiles'
// partial sums, then their sum); returns cudaGetLastError().
int recconv_level_wgrad(const void* x, const void* u, const void* plans, const void* g,
                        void* partial, void* dw, int N, int C, int H, int W, int k,
                        int stride, int x_bf16, int g_bf16, void* stream) {
  const void* fn = kernel_for(1, k, stride, x_bf16, g_bf16);
  if (!fn || N <= 0 || C <= 0 || H <= 0 || W <= 0 || (u && (stride != 1 || !plans)))
    return (int)cudaErrorInvalidValue;
  int UH = (H + 1) / 2, UW = (W + 1) / 2;
  int OH = stride == 1 ? H : UH, OW = stride == 1 ? W : UW, tiles_w = 0;
  int tiles = tiles_of(OH, OW, &tiles_w);
  if ((long long)tiles * N * C > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  void* args[] = {&x, &u, &plans, &g, &partial, &N, &C, &H, &W, &OH, &OW, &UH, &UW,
                  &tiles_w, &tiles};
  cudaError_t e = cudaLaunchKernel(fn, dim3(tiles * N * C), dim3(kThreads), args, 0, s);
  if (e != cudaSuccess || (e = cudaGetLastError()) != cudaSuccess) return (int)e;
  const int KK = k * k, rows = N * tiles;
  recconv_level_wgrad_sum_kernel<<<C * KK, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<float*>(dw), rows, KK);
  return (int)cudaGetLastError();
}

// du = up^T(dz) for the up-step ceil(H/2) x ceil(W/2) -> H x W: dz contiguous fp32
// planes of H x W, du fp32 planes of the coarse size; plans the device transposed plan
// table of that up-step (ops/cuda/recconv_bwd.py:transposed_plan_table(H, W, 1)), its
// column entries from `col0`. Launches on `stream` and returns cudaGetLastError().
int recconv_up_adjoint(const void* dz, const void* plans, void* du, int planes, int H,
                       int W, int col0, void* stream) {
  if (planes <= 0 || H <= 0 || W <= 0 || !plans) return (int)cudaErrorInvalidValue;
  int UH = (H + 1) / 2, UW = (W + 1) / 2;
  long long total = (long long)planes * UH * UW;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidConfiguration;
  recconv_up_adjoint_kernel<<<(int)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dz), static_cast<const int2*>(plans),
      static_cast<float*>(du), total, H, W, UH, UW, col0);
  return (int)cudaGetLastError();
}

// Registers per thread and local bytes per thread of kernel `kind` (0 dgrad: a_bf16
// for g, b_bf16 for the output; 1 wgrad: a_bf16 for x, b_bf16 for g; 2 the up adjoint).
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
