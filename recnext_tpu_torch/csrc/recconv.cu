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
// Design. Every (n, c) plane of an NCHW tensor is independent and contiguous, so one
// thread block owns one plane: it loads the plane and the channel's (level+2)*k*k
// weights into shared memory as fp32, builds and walks the pyramid there, and writes
// y once in the input dtype. Device memory sees x read once and y written once; all
// intermediates stay on chip. Every level buffer carries a zero halo of k/2, so the
// tap loops have no bounds checks. The lerp plan (source indices and weights) is
// computed per block in double precision exactly as ops/resize.py:_bilinear_axis_plan
// does with numpy, then rounded to fp32.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at recnext_m1's stage 0 (256 x 48 x 56 x 56, level 4, bf16) the kernel must
// move ~154 MB (x in, y out) and do ~1.6 G fp32 multiply-adds (3.2 GFLOP) (25 per output
// of each of the 9 convolutions, 5,226 outputs per plane, 12,288 planes), so the
// memory bound (~46 us) and the fp32 bound (~48 us) are nearly equal. This first
// version is simple on purpose: one plane per block, scalar loads, stride-2 reads
// that conflict two ways in shared memory. Packing several small planes per block and
// vector loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevel = 4;

struct Weights {
  const void* w[kMaxLevel + 2];  // down, convs[0] .. convs[level]
};

// Offsets, in 4-byte words of dynamic shared memory, of everything one block keeps.
// Shared by the host (to size the launch) and the device (to carve the buffer).
struct Geometry {
  int h[kMaxLevel + 1], w[kMaxLevel + 1];  // level sizes; [0] is the input plane
  int wts;                                  // (level + 2) * k * k fp32 weights
  int rows[kMaxLevel + 1];                  // lerp plan rows of the upsample l -> l-1
  int cols[kMaxLevel + 1];                  // lerp plan cols of the upsample l -> l-1
  int buf[kMaxLevel + 1];                   // padded fp32 level buffers, contiguous
  int tmp;                                  // conv output at one level (<= level 1)
  int words;
};

__host__ __device__ inline Geometry make_geometry(int H, int W, int level, int K) {
  Geometry g;
  const int P = K / 2;
  g.h[0] = H;
  g.w[0] = W;
  for (int l = 1; l <= level; ++l) {
    g.h[l] = (g.h[l - 1] + 1) / 2;
    g.w[l] = (g.w[l - 1] + 1) / 2;
  }
  int off = 0;
  g.wts = off;
  off += (level + 2) * K * K;
  for (int l = 1; l <= level; ++l) {
    g.rows[l] = off;
    off += 3 * g.h[l - 1];
    g.cols[l] = off;
    off += 3 * g.w[l - 1];
  }
  for (int l = 0; l <= level; ++l) {
    g.buf[l] = off;
    off += (g.h[l] + 2 * P) * (g.w[l] + 2 * P);
  }
  g.tmp = off;
  off += g.h[1] * g.w[1];
  g.words = off;
  return g;
}

__device__ __forceinline__ float load_f32(const float* p, size_t i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, size_t i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, size_t i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, size_t i, float v) {
  p[i] = __float2bfloat16(v);
}

// Lerp plan of one axis, as ops/resize.py:_bilinear_axis_plan: entry i holds
// (idx0, idx1, w1) for output i. The _rn intrinsics keep the double arithmetic
// unfused, as numpy computes it.
__device__ void build_plan(float* plan, int in, int out, int tid, int nt) {
  const double scale = (double)in / (double)out;
  for (int i = tid; i < out; i += nt) {
    double src = __dadd_rn(__dmul_rn(scale, (double)i + 0.5), -0.5);
    src = src < 0.0 ? 0.0 : src;
    int i0 = (int)floor(src);
    i0 = i0 < in - 1 ? i0 : in - 1;
    const int i1 = i0 + 1 < in - 1 ? i0 + 1 : in - 1;
    plan[3 * i] = __int_as_float(i0);
    plan[3 * i + 1] = __int_as_float(i1);
    plan[3 * i + 2] = (float)__dadd_rn(src, -(double)i0);
  }
}

// k x k taps at `src` (top-left of the window in a padded buffer of row pitch `pitch`)
template <int K>
__device__ __forceinline__ float taps(const float* src, int pitch, const float* wk) {
  float acc = 0.f;
#pragma unroll
  for (int dy = 0; dy < K; ++dy)
#pragma unroll
    for (int dx = 0; dx < K; ++dx) acc = fmaf(src[dy * pitch + dx], wk[dy * K + dx], acc);
  return acc;
}

template <typename T, int K>
__global__ void __launch_bounds__(256)
recconv_kernel(const T* __restrict__ x, T* __restrict__ y, Weights wp, int C, int H, int W,
               int level) {
  extern __shared__ float smem[];
  constexpr int P = K / 2;
  const Geometry g = make_geometry(H, W, level, K);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int c = blockIdx.x % C;
  const size_t base = (size_t)blockIdx.x * H * W;

  // zero halos, load weights, build the lerp plans
  for (int i = g.buf[0] + tid; i < g.tmp; i += nt) smem[i] = 0.f;
  float* wts = smem + g.wts;
  for (int i = tid; i < (level + 2) * K * K; i += nt) {
    const int j = i / (K * K), t = i % (K * K);
    wts[i] = load_f32(static_cast<const T*>(wp.w[j]), (size_t)c * K * K + t);
  }
  for (int l = 1; l <= level; ++l) {
    build_plan(smem + g.rows[l], g.h[l], g.h[l - 1], tid, nt);
    build_plan(smem + g.cols[l], g.w[l], g.w[l - 1], tid, nt);
  }
  __syncthreads();

  {
    float* b0 = smem + g.buf[0];
    const int pitch = W + 2 * P;
    for (int i = tid; i < H * W; i += nt) {
      const int r = i / W, q = i % W;
      b0[(r + P) * pitch + q + P] = load_f32(x, base + i);
    }
  }
  __syncthreads();

  // 1. downsample pyramid: f_l = down(f_{l-1}), stride 2
  for (int l = 1; l <= level; ++l) {
    const float* src = smem + g.buf[l - 1];
    const int spitch = g.w[l - 1] + 2 * P;
    float* dst = smem + g.buf[l];
    const int dpitch = g.w[l] + 2 * P;
    const int oh = g.h[l], ow = g.w[l];
    for (int i = tid; i < oh * ow; i += nt) {
      const int r = i / ow, q = i % ow;
      dst[(r + P) * dpitch + q + P] = taps<K>(src + 2 * r * spitch + 2 * q, spitch, wts);
    }
    __syncthreads();
  }

  // 2. walk back up: tmp = conv_l(f_l + acc); f_{l-1} += up(tmp)
  float* tmp = smem + g.tmp;
  for (int l = level; l >= 1; --l) {
    const float* wk = wts + (1 + level - l) * K * K;  // convs[level - l]
    const float* src = smem + g.buf[l];
    const int spitch = g.w[l] + 2 * P;
    const int ih = g.h[l], iw = g.w[l];
    for (int i = tid; i < ih * iw; i += nt) {
      const int r = i / iw, q = i % iw;
      tmp[i] = taps<K>(src + r * spitch + q, spitch, wk);
    }
    __syncthreads();

    const float* rows = smem + g.rows[l];
    const float* cols = smem + g.cols[l];
    float* dst = smem + g.buf[l - 1];
    const int dpitch = g.w[l - 1] + 2 * P;
    const int oh = g.h[l - 1], ow = g.w[l - 1];
    for (int i = tid; i < oh * ow; i += nt) {
      const int r = i / ow, q = i % ow;
      const int r0 = __float_as_int(rows[3 * r]), r1 = __float_as_int(rows[3 * r + 1]);
      const int c0 = __float_as_int(cols[3 * q]), c1 = __float_as_int(cols[3 * q + 1]);
      const float wr = rows[3 * r + 2], wc = cols[3 * q + 2];
      // along H first, then along W, as resize_bilinear does
      const float left = tmp[r0 * iw + c0] + (tmp[r1 * iw + c0] - tmp[r0 * iw + c0]) * wr;
      const float right = tmp[r0 * iw + c1] + (tmp[r1 * iw + c1] - tmp[r0 * iw + c1]) * wr;
      dst[(r + P) * dpitch + q + P] += left + (right - left) * wc;
    }
    __syncthreads();
  }

  // 3. y = conv_level(x + acc), written once in the input dtype
  {
    const float* wk = wts + (1 + level) * K * K;
    const float* src = smem + g.buf[0];
    const int pitch = W + 2 * P;
    for (int i = tid; i < H * W; i += nt) {
      const int r = i / W, q = i % W;
      store(y, base + i, taps<K>(src + r * pitch + q, pitch, wk));
    }
  }
}

template <typename T, int K>
cudaError_t launch(const void* x, void* y, const Weights& wp, int N, int C, int H, int W,
                   int level, cudaStream_t stream) {
  const size_t smem = (size_t)make_geometry(H, W, level, K).words * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        recconv_kernel<T, K>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int hw = H * W;
  const int threads = hw >= 2048 ? 256 : (hw >= 512 ? 128 : 64);
  recconv_kernel<T, K><<<N * C, threads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), wp, C, H, W, level);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_k(const void* x, void* y, const Weights& wp, int N, int C, int H, int W,
                     int level, int k, cudaStream_t stream) {
  switch (k) {
    case 3: return launch<T, 3>(x, y, wp, N, C, H, W, level, stream);
    case 5: return launch<T, 5>(x, y, wp, N, C, H, W, level, stream);
    case 7: return launch<T, 7>(x, y, wp, N, C, H, W, level, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs for an H x W plane.
int recconv_smem_bytes(int H, int W, int level, int k) {
  if (level < 1 || level > kMaxLevel) return -1;
  return make_geometry(H, W, level, k).words * (int)sizeof(float);
}

// y = RecConv2d(x). x, y: contiguous N x C x H x W, fp32 (is_bf16 = 0) or bf16;
// down, conv0..conv{level}: contiguous C x 1 x k x k in the same dtype (unused conv
// pointers may be null). Launches on `stream` and returns cudaGetLastError().
int recconv_forward(const void* x, void* y, const void* down, const void* conv0,
                    const void* conv1, const void* conv2, const void* conv3,
                    const void* conv4, int N, int C, int H, int W, int level, int k,
                    int is_bf16, void* stream) {
  if (level < 1 || level > kMaxLevel || N <= 0 || C <= 0 || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  const Weights wp = {{down, conv0, conv1, conv2, conv3, conv4}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch_k<__nv_bfloat16>(x, y, wp, N, C, H, W, level, k, s)
              : launch_k<float>(x, y, wp, N, C, H, W, level, k, s);
  return (int)e;
}

const char* recconv_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
