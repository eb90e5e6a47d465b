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
// Layout. Every operand is a (B, H, N, D) view given by a base pointer and four
// element strides, so the kernel reads the model's NCHW tensors in place: head h of q
// is the (D, N) slab at channels [h*D, (h+1)*D) of qk, k the slab at C + h*D, and v
// and out the slabs of v and out (n stride 1). The (BH, N, D) layout of the JAX
// package (d stride 1) is the same kernel with other strides. Nothing is transposed
// or copied around the launch.
//
// Design. One block per (batch, head); its threads cover a tile of `nt` positions.
//   1. Stream N in tiles through shared memory: k as D rows and v as DV rows (plus a
//      row of ones, so ksum is column DV of the same product), each thread
//      accumulating four entries of one kv row over the tile with 16-byte loads
//      along n.
//   2. Stream N again: each thread takes one position of the tile, forms q.ksum and
//      q kv from the q tile and kv in shared memory, and stages its DV outputs in
//      shared memory; the block then writes the tile out.
// Tile loads and stores map consecutive threads to whichever of n and d is
// contiguous in device memory, so both layouts move whole cache lines, and each
// thread keeps kInFlight loads in flight before it stores any of them.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32 outside the tensor
// cores): at recnext_a1's stage 0 (batch 256, 2 heads, N = 784, D = DV = 24, bf16)
// the function moves 77 MB (q, k, v in, out written) and does ~0.93 GFLOP, so bytes
// bound it at every a1 stage (23 us at stage 0, 3.8 us at stage 3). The design reads
// q, k, v once and writes out once; kv, ksum and the normaliser never leave the chip.
// Tensor cores (mma/wgmma) and TMA tile loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDim = 128;    // D and DV
constexpr int kMaxThreads = 128;
constexpr int kChunk = 8;       // output columns one thread keeps in registers (pass 2)
constexpr int kInFlight = 8;    // global loads one thread issues before it waits

struct View {
  long long b, h, n, d;  // element strides of a (B, H, N, D) view
};

struct Views {
  View q, k, v, o;
};

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Threads per block: one per position of a tile, whole warps.
inline int threads_for(int N) { return N >= kMaxThreads ? kMaxThreads : round_up(N, 32); }

// Shared memory, in floats: the k / q tile (D rows), the v / out tile (kvp rows: DV
// of v, a row of ones, zero rows), and kv with ksum in column DV (D x kvp). The row
// pitch nt + 4 keeps rows 16-byte aligned and puts the rows of one warp's 16-byte
// loads on different banks.
__host__ __device__ inline int smem_floats(int nt, int D, int DV) {
  const int pitch = nt + 4, kvp = round_up(DV + 1, kChunk);
  return D * pitch + kvp * pitch + D * kvp;
}

__device__ __forceinline__ float load_f32(const float* p, long long i) { return p[i]; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) { p[i] = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i, float v) {
  p[i] = __float2bfloat16(v);
}

// Element i of a tile of `rows` x nt: consecutive i run along n where n is
// contiguous in device memory, along d otherwise.
__device__ __forceinline__ void tile_pos(int i, int rows, int nt, bool n_contig, int& r,
                                         int& t) {
  if (n_contig) {
    r = i / nt;
    t = i - r * nt;
  } else {
    t = i / rows;
    r = i - t * rows;
  }
}

// dst[r * pitch + t] = src[(n0 + t) * s.n + r * s.d] for r < rows, t < nt; zero for
// t >= L, so the 4-wide loops of pass 1 may run past the tile's end. The loads of
// one round are all issued before the first store, so they overlap.
template <typename T>
__device__ void load_tile(float* dst, const T* src, const View& s, int n0, int L, int rows,
                          int pitch) {
  const int tid = threadIdx.x, nt = blockDim.x, total = rows * nt;
  const bool n_contig = s.n == 1;
  for (int i0 = tid; i0 < total; i0 += kInFlight * nt) {
    float val[kInFlight];
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int i = i0 + j * nt;
      int r, t;
      tile_pos(i, rows, nt, n_contig, r, t);
      val[j] = i < total && t < L
                   ? load_f32(src, (long long)(n0 + t) * s.n + (long long)r * s.d)
                   : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kInFlight; ++j) {
      const int i = i0 + j * nt;
      int r, t;
      tile_pos(i, rows, nt, n_contig, r, t);
      if (i < total) dst[r * pitch + t] = val[j];
    }
  }
}

template <typename T>
__device__ void store_tile(T* dst, const float* src, const View& s, int n0, int L, int rows,
                           int pitch) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool n_contig = s.n == 1;
  for (int i = tid; i < rows * nt; i += nt) {
    int r, t;
    tile_pos(i, rows, nt, n_contig, r, t);
    if (t < L) store(dst, (long long)(n0 + t) * s.n + (long long)r * s.d, src[r * pitch + t]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
linear_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o, Views s, int H, int N,
                        int D, int DV, float eps) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int pitch = nt + 4, kvp = round_up(DV + 1, kChunk);
  float* a = smem;                 // D rows: the k tile, then the q tile
  float* b = a + D * pitch;        // kvp rows: the v tile (+ ones), then the out tile
  float* kv = b + kvp * pitch;     // D x kvp; ksum in column DV
  const int bi = blockIdx.x / H, hi = blockIdx.x - bi * H;
  q += bi * s.q.b + hi * s.q.h;
  k += bi * s.k.b + hi * s.k.h;
  v += bi * s.v.b + hi * s.v.h;
  o += bi * s.o.b + hi * s.o.h;

  for (int i = tid; i < D * kvp; i += nt) kv[i] = 0.f;
  for (int i = tid; i < (kvp - DV) * pitch; i += nt) b[DV * pitch + i] = i < pitch ? 1.f : 0.f;

  // 1. kv and ksum over all positions: thread u owns kv[d][e + strips * j], j < 4, so
  //    the lanes of a warp read consecutive v rows (distinct banks: pitch = 4 mod 32)
  const int strips = kvp / 4;
  for (int n0 = 0; n0 < N; n0 += nt) {
    const int L = min(nt, N - n0);
    load_tile(a, k, s.k, n0, L, D, pitch);
    load_tile(b, v, s.v, n0, L, DV, pitch);
    __syncthreads();
    for (int u = tid; u < D * strips; u += nt) {
      const int d = u / strips, e = u - d * strips;
      const float* kr = a + d * pitch;
      const float* vr = b + e * pitch;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int t = 0; t < L; t += 4) {
        const float4 kk = *reinterpret_cast<const float4*>(kr + t);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float4 vv = *reinterpret_cast<const float4*>(vr + j * strips * pitch + t);
          acc[j] = fmaf(kk.x, vv.x, acc[j]);
          acc[j] = fmaf(kk.y, vv.y, acc[j]);
          acc[j] = fmaf(kk.z, vv.z, acc[j]);
          acc[j] = fmaf(kk.w, vv.w, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[d * kvp + e + strips * j] += acc[j];
    }
    __syncthreads();
  }

  // 2. out = (q kv) / (N * (q . ksum / N + eps)), one position per thread
  for (int n0 = 0; n0 < N; n0 += nt) {
    const int L = min(nt, N - n0);
    load_tile(a, q, s.q, n0, L, D, pitch);
    __syncthreads();
    if (tid < L) {
      const float* qc = a + tid;
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qc[d * pitch], kv[d * kvp + DV], dot);
      const float den = (dot / (float)N + eps) * (float)N;
      for (int e0 = 0; e0 < DV; e0 += kChunk) {
        float acc[kChunk];
#pragma unroll
        for (int j = 0; j < kChunk; ++j) acc[j] = 0.f;
        for (int d = 0; d < D; ++d) {
          const float qd = qc[d * pitch];
          const float4 k0 = *reinterpret_cast<const float4*>(kv + d * kvp + e0);
          const float4 k1 = *reinterpret_cast<const float4*>(kv + d * kvp + e0 + 4);
          acc[0] = fmaf(qd, k0.x, acc[0]);
          acc[1] = fmaf(qd, k0.y, acc[1]);
          acc[2] = fmaf(qd, k0.z, acc[2]);
          acc[3] = fmaf(qd, k0.w, acc[3]);
          acc[4] = fmaf(qd, k1.x, acc[4]);
          acc[5] = fmaf(qd, k1.y, acc[5]);
          acc[6] = fmaf(qd, k1.z, acc[6]);
          acc[7] = fmaf(qd, k1.w, acc[7]);
        }
#pragma unroll
        for (int j = 0; j < kChunk; ++j)
          if (e0 + j < DV) b[(e0 + j) * pitch + tid] = acc[j] / den;
      }
    }
    __syncthreads();
    store_tile(o, b, s.o, n0, L, DV, pitch);
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Views& s,
                   int B, int H, int N, int D, int DV, float eps, cudaStream_t stream) {
  const int nt = threads_for(N);
  const size_t smem = (size_t)smem_floats(nt, D, DV) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        linear_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  linear_attention_kernel<T><<<B * H, nt, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), s, H, N, D, DV, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory one block needs; -1 outside the kernel's limits.
int linear_attention_smem_bytes(int N, int D, int DV) {
  if (N <= 0 || D <= 0 || DV <= 0 || D > kMaxDim || DV > kMaxDim) return -1;
  return smem_floats(threads_for(N), D, DV) * (int)sizeof(float);
}

// out = linear_attention(q, k, v) for every (batch, head). q, k: (B, H, N, D); v, out:
// (B, H, N, DV); all fp32 (is_bf16 = 0) or all bf16. strides: 16 element strides, the
// (b, h, n, d) strides of q, k, v and out in that order. Launches on `stream` and
// returns cudaGetLastError().
int linear_attention_forward(const void* q, const void* k, const void* v, void* out,
                             const long long* strides, int B, int H, int N, int D, int DV,
                             float eps, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || N <= 0 || D <= 0 || DV <= 0 || D > kMaxDim || DV > kMaxDim)
    return (int)cudaErrorInvalidValue;
  const Views s = {{strides[0], strides[1], strides[2], strides[3]},
                   {strides[4], strides[5], strides[6], strides[7]},
                   {strides[8], strides[9], strides[10], strides[11]},
                   {strides[12], strides[13], strides[14], strides[15]}};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e =
      is_bf16 ? launch<__nv_bfloat16>(q, k, v, out, s, B, H, N, D, DV, eps, st)
              : launch<float>(q, k, v, out, s, B, H, N, D, DV, eps, st);
  return (int)e;
}

const char* linear_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
