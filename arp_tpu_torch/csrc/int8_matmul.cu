// Weight-only int8 matmul (kernel K3) for Hopper, sm_90a.
//
// Replaces the TPU kernel arp_tpu/ops/quantization.py::_int8_matmul_kernel
// (wrapper int8_matmul): out = (x.f32 @ (q.f32 * scale[n])).to(x.dtype) for
// x (M, K) float32 or bfloat16, q (K, N) int8 in the JAX package's layout and
// float32 per-column scales (1, N).  The TPU kernel computes in float32, so
// this one does too: the weights are dequantized into shared memory as they
// are loaded and every product is a float32 FMA.  Tensor cores would need TF32
// or bf16 operands and would change the numbers; they are later work.  Unlike
// the TPU wrapper it does not copy x and q into padded buffers: the ragged M
// and N edges (and a K that is not a multiple of the tile) are masked.
//
// What bounds it on an H100: at the image tower's sites (M = 50,432 rows at
// batch 256, K x N = 768 x 768 ... 3072 x 768) a call is 2*M*K*N = 59-238
// GFLOP against 40-160 MB of x and output, so it is far above the float32
// ridge (67 TFLOP/s / 3.35 TB/s = 20 FLOP a byte): the SIMT FMA rate bounds
// it, at least 0.9-3.6 ms a site.  The design is the classic register-tiled
// SGEMM: a 128 x 128 output tile per block of 256 threads, an 8 x 8 tile per
// thread read from shared memory four floats at a time, 16-deep K tiles
// double-buffered through registers so the next tile's loads are in flight
// while this one is multiplied.  The int8 weight moves a quarter of the bytes
// a float32 weight would.
//
// Plain C entry point (bound with ctypes): arp_int8_matmul returns the
// cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 16;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, T* __restrict__ out, int M, int N, int K,
                   long long lda) {
  // Tiles stored K-major: as[k][m] and bs[k][n], so a thread reads 4 rows or
  // 4 columns with one 16-byte load.
  __shared__ __align__(16) float as[2][kBK][kBM];
  __shared__ __align__(16) float bs[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;

  // This thread's share of each K tile: 8 values of x (row a_row, k a_k..a_k+7)
  // and 8 weights (k b_k, columns b_n..b_n+7).
  const int a_row = tid / 2, a_k = (tid % 2) * 8;
  const int b_k = tid / 16, b_n = (tid % 16) * 8;
  const bool a_live = m0 + a_row < M;
  const T* xrow = x + (long long)(m0 + a_row) * lda;
  float b_scale[8];
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const int n = n0 + b_n + c;
    b_scale[c] = n < N ? scale[n] : 0.f;
  }

  float a_reg[8];
  int8_t b_reg[8];
  auto load = [&](int k0) {
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int k = k0 + a_k + c;
      a_reg[c] = (a_live && k < K) ? to_f32(xrow[k]) : 0.f;
    }
    const int kb = k0 + b_k;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      const int n = n0 + b_n + c;
      b_reg[c] = (kb < K && n < N) ? q[(long long)kb * N + n] : (int8_t)0;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int c = 0; c < 8; ++c) as[buf][a_k + c][a_row] = a_reg[c];
#pragma unroll
    for (int c = 0; c < 8; ++c) bs[buf][b_k][b_n + c] = (float)b_reg[c] * b_scale[c];
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  const int n_tiles = (K + kBK - 1) / kBK;
  load(0);
  store(0);
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) load((t + 1) * kBK);
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[buf][kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[buf][kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[buf][kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[buf][kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (t + 1 < n_tiles) store(buf ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
    T* orow = out + (long long)row * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < N) orow[col] = from_f32<T>(acc[i][j]);
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* q, const float* scale, void* out, int M, int N,
                   int K, long long lda, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), q, scale,
                                                       static_cast<T*>(out), M, N, K, lda);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and out).  x is (M, K) with row stride
// lda elements; q is (K, N) int8 and out (M, N), both contiguous; scale is
// (1, N) float32.  Returns the launch's cudaError_t (0 = success).
extern "C" int arp_int8_matmul(const void* x, const void* q, const void* scale, void* out,
                               int dtype, int M, int N, int K, long long lda, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || (M + kBM - 1) / kBM > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int8_t* qp = static_cast<const int8_t*>(q);
  const float* sp = static_cast<const float*>(scale);
  if (dtype == 0) return (int)launch<float>(x, qp, sp, out, M, N, K, lda, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, qp, sp, out, M, N, K, lda, s);
  return (int)cudaErrorInvalidValue;
}
