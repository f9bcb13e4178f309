// Static-scale w8a8 GEMM with a fused epilogue (kernel K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel arp_tpu/ops/vit_infer.py::fused_int8_matmul (body
// `kern`): x (M, K) float32 or bfloat16 is quantized on the fly with the
// static activation scale a, q = clip(rint(x * 127/a), -127, 127), multiplied
// by the int8 weight as int8 x int8 -> int32 over the whole K, and the
// epilogue writes bf16(acc * (ws[n] * (a/127)) + bias[n]), with an optional
// quick-GELU v / (1 + exp(-1.702 v)) in float32 before the one rounding.
//
// What bounds it on an H100: one 768 -> 3072 site at M = 50,432 rows (batch
// 256) is 0.24 TOP of int8 work against about 0.39 GB of bf16 read and
// written, about 600 operations a byte: right at the card's int8 ridge
// (1,979 TOP/s / 3.35 TB/s = 590).  This first version issues mma.sync from
// 8 warps with one block an SM and no asynchronous copies, so its own issue
// rate (ldmatrix, quantize, mma.sync) bounds it long before either limit; the
// roofline it is measured against is the int8 tensor-core peak.  wgmma and
// TMA are later work.
//
// Design.  The TPU kernel holds the whole (K, N) weight in VMEM and walks M;
// a block here has at most 227 KB of shared memory, so the grid tiles M and N
// (128 x 128 a block) and each block loops over K in 64-deep tiles.  The x
// tile is quantized as it is staged into shared memory (each N tile
// re-quantizes its rows, which is cheap), so no int8 copy of x ever reaches
// device memory.  Tiles of the next K step are loaded into registers while
// the tensor cores work on this one (two shared-memory buffers).  Each warp
// owns a 32 x 64 tile of int32 accumulators in registers and feeds
// mma.sync.m16n8k32.s8 from shared memory with ldmatrix; the weight is read in
// (N, K) layout, K contiguous, which is the mma's column-major B operand.
// Shared rows are 80 bytes apart (64 + 16 pad), so ldmatrix's 8-row phases hit
// 32 distinct banks.  The ragged M edge is masked, not padded.
//
// Exactness: 127/max(a, 1e-12) is an IEEE division, x * inv one rounded
// product, __float2int_rn rounds half to even like jnp.round, and the
// epilogue's products and sum are rounded one at a time in JAX's order
// (__fmul_rn / __fadd_rn, no FMA contraction).  So the int8 values and int32
// sums equal the plain version's bit for bit; only exp in the quick-GELU can
// move the result, by at most one bf16 ulp.
//
// Plain C entry point (bound with ctypes): arp_int8_gemm returns the
// cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBN = 128;
constexpr int kBK = 64;
constexpr int kLD = kBK + 16;  // shared row stride in bytes
constexpr int kThreads = 256;

__device__ __forceinline__ int quantize(float v, float inv) {
  const int r = __float2int_rn(__fmul_rn(v, inv));
  return min(max(r, -127), 127);
}

__device__ __forceinline__ uint32_t pack4(float v0, float v1, float v2, float v3, float inv) {
  return (uint32_t)(quantize(v0, inv) & 0xff) | ((uint32_t)(quantize(v1, inv) & 0xff) << 8) |
         ((uint32_t)(quantize(v2, inv) & 0xff) << 16) | ((uint32_t)(quantize(v3, inv) & 0xff) << 24);
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2, uint32_t& r3,
                                            const void* smem) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Staging of one K tile of x through registers: float32 rows as 8 float4 a
// thread, bf16 rows as 4 uint4 (8 values each) a thread.
template <typename T>
struct XTile;

template <>
struct XTile<float> {
  static constexpr int kPer = 8;  // 16-byte chunks a thread
  static constexpr int kVals = 4;  // values a chunk
  float4 v[kPer];
  __device__ __forceinline__ void load(const float* x, long long lda, int M, int K, int m0, int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + kThreads * i;
      const int row = m0 + c / 16, k = k0 + (c % 16) * 4;
      v[i] = (row < M && k < K) ? *reinterpret_cast<const float4*>(x + (long long)row * lda + k)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __device__ __forceinline__ void store(int8_t* as, float inv) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + kThreads * i;
      *reinterpret_cast<uint32_t*>(as + (c / 16) * kLD + (c % 16) * 4) =
          pack4(v[i].x, v[i].y, v[i].z, v[i].w, inv);
    }
  }
};

template <>
struct XTile<__nv_bfloat16> {
  static constexpr int kPer = 4;
  uint4 v[kPer];
  __device__ __forceinline__ void load(const __nv_bfloat16* x, long long lda, int M, int K, int m0,
                                       int k0) {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + kThreads * i;
      const int row = m0 + c / 8, k = k0 + (c % 8) * 8;
      v[i] = (row < M && k < K) ? *reinterpret_cast<const uint4*>(x + (long long)row * lda + k)
                                : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void store(int8_t* as, float inv) const {
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int c = threadIdx.x + kThreads * i;
      uint2 w;
      w.x = pack4(bf16_lo(v[i].x), bf16_hi(v[i].x), bf16_lo(v[i].y), bf16_hi(v[i].y), inv);
      w.y = pack4(bf16_lo(v[i].z), bf16_hi(v[i].z), bf16_lo(v[i].w), bf16_hi(v[i].w), inv);
      *reinterpret_cast<uint2*>(as + (c / 8) * kLD + (c % 8) * 8) = w;
    }
  }
};

// One K tile of the (N, K) int8 weight: 2 uint4 a thread.
struct WTile {
  uint4 v[2];
  __device__ __forceinline__ void load(const int8_t* wt, int N, int K, int n0, int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = threadIdx.x + kThreads * i;
      const int n = n0 + c / 4, k = k0 + (c % 4) * 16;
      v[i] = (n < N && k < K) ? *reinterpret_cast<const uint4*>(wt + (long long)n * K + k)
                              : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void store(int8_t* bs) const {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = threadIdx.x + kThreads * i;
      *reinterpret_cast<uint4*>(bs + (c / 4) * kLD + (c % 4) * 16) = v[i];
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const T* __restrict__ x, const float* __restrict__ a_scale,
                 const int8_t* __restrict__ wt, const float* __restrict__ ws,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int N,
                 int K, long long lda, int act) {
  __shared__ __align__(16) int8_t as[2][kBM * kLD];
  __shared__ __align__(16) int8_t bs[2][kBN * kLD];

  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int warp_m = warp % 4, warp_n = warp / 4;  // a 32 x 64 tile of the 128 x 128 block
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const float a = *a_scale;
  const float inv = 127.0f / fmaxf(a, 1e-12f);

  XTile<T> xt;
  WTile wtile;
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // ldmatrix row addresses of this lane: A rows (lane % 16) at k + 16 (lane / 16);
  // B rows (lane % 8) + 8 (lane / 16) at k + 16 ((lane / 8) % 2).
  const int a_row = warp_m * 32 + lane % 16, a_k = (lane / 16) * 16;
  const int b_row = warp_n * 64 + lane % 8 + 8 * (lane / 16), b_k = ((lane / 8) % 2) * 16;

  const int n_tiles = (K + kBK - 1) / kBK;
  xt.load(x, lda, M, K, m0, 0);
  wtile.load(wt, N, K, n0, 0);
  xt.store(as[0], inv);
  wtile.store(bs[0]);
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      xt.load(x, lda, M, K, m0, (t + 1) * kBK);
      wtile.load(wt, N, K, n0, (t + 1) * kBK);
    }
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ldmatrix_x4(af[i][0], af[i][1], af[i][2], af[i][3],
                    &as[buf][(a_row + 16 * i) * kLD + ks + a_k]);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b0, b1, b2, b3;  // n8 tile j: (b0, b1); tile j + 1: (b2, b3)
        ldmatrix_x4(b0, b1, b2, b3, &bs[buf][(b_row + 8 * j) * kLD + ks + b_k]);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma_s8(acc[i][j], af[i], b0, b1);
          mma_s8(acc[i][j + 1], af[i], b2, b3);
        }
      }
    }
    if (t + 1 < n_tiles) {
      xt.store(as[buf ^ 1], inv);
      wtile.store(bs[buf ^ 1]);
    }
    __syncthreads();
  }

  // Epilogue: thread (g, c) of the warp holds rows g and g + 8, columns
  // 2c and 2c + 1 of each 16 x 8 tile.
  const float a_over = __fdiv_rn(a, 127.0f);
  const int g = lane / 4, c2 = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = n0 + warp_n * 64 + j * 8 + c2;
    if (col >= N) continue;  // N % 8 == 0: a tile of 8 columns is all in or all out
    const float f0 = __fmul_rn(ws[col], a_over), f1 = __fmul_rn(ws[col + 1], a_over);
    const float b0 = bias ? bias[col] : 0.f, b1 = bias ? bias[col + 1] : 0.f;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = m0 + warp_m * 32 + i * 16 + g + 8 * h;
        if (row >= M) continue;
        float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h]), f0), b0);
        float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + 1]), f1), b1);
        if (act == 1) {
          v0 = v0 / (1.0f + expf(-1.702f * v0));
          v1 = v1 / (1.0f + expf(-1.702f * v1));
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * N + col) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const float* a_scale, const int8_t* wt, const float* ws,
                   const float* bias, __nv_bfloat16* out, int M, int N, int K, long long lda,
                   int act, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_gemm_kernel<T><<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x), a_scale, wt, ws,
                                                     bias, out, M, N, K, lda, act);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 x.  x is (M, K) with row stride lda
// elements (16-byte aligned rows); a_scale points at one float32 on the
// device; wt is the (N, K) int8 weight, contiguous; ws (N) float32; bias (N)
// float32 or null; out (M, N) bf16, contiguous.  act: 0 none, 1 quick-GELU.
// Needs K % 32 == 0 and N % 8 == 0.  Returns the launch's cudaError_t.
extern "C" int arp_int8_gemm(const void* x, const void* a_scale, const void* wt, const void* ws,
                             const void* bias, void* out, int dtype, int M, int N, int K,
                             long long lda, int act, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || N % 8 != 0 || (act != 0 && act != 1) ||
      (M + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a_scale);
  const int8_t* wp = static_cast<const int8_t*>(wt);
  const float* wsp = static_cast<const float*>(ws);
  const float* bp = static_cast<const float*>(bias);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  if (dtype == 0) return (int)launch<float>(x, ap, wp, wsp, bp, op, M, N, K, lda, act, s);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(x, ap, wp, wsp, bp, op, M, N, K, lda, act, s);
  return (int)cudaErrorInvalidValue;
}
