// Weight-only int8 matmul (kernel K3) for Hopper, sm_90a.
//
// Replaces the TPU kernel arp_tpu/ops/quantization.py::_int8_matmul_kernel
// (wrapper int8_matmul): out = (x.f32 @ (q.f32 * scale[n])).to(x.dtype) for
// x (M, K) float32 or bfloat16, q (K, N) int8 in the JAX package's layout and
// float32 per-column scales (1, N).
//
// Arithmetic.  An int8 weight (|q| <= 127) is exact in bf16, so the weight
// tile is staged to shared memory as bf16 WITHOUT its scale and the scale is
// applied once per output on the fp32 accumulator: (sum_k x q) * scale[n]
// where the TPU kernel computes sum_k x (q * scale[n]).  bf16 x: one pass on
// the tensor cores, every product exact.  float32 x: split exactly into three
// bf16 pieces in registers (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x -
// hi - mid); 3 x 8 bits cover the 24-bit significand), three passes into one
// accumulator, smallest piece first.  Every product (8 x 7 bits) is exact;
// only the order and the rounding of the fp32 sums differ from a float32
// matmul (the tensor cores may truncate where an FMA rounds).  The plain
// version of this arithmetic is ops/quantization.py::int8_matmul_split_reference.
//
// What bounds it on an H100: at the image tower's sites (M = 50,432 rows at
// batch 256, K x N = 768 x 768 ... 3072 x 768) a call is 2 M K N = 59-238
// GFLOP.  At the 989 TFLOP/s bf16 tensor-core peak that is 0.06-0.24 ms for
// bf16 x and three times that for float32 x; x, q and the output move once in
// 0.05-0.23 ms at 3.35 TB/s.  So the tensor cores bound the float32 path, and
// bytes and operations meet for bf16.  The earlier version (fp32 FMAs on the
// SIMT cores, 67 TFLOP/s peak) could not go below 3.55 ms at 768 -> 3072.
//
// Design: a block of two warpgroups computes a 128 x 256 output tile, each
// warpgroup 64 rows with wgmma m64n256k16 (128 fp32 accumulators a thread).
// K tiles (64 deep for bf16 x, 32 for float32 x) go through a four-stage ring
// in shared memory: x arrives by cp.async (16 bytes a thread, zero-filled at
// the ragged M and K edges, read through lda); the int8 tile is loaded to
// registers before the tile's wgmmas are issued and converted and stored (as
// bf16, 128-byte swizzled, N contiguous: an MN-major B operand) while they
// run.  bf16 x is read by wgmma straight from swizzled shared memory; float32
// x is read from a padded tile into the A-fragment registers and split there.
// With bf16 x a tile's wgmmas stay in flight while the next tile's are issued
// (the loop waits only for the tile before); with float32 x the second k16
// step is split while the first runs.  Tiles are loaded two or three ahead,
// the weights wait one iteration in registers, and there is one
// __syncthreads() a K tile.  The epilogue scales, casts and goes
// through shared memory so that output rows leave in 16-byte stores.  Ragged
// N is masked there; an x, q or out whose rows are not 16-byte aligned takes
// element-wise accesses.
//
// Plain C entry point (bound with ctypes): arp_int8_matmul returns the
// cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

using namespace arp;

constexpr int kBM = 128;  // two warpgroups x 64 rows
constexpr int kBN = 256;  // one wgmma n256
constexpr int kThreads = 256;
constexpr int kStages = 4;

template <typename T>
struct Cfg;
template <>
struct Cfg<float> {
  static constexpr int kBK = 32;
  static constexpr int kXRow = 160;  // 128 bytes of x + 32 of padding: fragment reads hit 32 banks
  static constexpr int kAhead = kStages - 1;  // tiles loaded ahead of the one being multiplied
};
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int kBK = 64;
  static constexpr int kXRow = 128;  // one swizzle row
  static constexpr int kAhead = kStages - 2;  // one less: a tile's wgmmas outlive its iteration
};

template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return kBM * Cfg<T>::kXRow + Cfg<T>::kBK * kBN * 2;
}
template <typename T>
__host__ __device__ constexpr int smem_bytes() {
  return kStages * stage_bytes<T>() + 1024;  // + room to align the ring to 1024 bytes
}

__device__ __forceinline__ float bf16_lo(uint32_t h) { return __uint_as_float(h << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t h) { return __uint_as_float(h & 0xffff0000u); }

// (x0, x1) = hi + mid + lo exactly, each a pair of bf16.
__device__ __forceinline__ void split_bf16x3(float2 x, uint32_t& hi, uint32_t& mid, uint32_t& lo) {
  hi = pack_bf16x2(x.x, x.y);
  const float r0 = x.x - bf16_lo(hi), r1 = x.y - bf16_hi(hi);
  mid = pack_bf16x2(r0, r1);
  lo = pack_bf16x2(r0 - bf16_lo(mid), r1 - bf16_hi(mid));
}

// Four int8 (one word) -> four bf16 (two words), exactly: byte b + 128 placed
// in the low mantissa bits of 2^23 is the float 2^23 + 128 + b; subtracting
// 2^23 + 128 leaves b, whose low 16 bits are zero, so its upper half is its bf16.
__device__ __forceinline__ void int8x4_to_bf16x4(uint32_t w, uint32_t& h01, uint32_t& h23) {
  const uint32_t v = w ^ 0x80808080u;
  const float kMagic = 8388736.f;  // 2^23 + 128
  const float f0 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540)) - kMagic;
  const float f1 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7541)) - kMagic;
  const float f2 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7542)) - kMagic;
  const float f3 = __uint_as_float(__byte_perm(v, 0x4B000000u, 0x7543)) - kMagic;
  h01 = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  h23 = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16x2(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
int8_matmul_kernel(const T* __restrict__ x, const int8_t* __restrict__ q,
                   const float* __restrict__ scale, T* __restrict__ out, int M, int N, int K,
                   long long lda, int x_vec, int q_vec, int out_vec) {
  constexpr bool kF32 = sizeof(T) == 4;
  constexpr int BK = Cfg<T>::kBK;
  constexpr int XROW = Cfg<T>::kXRow;
  constexpr int X_TILE = kBM * XROW;
  constexpr int PANEL = BK * 128;        // 64 columns of the weight tile: BK rows of 128 bytes
  constexpr int STAGE = stage_bytes<T>();
  constexpr int ELEMS16 = 16 / sizeof(T);  // x elements in a 16-byte chunk
  constexpr int QV = BK / 16;              // 16-column weight units per thread and K tile
  constexpr int kAhead = Cfg<T>::kAhead;

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;  // shared-window address of the ring
  uint8_t* const ring_ptr = smem_raw + (ring - raw);

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int n_tiles = (K + BK - 1) / BK;

  // x tile t -> stage s: 128 rows x 8 chunks of 16 bytes, 4 chunks a thread.
  auto load_x = [&](int t, int s) {
    const int k0 = t * BK;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = tid + j * kThreads;
      const int row = i >> 3, c = i & 7;
      const int k = k0 + c * ELEMS16;
      const int valid = (m0 + row < M) ? min(max(K - k, 0), ELEMS16) : 0;  // elements to copy
      const uint32_t off = kF32 ? row * XROW + c * 16 : swizzle128(row * 128 + c * 16);
      const T* src = x + (long long)(m0 + row) * lda + k;
      if (x_vec) {
        cp_async16(ring + s * STAGE + off, valid > 0 ? src : x, valid * (int)sizeof(T));
      } else {
        T* dst = reinterpret_cast<T*>(ring_ptr + s * STAGE + off);
#pragma unroll
        for (int e = 0; e < ELEMS16; ++e) dst[e] = e < valid ? src[e] : from_f32<T>(0.f);
      }
    }
  };

  // Weight tile t: thread's units are 16 columns of one k-row each.
  uint4 qreg[QV];
  auto load_q = [&](int t) {
    const int k0 = t * BK;
#pragma unroll
    for (int j = 0; j < QV; ++j) {
      const int u = tid + j * kThreads;
      const int k = k0 + (u >> 4), n = n0 + (u & 15) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < K && n < N) {
        const int8_t* src = q + (long long)k * N + n;
        if (q_vec) {
          v = *reinterpret_cast<const uint4*>(src);
        } else {
          uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int e = 0; e < 16; ++e)
            if (n + e < N) w[e >> 2] |= (uint32_t)(uint8_t)src[e] << (8 * (e & 3));
          v = make_uint4(w[0], w[1], w[2], w[3]);
        }
      }
      qreg[j] = v;
    }
  };
  auto store_q = [&](int s) {
    uint8_t* bs = ring_ptr + s * STAGE + X_TILE;
#pragma unroll
    for (int j = 0; j < QV; ++j) {
      const int u = tid + j * kThreads;
      const int krow = u >> 4, n16 = (u & 15) * 16;
      uint32_t h[8];
      int8x4_to_bf16x4(qreg[j].x, h[0], h[1]);
      int8x4_to_bf16x4(qreg[j].y, h[2], h[3]);
      int8x4_to_bf16x4(qreg[j].z, h[4], h[5]);
      int8x4_to_bf16x4(qreg[j].w, h[6], h[7]);
      uint8_t* panel = bs + (n16 >> 6) * PANEL;
      const uint32_t off = krow * 128 + ((n16 & 63) >> 3) * 16;
      // lanes 4-7 of each 8 write their second chunk first: the panels of
      // lanes 0-3 and 4-7 lie on the same banks
      const uint4 c0 = make_uint4(h[0], h[1], h[2], h[3]), c1 = make_uint4(h[4], h[5], h[6], h[7]);
      const bool flip = (u & 4) != 0;
      *reinterpret_cast<uint4*>(panel + swizzle128(flip ? off + 16 : off)) = flip ? c1 : c0;
      *reinterpret_cast<uint4*>(panel + swizzle128(flip ? off : off + 16)) = flip ? c0 : c1;
    }
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;

  for (int t = 0; t < kAhead; ++t) {
    if (t < n_tiles) {
      load_x(t, t);
      load_q(t);
      store_q(t);
    }
    cp_async_commit();
  }
  if (kAhead < n_tiles) load_q(kAhead);  // in registers until the first iteration stores it

  // Row of this thread's fragments within the block's tile.
  const int frag_row = wg * 64 + warp * 16 + (lane >> 2);

  // One K tile per iteration: issue its wgmmas, then, while they run, start the
  // copies of x tile t + kAhead, convert and store that tile's weights (in
  // registers since the iteration before) and load the next tile's.
  // bf16 x: the tile's wgmmas stay in flight across the barrier; the loop waits
  // only for the tile before, so a stage is written two tiles after its
  // readers were issued.  float32 x: one wgmma group per k16 step, each with
  // its own split A fragments a[kk], so step 1 is split while step 0 runs; the
  // fragments are registers that wgmma reads asynchronously, and ptxas
  // serializes every wgmma unless all groups are waited for before any of them
  // is rewritten, so this path waits for the whole tile.
  uint32_t a[kF32 ? BK / 16 : 1][3][4];
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kAhead - 1>();  // this thread's copies of tile t have landed
    fence_proxy_async();
    __syncthreads();  // tile t is complete; every warpgroup is done with the stage written next
    const int s = t % kStages;
    const int tn = t + kAhead;
    const bool more = tn < n_tiles;

    const uint32_t xs = ring + s * STAGE;
    const uint32_t bs = xs + X_TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      // The weight tile is an MN-major B: 16 k-rows (two 8-row groups) a step;
      // the leading byte offset steps to the next panel of 64 columns.
      const uint64_t b_desc = make_desc(bs + kk * 2048, PANEL, 1024, kLayoutSw128);
      if constexpr (kF32) {
        const uint8_t* xt = ring_ptr + s * STAGE;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          // r = 0: (row, k), 1: (row + 8, k), 2: (row, k + 8), 3: (row + 8, k + 8)
          const int row = frag_row + (r & 1) * 8;
          const int col = kk * 16 + (lane & 3) * 2 + (r >> 1) * 8;
          const float2 v = *reinterpret_cast<const float2*>(xt + row * XROW + col * 4);
          split_bf16x3(v, a[kk][2][r], a[kk][1][r], a[kk][0][r]);
        }
        wgmma_fence();
#pragma unroll
        for (int piece = 0; piece < 3; ++piece)  // lo, mid, hi
          Wgmma<kBN, 1>::rs(acc, a[kk][piece], b_desc, 1);
        wgmma_commit();
      } else {
        if (kk == 0) wgmma_fence();
        const uint64_t a_desc = make_desc(xs + wg * (64 * 128) + kk * 32, 16, 1024, kLayoutSw128);
        Wgmma<kBN, 1>::ss(acc, a_desc, b_desc, 1);
        if (kk + 1 == BK / 16) wgmma_commit();
      }
    }
    if (more) {
      load_x(tn, tn % kStages);
      store_q(tn % kStages);
      if (tn + 1 < n_tiles) load_q(tn + 1);
    }
    cp_async_commit();
    if constexpr (kF32) {
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int piece = 0; piece < 3; ++piece) keep_all(a[kk][piece]);
    } else {
      wgmma_wait<1>();  // only the newest group still runs
    }
  }
  cp_async_wait<0>();
  wgmma_wait<0>();
  keep_all(acc);
  if constexpr (kF32) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int piece = 0; piece < 3; ++piece) keep_all(a[kk][piece]);
  }
  __syncthreads();  // every warpgroup is done with the ring: it now holds the output tile

  // Epilogue: acc[4 j + 2 h + e] is (frag_row + 8 h, column 8 j + 2 (lane % 4) + e).
  // Scale, cast and go through shared memory, so that rows leave in 16-byte
  // stores.  The row stride's extra 32 (16) bytes keep the fragment writes of
  // a warp's 8 rows on different banks.
  constexpr int OROW = kBN * (int)sizeof(T) + (kF32 ? 32 : 16);
  static_assert(kBM * OROW <= kStages * STAGE, "the output tile must fit in the ring");
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = 8 * j + (lane & 3) * 2;
    const float s0 = n0 + col < N ? scale[n0 + col] : 0.f;
    const float s1 = n0 + col + 1 < N ? scale[n0 + col + 1] : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      store2(reinterpret_cast<T*>(ring_ptr + (frag_row + 8 * h) * OROW) + col,
             acc[4 * j + 2 * h] * s0, acc[4 * j + 2 * h + 1] * s1);
    }
  }
  __syncthreads();
  constexpr int CH = kBN / ELEMS16;  // 16-byte chunks of an output row
  for (int i = tid; i < kBM * CH; i += kThreads) {
    const int r = i / CH, col = (i % CH) * ELEMS16;
    if (m0 + r >= M || n0 + col >= N) continue;
    const T* src = reinterpret_cast<const T*>(ring_ptr + r * OROW) + col;
    T* dst = out + (long long)(m0 + r) * N + n0 + col;
    if (out_vec) {
      *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
    } else {
#pragma unroll
      for (int e = 0; e < ELEMS16; ++e)
        if (n0 + col + e < N) dst[e] = src[e];
    }
  }
}

template <typename T>
cudaError_t launch(const void* x, const int8_t* q, const float* scale, void* out, int M, int N,
                   int K, long long lda, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(int8_matmul_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes<T>());
  if (err != cudaSuccess) return err;
  const int x_vec = (reinterpret_cast<uintptr_t>(x) % 16 == 0) && ((lda * (long long)sizeof(T)) % 16 == 0);
  const int q_vec = (reinterpret_cast<uintptr_t>(q) % 16 == 0) && (N % 16 == 0);
  // then a 16-byte chunk of an output row is inside N or outside it, never across
  const int out_vec = (reinterpret_cast<uintptr_t>(out) % 16 == 0) && ((N * (long long)sizeof(T)) % 16 == 0);
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  int8_matmul_kernel<T><<<grid, kThreads, smem_bytes<T>(), stream>>>(
      static_cast<const T*>(x), q, scale, static_cast<T*>(out), M, N, K, lda, x_vec, q_vec, out_vec);
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
