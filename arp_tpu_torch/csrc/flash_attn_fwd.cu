// FlashAttention forward (kernel K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel arp_tpu/ops/attention.py::_flash_kernel (wrapper
// _pallas_attention): softmax(q k^T * D^-0.5) v with an fp32 online softmax,
// the MaskSpec (none, causal, dt) evaluated from indices, optional key
// padding, and block-level early exit for causal and dt.  Unlike the TPU
// kernel it reads q/k/v in the caller's (B, N, H, D) layout through strides
// and masks the ragged tail itself instead of copying N up to 128.
//
// What bounds it on an H100: at the CLIP shapes (N <= 197, D = 64) a block's
// whole score tile lives in shared memory and registers, so the only traffic
// to device memory is reading Q, K and V and writing O: at B = 256, H = 12 in
// fp32 about 1.5 GB (K and V are read once per 64-query tile), 0.46 ms at
// 3.35 TB/s.  This first version computes in fp32 on the SIMT cores over
// padded 64x64 tiles, 51.5 GFLOP there, at least 0.77 ms at the 67 TFLOP/s
// fp32 peak, so the FMAs bound it rather than the bytes: measured 2.52 ms on
// an H100 80GB HBM3 at a 700 W power limit.  Tensor-core tiles (wgmma) and
// TMA loads are later work.
//
// Design: one block of 256 threads per (batch*head, 64-query tile).  The
// block converts its Q tile to fp32 in shared memory, then streams K and V in
// 64-key tiles.  Per tile: every thread computes a 4x4 block of scores into a
// shared score tile, 4 threads per query row update the running max / sum and
// turn scores into probabilities, and every thread accumulates a 4 x D/16
// block of the output in registers.
//
// A query row whose keys are all masked gets the mean of V over all n keys,
// as arp_tpu/ops/attention.py::_xla_attention gives (the -1e30 fill makes
// the softmax uniform).  For causal and dt the early exit would cut that mean
// short, so a block that still has such a row scans every key tile.
//
// Plain C entry point (bound with ctypes): arp_flash_attn_fwd returns the
// cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;
constexpr float kBigNeg = -1e30f;  // the fill of masked scores, as in the JAX code

enum MaskKind { kMaskNone = 0, kMaskCausal = 1, kMaskDt = 2 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const uint8_t* kv_pad;  // (B, n), nonzero = pad; may be null
  void* o;
  int n, heads;
  long long q_sb, q_sn, q_sh;
  long long k_sb, k_sn, k_sh;
  long long v_sb, v_sn, v_sh;
  long long o_sb, o_sn, o_sh;
  int mask_kind, num_obs_token, num_token_per_step;
  float scale;
};

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

// arp_tpu/ops/masks.py::mask_allowed
__device__ __forceinline__ bool mask_allowed(int kind, int q, int k, int num_obs, int per_step) {
  if (kind == kMaskNone) return true;
  const bool causal = k <= q;
  if (kind == kMaskCausal) return causal;
  const bool same_step = (q / per_step) == (k / per_step);
  const bool both_obs = (q % per_step) < num_obs && (k % per_step) < num_obs;
  return causal || (same_step && both_obs);
}

// Rows [row0, row0 + 64) of one head into shared memory as fp32, row stride
// D + 1 (the pad keeps column reads free of bank conflicts).  Rows past n are
// zero, so they add nothing to P V.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, long long row_stride,
                                          int row0, int n) {
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = row0 + r;
    dst[r * (D + 1) + d] = row < n ? to_f32(base[(long long)row * row_stride + d]) : 0.f;
  }
}

template <int D>
constexpr int smem_floats() {
  return 3 * 64 * (D + 1) + kBlockQ * (kBlockK + 1) + 3 * kBlockQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Params p) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int LD = D + 1;        // row stride of the Q, K and V tiles
  constexpr int LS = kBlockK + 1;  // row stride of the score tile
  constexpr int DJ = D / 16;       // output columns per thread

  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kBlockQ * LD;
  float* vs = ks + kBlockK * LD;
  float* ss = vs + kBlockK * LD;
  float* row_m = ss + kBlockQ * LS;
  float* row_l = row_m + kBlockQ;
  float* row_alpha = row_l + kBlockQ;

  const int tid = threadIdx.x;
  const int n = p.n;
  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int q0 = blockIdx.y * kBlockQ;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  const uint8_t* pad = p.kv_pad ? p.kv_pad + (long long)b * n : nullptr;

  load_tile<T, D>(qs, qg, p.q_sn, q0, n);
  if (tid < kBlockQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  const int n_tiles = (n + kBlockK - 1) / kBlockK;
  // Key tiles that can hold an allowed key for this query tile.
  int live_tiles = n_tiles;
  if (p.mask_kind == kMaskCausal) {
    live_tiles = min(n_tiles, (q0 + kBlockQ + kBlockK - 1) / kBlockK);
  } else if (p.mask_kind == kMaskDt) {
    live_tiles = min(n_tiles, (q0 + kBlockQ + p.num_token_per_step + kBlockK - 1) / kBlockK);
  }

  // Micro-tile of this thread: rows ty + 16 i; score columns / head dims tx + 16 j.
  const int tx = tid % 16, ty = tid / 16;
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt == live_tiles) {
      // Early exit, unless a row has seen only masked keys: its answer is the
      // mean of V over all n keys, so it needs the rest of them.
      const bool dead = tid < kBlockQ && q0 + tid < n && row_m[tid] <= kBigNeg;
      if (!__syncthreads_or(dead)) break;
    }
    const int k0 = kt * kBlockK;
    load_tile<T, D>(ks, kg, p.k_sn, k0, n);
    load_tile<T, D>(vs, vg, p.v_sn, k0, n);
    __syncthreads();

    // Scores: s = scale * q . k, masked.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k0 + tx + 16 * j;
        float val;
        if (kj >= n) {
          val = -INFINITY;  // past the end: weight exactly 0
        } else if (!mask_allowed(p.mask_kind, qi, kj, p.num_obs_token, p.num_token_per_step) ||
                   (pad != nullptr && pad[kj] != 0)) {
          val = kBigNeg;
        } else {
          val = s[i][j] * p.scale;
        }
        ss[(ty + 16 * i) * LS + tx + 16 * j] = val;
      }
    }
    __syncthreads();

    // Online softmax, 4 neighbouring lanes per row.
    {
      const int r = tid / 4, sub = tid % 4;
      float* srow = ss + r * LS;
      float mx = -INFINITY;
      for (int c = sub; c < kBlockK; c += 4) mx = fmaxf(mx, srow[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);  // finite: every tile has a key < n
      float sum = 0.f;
      for (int c = sub; c < kBlockK; c += 4) {
        const float e = expf(srow[c] - m_new);
        srow[c] = e;
        sum += e;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (sub == 0) {
        const float alpha = expf(m_old - m_new);
        row_alpha[r] = alpha;
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + sum;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = row_alpha[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= a;
    }
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ss[(ty + 16 * i) * LS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
    __syncthreads();  // before the next tile overwrites ks, vs and ss
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int qi = q0 + r;
    if (qi >= n) continue;
    const float inv_l = 1.f / row_l[r];  // l >= 1: the row max contributes exp(0)
    T* orow = og + (long long)qi * p.o_sn;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = from_f32<T>(acc[i][j] * inv_l);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int batch_heads, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch_heads, (p.n + kBlockQ - 1) / kBlockQ);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const Params& p, int head_dim, int batch_heads, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(p, batch_heads, stream);
    case 64: return launch<T, 64>(p, batch_heads, stream);
    case 128: return launch<T, 128>(p, batch_heads, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements.  mask_kind:
// 0 none, 1 causal, 2 dt.  Returns the launch's cudaError_t (0 = success).
extern "C" int arp_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  const void* kv_pad, void* o, int dtype, int batch, int n,
                                  int heads, int head_dim, long long q_sb, long long q_sn,
                                  long long q_sh, long long k_sb, long long k_sn, long long k_sh,
                                  long long v_sb, long long v_sn, long long v_sh, long long o_sb,
                                  long long o_sn, long long o_sh, int mask_kind,
                                  int num_obs_token, int num_token_per_step, float scale,
                                  void* stream) {
  if (batch <= 0 || n <= 0 || heads <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.kv_pad = static_cast<const uint8_t*>(kv_pad);
  p.o = o;
  p.n = n;
  p.heads = heads;
  p.q_sb = q_sb; p.q_sn = q_sn; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_sn = k_sn; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_sn = v_sn; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_sn = o_sn; p.o_sh = o_sh;
  p.mask_kind = mask_kind;
  p.num_obs_token = num_obs_token;
  p.num_token_per_step = num_token_per_step;
  p.scale = scale;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int batch_heads = batch * heads;
  cudaError_t err;
  if (dtype == 0) {
    err = dispatch_head_dim<float>(p, head_dim, batch_heads, s);
  } else if (dtype == 1) {
    err = dispatch_head_dim<__nv_bfloat16>(p, head_dim, batch_heads, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
