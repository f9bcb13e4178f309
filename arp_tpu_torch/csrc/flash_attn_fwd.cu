// FlashAttention forward (kernel K1) for Hopper, sm_90a.
//
// Replaces the TPU kernel arp_tpu/ops/attention.py::_flash_kernel (wrapper
// _pallas_attention): softmax(q k^T * D^-0.5) v with an fp32 online softmax,
// the MaskSpec (none, causal, dt) evaluated from indices, optional key
// padding, and block-level early exit for causal and dt.  Unlike the TPU
// kernel it reads q/k/v in the caller's (B, N, H, D) layout through strides
// and masks the ragged tail itself instead of copying N up to 128.
//
// What bounds it on an H100: the function reads Q, K and V once and writes O
// once, four tensors of B N H D elements.  At the CLIP ViT-B/16 shape (256,
// 197, 12, 64) that is 310 MB in bf16, 0.093 ms at 3.35 TB/s (620 MB, 0.185
// ms in float32), against 30.5 GFLOP, 0.031 ms at the 989 TFLOP/s bf16
// tensor-core peak: bytes bound the bf16 path.  float32 inputs need float32
// products, 0.46 ms at the 67 TFLOP/s SIMT peak: operations bound that path.
// Measured on an H100 80GB HBM3 at a 700 W limit: bf16 0.25 ms (the first
// version of this kernel, fp32 FMAs for both dtypes: 2.53 ms), float32 2.4 ms.
//
// Two bodies, chosen by dtype:
//
//  * bfloat16 (flash_fwd_wgmma_kernel): tensor cores.  A block of two
//    warpgroups takes 128 query rows of one (batch, head), each warpgroup 64;
//    the query tiles of a head are neighbours in the grid, so the second one
//    finds the head's K and V in L2.  Q, and K and V in 64-key tiles through a
//    three-stage ring, arrive in bf16 by cp.async (16 bytes a thread, rows
//    past n zero-filled) into swizzled shared memory, so the next tiles load
//    while this one is multiplied.  S = Q K^T is wgmma m64n64k16 with both
//    operands from shared memory; the scores stay in the accumulator
//    registers, where scale, mask and the fp32 online softmax run (row max
//    and sum by shuffles within the quad; where a tile needs no mask the
//    scale folds into the exponent's FMA); P is rounded to bf16 in registers
//    and is the A operand of O += P V, with V read from shared memory as an
//    MN-major B operand (no transpose).  A short last tile takes 32- or
//    16-key products.  No score tile touches shared memory; one
//    __syncthreads() a key tile.  O / l leaves through the Q tile's shared
//    memory in 16-byte stores.  What still holds it back: each warpgroup
//    waits for its own wgmmas before its softmax and after (four chains an
//    SM, none overlapping its products with its exponentials), and 197 rows
//    and keys fill 64-wide tiles to 81% and 77%.
//  * float32 (flash_fwd_simt_kernel): the SIMT body.  One bf16 or TF32 pass
//    does not hold the float32 bound of 1e-4 against the plain version, so
//    every product stays an fp32 FMA: one block of 256 threads per 64-query
//    tile, Q, K and V tiles read four values a thread into padded shared
//    memory, a 4x4 block of scores a thread through a shared score tile.
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

#include "wgmma.cuh"

namespace {

using namespace arp;

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

// arp_tpu/ops/masks.py::mask_allowed
__device__ __forceinline__ bool mask_allowed(int kind, int q, int k, int num_obs, int per_step) {
  if (kind == kMaskNone) return true;
  const bool causal = k <= q;
  if (kind == kMaskCausal) return causal;
  const bool same_step = (q / per_step) == (k / per_step);
  const bool both_obs = (q % per_step) < num_obs && (k % per_step) < num_obs;
  return causal || (same_step && both_obs);
}

// float32 rows [row0, row0 + 64) of one head into shared memory, row stride
// D + 1 (the pad keeps column reads free of bank conflicts).  Rows past n are
// zero, so they add nothing to P V.  `vec`: rows start on 16-byte boundaries,
// so a thread reads four values at once.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* base, long long row_stride,
                                          int row0, int n, bool vec) {
  for (int i = threadIdx.x; i < 64 * (D / 4); i += kThreads) {
    const int r = i / (D / 4), d = (i % (D / 4)) * 4;
    const int row = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n) {
      const float* src = base + (long long)row * row_stride + d;
      if (vec) {
        v = *reinterpret_cast<const float4*>(src);
      } else {
        v = make_float4(src[0], src[1], src[2], src[3]);
      }
    }
    float* out = dst + r * (D + 1) + d;
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
}

template <int D>
constexpr int smem_floats() {
  return 3 * 64 * (D + 1) + kBlockQ * (kBlockK + 1) + 3 * kBlockQ;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_simt_kernel(Params p, int vec) {
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

  const float* qg = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  float* og = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const uint8_t* pad = p.kv_pad ? p.kv_pad + (long long)b * n : nullptr;

  load_tile<D>(qs, qg, p.q_sn, q0, n, vec);
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
    load_tile<D>(ks, kg, p.k_sn, k0, n, vec);
    load_tile<D>(vs, vg, p.v_sn, k0, n, vec);
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
    float* orow = og + (long long)qi * p.o_sn;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[tx + 16 * j] = acc[i][j] * inv_l;
  }
}

// ---- bfloat16: the tensor-core body -----------------------------------------

constexpr int kTcBlockQ = 128;  // two warpgroups x 64 query rows
constexpr int kTcBlockK = 64;   // keys a tile
constexpr int kTcStages = 3;    // K/V tiles in the ring

// Shared-memory geometry of an (R rows x D bf16) tile: panels of at most 64
// columns, each R rows of kRow bytes, swizzled (wgmma.cuh).  D = 16 (the
// policy blocks: 128 wide, 8 heads) has 32-byte rows: one k16 step in Q K^T
// and an n16 tile in P V.
template <int D>
struct TcGeom {
  static constexpr int kRow = D * 2 < 128 ? D * 2 : 128;
  static constexpr uint32_t kLayout = kRow == 128 ? kLayoutSw128 : kRow == 64 ? kLayoutSw64 : kLayoutSw32;
  static constexpr int kAtom = 8 * kRow;  // eight rows: the descriptors' stride byte offset
  static constexpr int kQBytes = kTcBlockQ * D * 2;
  static constexpr int kKvBytes = kTcBlockK * D * 2;  // one of K, V
  static constexpr int kSmem = kQBytes + kTcStages * 2 * kKvBytes + 1024;  // + room to align to 1024
  static __device__ __forceinline__ uint32_t swz(uint32_t off) {
    return kRow == 128 ? swizzle128(off) : kRow == 64 ? swizzle64(off) : swizzle32(off);
  }
};

// Byte offset of (row, byte b of the row) in a swizzled tile of R rows.
template <int D, int R>
__device__ __forceinline__ uint32_t tile_offset(int row, int b) {
  using G = TcGeom<D>;
  return (b / G::kRow) * (R * G::kRow) + G::swz(row * G::kRow + b % G::kRow);
}

// Rows [row0, row0 + R) of one head into a swizzled tile, 16 bytes a copy;
// rows past n become zeros, so they add nothing to P V.  `vec`: every row
// starts on a 16-byte boundary (else the copy goes element by element).
template <int D, int R>
__device__ __forceinline__ void load_tile_bf16(uint32_t tile, uint8_t* tile_ptr,
                                               const __nv_bfloat16* base, long long row_stride,
                                               int row0, int n, bool vec) {
  using G = TcGeom<D>;
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks, cb = (i % kChunks) * 16;
    const uint32_t off = tile_offset<D, R>(r, cb);
    const bool live = row0 + r < n;
    const __nv_bfloat16* src = base + (long long)(row0 + r) * row_stride + cb / 2;
    if (vec) {
      cp_async16(tile + off, live ? src : base, live ? 16 : 0);
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (live) {
        const uint16_t* s16 = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
        for (int e = 0; e < 4; ++e) w[e] = (uint32_t)s16[2 * e] | ((uint32_t)s16[2 * e + 1] << 16);
      }
      *reinterpret_cast<uint4*>(tile_ptr + off) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

__device__ __forceinline__ float fast_exp2(float x) {  // 2^x; -inf and very negative x give 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One tile of KN keys (k0 ...) for one warpgroup's 64 query rows: S = Q K^T in
// registers, scale, mask, online softmax, O += P V.  sc[4 j + 2 hh + e] is
// (row qi0 + 8 hh, key k0 + 8 j + 2 (lane % 4) + e), o[] the same over head
// dims.  MASKED = false: every key of the tile is below n and allowed, so the
// scale folds into the exponent's FMA and no index is computed.
template <int D, int KN, bool MASKED>
__device__ __forceinline__ void attend_tile(const Params& p, const uint8_t* pad, uint32_t q_rows,
                                            uint32_t k_tile, uint32_t v_tile, int qi0, int k0,
                                            int lane, float scale_log2, float (&row_m)[2],
                                            float (&row_l)[2], float (&o)[D / 2]) {
  using G = TcGeom<D>;
  float sc[KN / 2];
#pragma unroll
  for (int i = 0; i < KN / 2; ++i) sc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t panel = (kk * 32) / G::kRow, inb = (kk * 32) % G::kRow;
    const uint64_t a_desc =
        make_desc(q_rows + panel * (kTcBlockQ * G::kRow) + inb, 16, G::kAtom, G::kLayout);
    const uint64_t b_desc =
        make_desc(k_tile + panel * (kTcBlockK * G::kRow) + inb, 16, G::kAtom, G::kLayout);
    Wgmma<KN, 0>::ss(sc, a_desc, b_desc, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  keep_all(sc);

  const int n = p.n;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float mx = -INFINITY;
    if constexpr (MASKED) {
      const int qi = qi0 + 8 * hh;
#pragma unroll
      for (int j = 0; j < KN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * hh + e;
          const int kj = k0 + 8 * j + 2 * (lane & 3) + e;
          float val = sc[idx] * scale_log2;  // in units of log 2: the exponential is ex2
          if (kj >= n) {
            val = -INFINITY;  // past the end: weight exactly 0
          } else if (!mask_allowed(p.mask_kind, qi, kj, p.num_obs_token, p.num_token_per_step) ||
                     (pad != nullptr && pad[kj] != 0)) {
            val = kBigNeg;
          }
          sc[idx] = val;
          mx = fmaxf(mx, val);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < KN / 8; ++j) {
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * hh], sc[4 * j + 2 * hh + 1]));
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    if constexpr (!MASKED) mx *= scale_log2;  // the scale is positive: max and scale commute
    const float m_new = fmaxf(row_m[hh], mx);  // finite: every tile has a key < n
    const float alpha = fast_exp2(row_m[hh] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int idx = 4 * j + 2 * hh + e;
        const float pv = MASKED ? fast_exp2(sc[idx] - m_new) : fast_exp2(fmaf(sc[idx], scale_log2, -m_new));
        sc[idx] = pv;
        sum += pv;
      }
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    row_l[hh] = row_l[hh] * alpha + sum;
    row_m[hh] = m_new;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j + 2 * hh] *= alpha;
      o[4 * j + 2 * hh + 1] *= alpha;
    }
  }

  // P, rounded to bf16, is the A operand of O += P V: the accumulator
  // fragment of 16 keys is the m16k16 A fragment of the same thread.
  uint32_t pa[KN / 16][4];
#pragma unroll
  for (int ks = 0; ks < KN / 16; ++ks) {
#pragma unroll
    for (int r = 0; r < 4; ++r) pa[ks][r] = pack_bf16x2(sc[8 * ks + 2 * r], sc[8 * ks + 2 * r + 1]);
  }
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < KN / 16; ++ks) {
    // V tile rows are keys: an MN-major B, 16 keys (two 8-row groups) a step;
    // the leading byte offset steps to the next panel of 64 head dims.
    const uint64_t b_desc =
        make_desc(v_tile + ks * 16 * G::kRow, kTcBlockK * G::kRow, G::kAtom, G::kLayout);
    Wgmma<D, 1>::rs(o, pa[ks], b_desc, 1);
  }
  wgmma_commit();
  wgmma_wait<0>();
  keep_all(o);
#pragma unroll
  for (int ks = 0; ks < KN / 16; ++ks) keep_all(pa[ks]);
}

template <int D>
__global__ void __launch_bounds__(kThreads, D == 128 ? 1 : 2)
flash_fwd_wgmma_kernel(Params p, int vec) {
  using G = TcGeom<D>;
  using bf16 = __nv_bfloat16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_tile = (raw + 1023u) & ~1023u;  // shared-window addresses
  const uint32_t kv_ring = q_tile + G::kQBytes;
  uint8_t* const q_ptr = smem_raw + (q_tile - raw);
  uint8_t* const kv_ptr = q_ptr + G::kQBytes;

  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int n = p.n;
  // The query tiles of one head are neighbours in the grid, so that they run
  // together and the later ones find the head's K and V in L2.
  const int q_tiles = (n + kTcBlockQ - 1) / kTcBlockQ;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int q0 = (blockIdx.x % q_tiles) * kTcBlockQ;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.k_sb + h * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.v_sb + h * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
  const uint8_t* pad = p.kv_pad ? p.kv_pad + (long long)b * n : nullptr;

  const int n_tiles = (n + kTcBlockK - 1) / kTcBlockK;
  // Key tiles that can hold an allowed key for this query tile.
  int live_tiles = n_tiles;
  if (p.mask_kind == kMaskCausal) {
    live_tiles = min(n_tiles, (q0 + kTcBlockQ + kTcBlockK - 1) / kTcBlockK);
  } else if (p.mask_kind == kMaskDt) {
    live_tiles = min(n_tiles, (q0 + kTcBlockQ + p.num_token_per_step + kTcBlockK - 1) / kTcBlockK);
  }

  auto load_kv = [&](int kt) {
    const int s = (kt % kTcStages) * 2 * G::kKvBytes;
    load_tile_bf16<D, kTcBlockK>(kv_ring + s, kv_ptr + s, kg, p.k_sn, kt * kTcBlockK, n, vec);
    load_tile_bf16<D, kTcBlockK>(kv_ring + s + G::kKvBytes, kv_ptr + s + G::kKvBytes, vg, p.v_sn,
                                 kt * kTcBlockK, n, vec);
  };
  load_tile_bf16<D, kTcBlockQ>(q_tile, q_ptr, qg, p.q_sn, q0, n, vec);
  for (int kt = 0; kt < kTcStages - 1; ++kt) {
    if (kt < n_tiles) load_kv(kt);
    cp_async_commit();
  }

  // This thread's rows of the warpgroup's 64 x N fragments: row_in_tile and + 8.
  const int row_in_tile = wg * 64 + warp * 16 + (lane >> 2);
  const int qi0 = q0 + row_in_tile;
  const bool wg_active = q0 + wg * 64 < n;  // a warpgroup with no row below n only helps to load
  const bool masked = p.mask_kind != kMaskNone || pad != nullptr;
  const float scale_log2 = p.scale * 1.4426950408889634f;
  const uint32_t q_rows = q_tile + wg * (64 * G::kRow);
  float row_m[2] = {-INFINITY, -INFINITY};
  float row_l[2] = {0.f, 0.f};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    if (kt == live_tiles) {
      // Early exit, unless a row has seen only masked keys: its answer is the
      // mean of V over all n keys, so it needs the rest of them.
      const bool dead = (qi0 < n && row_m[0] <= kBigNeg) || (qi0 + 8 < n && row_m[1] <= kBigNeg);
      if (!__syncthreads_or(dead)) break;
    }
    cp_async_wait<kTcStages - 2>();  // this thread's copies of tile kt have landed
    fence_proxy_async();
    __syncthreads();  // tile kt is complete; both warpgroups are done with tile kt - 1
    if (kt + kTcStages - 1 < n_tiles) load_kv(kt + kTcStages - 1);
    cp_async_commit();
    if (!wg_active) continue;

    const uint32_t k_tile = kv_ring + (kt % kTcStages) * 2 * G::kKvBytes;
    const uint32_t v_tile = k_tile + G::kKvBytes;
    const int k0 = kt * kTcBlockK;
    const int rem = n - k0;  // keys left; a short last tile takes narrower products
    if (rem >= kTcBlockK && !masked) {
      attend_tile<D, 64, false>(p, pad, q_rows, k_tile, v_tile, qi0, k0, lane, scale_log2, row_m, row_l, o);
    } else if (rem > 32) {
      attend_tile<D, 64, true>(p, pad, q_rows, k_tile, v_tile, qi0, k0, lane, scale_log2, row_m, row_l, o);
    } else if (rem > 16) {
      attend_tile<D, 32, true>(p, pad, q_rows, k_tile, v_tile, qi0, k0, lane, scale_log2, row_m, row_l, o);
    } else {
      attend_tile<D, 16, true>(p, pad, q_rows, k_tile, v_tile, qi0, k0, lane, scale_log2, row_m, row_l, o);
    }
  }
  cp_async_wait<0>();

  // O / l through shared memory (this warpgroup's rows of the Q tile, whose
  // products are done), so that a row leaves in 16-byte stores.
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float inv_l = 1.f / row_l[hh];  // l >= 1 for a row below n: its max contributes 2^0
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<uint32_t*>(q_ptr + tile_offset<D, kTcBlockQ>(row_in_tile + 8 * hh,
                                                                      16 * j + 4 * (lane & 3))) =
          pack_bf16x2(o[4 * j + 2 * hh] * inv_l, o[4 * j + 2 * hh + 1] * inv_l);
    }
  }
  __syncthreads();
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
  for (int i = tid; i < kTcBlockQ * kChunks; i += kThreads) {
    const int r = i / kChunks, cb = (i % kChunks) * 16;
    if (q0 + r >= n) continue;
    *reinterpret_cast<uint4*>(og + (long long)(q0 + r) * p.o_sn + cb / 2) =
        *reinterpret_cast<const uint4*>(q_ptr + tile_offset<D, kTcBlockQ>(r, cb));
  }
}

// Every row of q, k and v starts on a 16-byte boundary (strides in elements of `elem` bytes).
bool rows_aligned(const Params& p, int elem) {
  auto aligned = [elem](const void* ptr, long long sb, long long sn, long long sh) {
    return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (sb * elem) % 16 == 0 &&
           (sn * elem) % 16 == 0 && (sh * elem) % 16 == 0;
  };
  return aligned(p.q, p.q_sb, p.q_sn, p.q_sh) && aligned(p.k, p.k_sb, p.k_sn, p.k_sh) &&
         aligned(p.v, p.v_sb, p.v_sn, p.v_sh);
}

template <int D>
cudaError_t launch_simt(const Params& p, int batch_heads, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_simt_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch_heads, (p.n + kBlockQ - 1) / kBlockQ);
  flash_fwd_simt_kernel<D><<<grid, kThreads, smem, stream>>>(p, rows_aligned(p, 4));
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_wgmma(const Params& p, int batch_heads, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, TcGeom<D>::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)batch_heads * ((p.n + kTcBlockQ - 1) / kTcBlockQ);
  if (blocks > 2147483647LL) return cudaErrorInvalidValue;
  flash_fwd_wgmma_kernel<D><<<(unsigned)blocks, kThreads, TcGeom<D>::kSmem, stream>>>(p, rows_aligned(p, 2));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const Params& p, int head_dim, int batch_heads, cudaStream_t stream) {
  constexpr bool kF32 = sizeof(T) == 4;
  switch (head_dim) {
    case 16: return kF32 ? launch_simt<16>(p, batch_heads, stream) : launch_wgmma<16>(p, batch_heads, stream);
    case 32: return kF32 ? launch_simt<32>(p, batch_heads, stream) : launch_wgmma<32>(p, batch_heads, stream);
    case 64: return kF32 ? launch_simt<64>(p, batch_heads, stream) : launch_wgmma<64>(p, batch_heads, stream);
    case 128: return kF32 ? launch_simt<128>(p, batch_heads, stream) : launch_wgmma<128>(p, batch_heads, stream);
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
