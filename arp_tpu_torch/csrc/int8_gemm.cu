// Static-scale w8a8 GEMM with a fused epilogue (kernel K2) for Hopper, sm_90a.
//
// Replaces the TPU kernel arp_tpu/ops/vit_infer.py::fused_int8_matmul (body
// `kern`): x (M, K) float32 or bfloat16 is quantized on the fly with the
// static activation scale a, q = clip(rint(x * 127/a), -127, 127), multiplied
// by the int8 weight as int8 x int8 -> int32 over the whole K, and the
// epilogue writes bf16(acc * (ws[n] * (a/127)) + bias[n]), with an optional
// quick-GELU v / (1 + exp(-1.702 v)) in float32 before the one rounding.  The
// int8 copy of x never reaches device memory, as in the TPU kernel.
//
// What bounds it on an H100 (ViT-B/16 at batch 256, M = 50,432 rows): the
// 768 -> 3072 and 3072 -> 768 sites are 0.24 TOP each, 0.12 ms at the card's
// 1,979 TOP/s of int8, a little more than their bytes (0.39 GB at 3.35 TB/s):
// operations bound them.  The 768 -> 2304 and 768 -> 768 sites are bound by
// their bytes.  Behind those two sit the limits of one SM, which decide the
// design.  (1) Shared memory is filled from L2 and read by everyone: a
// 128 x 256 x 64 step reads 40 KB of operands for its two wgmma pairs, takes
// 16 KB of weight from L2, and, where x must be quantized for this step too,
// 16 KB of raw x in, 16 KB out to the converter and 8 KB of int8 back: 96 KB
// against the 64 KB that 512 tensor-core clocks leave at 128 bytes a clock.
// (2) Quantizing x costs about four instructions an element on warps that
// have one issue slot a clock; done again for every column tile it takes as
// long as the products.  (3) An SM hands its results to L2 more slowly than
// the epilogue makes them, and accumulators for 128 x 256 leave no registers
// to hold a finished tile back, so the stores of a tile are not hidden.
//
// Design: one persistent block an SM, three warpgroups with separate roles,
// and rings of 64-deep K tiles in shared memory guarded by full/empty
// mbarriers.  (A fourth warpgroup would cap the kernel at 128 registers a
// thread, and one wgmma n256 with its 128 accumulators needs 154.)
//   * Producer (one thread, in the last warp of warpgroup 2) streams
//     (256 x 64) int8 tiles of the (N, K) weight by TMA with the 64-byte
//     swizzle, as wgmma reads a K-major B operand, and (128 x 64) tiles of x,
//     bf16 or float32 as it lies in memory; it polls both rings, so each
//     runs as far ahead as its own depth allows.  One thread's instructions
//     follow each other slowly, so a turn of its loop does a few additions
//     and no division (with one in it the loop, not L2, set the pace of the
//     weight).  TMA zero-fills past M, N and K, so ragged edges need no masks
//     before the stores.
//   * Converter (the other three warps of warpgroup 2) takes each arrived x
//     tile, quantizes it with the arithmetic above (all of a block's loads
//     ahead of its arithmetic) and writes the int8 A tile, swizzled and
//     K-major, then fence.proxy.async and an arrive on the tile's full barrier.
//   * Consumers (warpgroups 0 and 1, 64 rows each) only issue
//     wgmma.m64n256k32.s32.s8.s8 on (A tile, weight tile) pairs, one group in
//     flight, and run the epilogue: int32 -> float32, scale and bias (asked
//     for one tile ahead, because a load queues behind its warp's stores, and
//     passed through shared memory), quick-GELU, one rounding to bf16, staged
//     through a swizzled 1 KB buffer a warp, out in 16-byte stores of 128-byte
//     row pieces.  setmaxnreg gives them 216 registers a thread (128
//     accumulators) and leaves warpgroup 2 with 72.
//   * Resident route, K <= 768 (twelve A tiles, 96 KB): a block quantizes its
//     128 rows once and walks its column tiles with only the weight streaming;
//     A tiles are released during the last column tile, so the converter
//     refills them with the next panel behind the consumers.  x is read once.
//     A unit of work is a row panel with all its column tiles, or fewer where
//     that leaves SMs without work.  Streaming route, K > 768: the unit of
//     work is one 128 x 256 tile, the A ring is four deep and x is quantized
//     again for each column tile; tiles of one row panel run on neighbouring
//     blocks at the same time, so x comes from L2.
//   * The loads of the next tile are in flight during a tile's epilogue: the
//     producer and the converter run ahead by the depth of their rings.
// A barrier that is waited for two seconds traps (mbar_wait), so a ring gone
// wrong fails the launch instead of hanging.
//
// Exactness: 127/max(a, 1e-12) is an IEEE division, x * inv one rounded
// product, the conversion rounds half to even like jnp.round (clamping to
// -127 before and saturating at 127 after the rounding gives the same integer
// as clamping the rounded value), and the epilogue's products and sum are
// rounded one at a time in JAX's order (__fmul_rn / __fadd_rn, no FMA
// contraction).  So the int8 values and int32 sums equal the plain version's
// bit for bit; only the exponential and the reciprocal of the quick-GELU
// (quick_gelu below) can move the result, by at most one bf16 ulp, and the
// tanh-GELU (tanh_gelu below) where its 1 + tanh cancels.
//
// Plain C entry point (bound with ctypes): arp_int8_gemm returns the
// cudaError_t of the launch.  The tensor maps come from libcuda's
// cuTensorMapEncodeTiled, found at run time through the runtime's
// cudaGetDriverEntryPoint, so the library links against nothing but cudart.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>

#include "wgmma.cuh"

namespace {

using namespace arp;

constexpr int kBM = 128;  // rows a block: two consumer warpgroups x 64
constexpr int kBN = 256;  // one wgmma n256
constexpr int kBK = 64;   // K tile: one 64-byte swizzle row of int8
constexpr int kThreads = 384;       // two consumer warpgroups, and one of three converter warps and a producer
constexpr int kConvertWarps = 3;
constexpr int kAStage = kBM * kBK;      // 8 KB of int8 x
constexpr int kWStage = kBN * kBK;      // 16 KB of int8 weight
constexpr int kStagingWarp = 8 * 128;   // 8 rows x 64 bf16 columns of output a consumer warp
constexpr int kStaging = 8 * kStagingWarp;
constexpr int kColBytes = 2 * kBN * 8;  // (scale, bias) of a tile's columns, a copy a consumer warpgroup
constexpr int kBarBytes = 512;          // the mbarriers, ahead of the rings
constexpr int kResidentTiles = 12;      // K tiles of a resident panel: K <= 768
constexpr int kRingBytes = kResidentTiles * kAStage + 5 * kWStage + 2 * 16384 + kStaging + kColBytes;  // the larger route
constexpr int kSmemBytes = kBarBytes + 1024 + kRingBytes;  // + room to align the rings to 1024 bytes
static_assert(kSmemBytes <= 232448, "a block has 227 KB of shared memory");
static_assert(4 * kAStage + 6 * kWStage + 65536 + kStaging + kColBytes <= kRingBytes, "the streaming route's rings");
static_assert(16 * (kResidentTiles + 5 + 2) <= kBarBytes && 16 * (4 + 6 + 4) <= kBarBytes, "two barriers a stage");

// For measuring where the time goes (ops/k2_ablate.py builds the variants):
// -DK2_ABLATE=<a sum of 1 no products, 2 no conversion, 4 no epilogue, 8 no
// stores to global memory>.  Anything but 0 computes nothing useful.
#ifndef K2_ABLATE
#define K2_ABLATE 0
#endif

// The route of a call: ring depths (A tiles, weight tiles, raw x tiles), and
// how a row panel's column tiles are cut into units of work.
struct Plan {
  int a_stages, w_stages, x_stages, groups, n_per_unit;
};
// K <= 768: the unit's x tiles all stay in shared memory (resident route), so a
// unit takes as many column tiles as still leaves every SM a unit.  Else a
// unit is one tile (streaming route).
__host__ inline Plan make_plan(int M, int N, int K, int x_bytes, int sms) {
  const int raw = kBM * kBK * x_bytes;  // 16 KB of bf16, 32 KB of float32
  const int panels = (M + kBM - 1) / kBM, n_tiles = (N + kBN - 1) / kBN;
  if ((K + kBK - 1) / kBK > kResidentTiles) return {4, 6, 65536 / raw, n_tiles, 1};
  const int wanted = sms / panels < 1 ? 1 : (sms / panels > n_tiles ? n_tiles : sms / panels);
  const int n_per_unit = (n_tiles + wanted - 1) / wanted;
  return {kResidentTiles, 5, 32768 / raw, (n_tiles + n_per_unit - 1) / n_per_unit, n_per_unit};
}

__device__ __forceinline__ int quantize(float v, float inv) {
  return __float2int_rn(fmaxf(__fmul_rn(v, inv), -127.0f));  // <= 127 by the saturating pack below
}

// Four quantized values -> four int8 in one word, first value lowest, each
// saturated to [-128, 127]: cvt.pack writes sat(a) to byte 1, sat(b) to byte 0
// and the low half of c above them.
__device__ __forceinline__ uint32_t pack4(float v0, float v1, float v2, float v3, float inv) {
  const int q0 = quantize(v0, inv), q1 = quantize(v1, inv), q2 = quantize(v2, inv), q3 = quantize(v3, inv);
  uint32_t r;
  asm("{\n.reg .b32 hi;\n"
      "cvt.pack.sat.s8.s32.b32 hi, %4, %3, 0;\n"
      "cvt.pack.sat.s8.s32.b32 %0, %2, %1, hi;\n}\n"
      : "=r"(r)
      : "r"(q0), "r"(q1), "r"(q2), "r"(q3));
  return r;
}

__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// v * sigmoid(1.702 v) without a branch: with t = exp(-|z|) in (0, 1],
// sigmoid(z) is 1 / (1 + t) for z >= 0 and t / (1 + t) below, so the divisor
// stays in [1, 2] and nothing overflows.  A t below 2^-128 is taken as 0:
// there exp(-z) overflows, and v / (1 + exp(-z)), like the plain version's
// sigmoid, gives 0.  ex2.approx and rcp.approx are within 2^-21 relative,
// which can move a result only across a bf16 rounding tie.
__device__ __forceinline__ float quick_gelu(float v) {
  float t, r;
  asm("ex2.approx.f32 %0, %1;" : "=f"(t) : "f"(-2.4554669595930157f * fabsf(v)));  // 1.702 log2(e)
  t = t < 2.938735877e-39f ? 0.f : t;
  asm("rcp.approx.f32 %0, %1;" : "=f"(r) : "f"(1.0f + t));
  return v * (v >= 0.f ? r : t * r);
}

// The tanh approximation of GELU, 0.5 v (1 + tanh(sqrt(2/pi) (v + 0.044715 v^3))),
// in the operation order of jax.nn.gelu(approximate=True) and of the plain
// version, each product and sum rounded on its own, with the accurate tanhf
// (not tanh.approx): where 1 + tanh cancels (v below about -4) the result
// hangs on tanh's last bit, and the plain version is the reference there too.
__device__ __forceinline__ float tanh_gelu(float v) {
  const float cube = __fmul_rn(__fmul_rn(v, v), v);
  const float inner = __fmul_rn(0.7978845608028654f, __fadd_rn(v, __fmul_rn(0.044715f, cube)));
  return __fmul_rn(__fmul_rn(0.5f, v), __fadd_rn(1.0f, tanhf(inner)));
}

// The ring position after one more use: the stage, and the parity of its use count.
__device__ __forceinline__ void advance(int& stage, int& parity, int stages) {
  if (++stage == stages) {
    stage = 0;
    parity ^= 1;
  }
}

// With -DK2_TRACE (ops/k2_ablate.py) the first thread of each consumer
// warpgroup notes the time, in ns, where a tile begins, after its last product
// and after its last store, for the first 64 tiles of the first 256 blocks;
// arp_int8_gemm_trace copies the notes out.
#ifdef K2_TRACE
constexpr int kTraceBlocks = 256, kTraceTiles = 64;
__device__ unsigned long long k2_trace[kTraceBlocks][2][kTraceTiles][3];
#define K2_STAMP(slot)                                                  \
  if (elected && blockIdx.x < kTraceBlocks && tiles_done < kTraceTiles) \
  k2_trace[blockIdx.x][wg][tiles_done][slot] = global_timer_ns()
#else
#define K2_STAMP(slot)
#endif

// TANH: the epilogue is the tanh-GELU (act 2), compiled apart, so that its 128 inlined tanhf
// do not sit in the code of the other epilogues (act 0 and 1, chosen at run time).
template <typename T, bool TANH>
__global__ void __launch_bounds__(kThreads, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap tm_x, const __grid_constant__ CUtensorMap tm_w,
                 const float* __restrict__ a_scale, const float* __restrict__ ws,
                 const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M, int N, int K,
                 int act, Plan plan) {
  constexpr int kRaw = kBM * kBK * (int)sizeof(T);  // one x tile as it lies in memory

  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t ring = (raw + kBarBytes + 1023u) & ~1023u;
  uint8_t* const ring_ptr = smem_raw + (ring - raw);
  const int a_stages = plan.a_stages, w_stages = plan.w_stages, x_stages = plan.x_stages;
  const int a_off = 0, w_off = a_stages * kAStage, x_off = w_off + w_stages * kWStage;
  const int stg_off = x_off + x_stages * kRaw, col_off = stg_off + kStaging;
  // barriers: full and empty of each ring
  const uint32_t full_a = raw, empty_a = full_a + 8 * a_stages;
  const uint32_t full_w = empty_a + 8 * a_stages, empty_w = full_w + 8 * w_stages;
  const uint32_t full_x = empty_w + 8 * w_stages, empty_x = full_x + 8 * x_stages;

  if (threadIdx.x == 0) {
    for (int s = 0; s < a_stages; ++s) {
      mbar_init(full_a + 8 * s, 32 * kConvertWarps);  // every converter thread
      mbar_init(empty_a + 8 * s, 2);                  // one thread of each consumer warpgroup
    }
    for (int s = 0; s < w_stages; ++s) {
      mbar_init(full_w + 8 * s, 1);  // the producer's expect_tx
      mbar_init(empty_w + 8 * s, 2);
    }
    for (int s = 0; s < x_stages; ++s) {
      mbar_init(full_x + 8 * s, 1);
      mbar_init(empty_x + 8 * s, 32 * kConvertWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Units of work, the same sequence in every role: unit u is row panel
  // u / groups and the n_per_unit column tiles from (u % groups) * n_per_unit
  // (fewer in a panel's last unit).  Its x tiles are quantized once.
  const int n_tiles = (N + kBN - 1) / kBN, k_tiles = (K + kBK - 1) / kBK;
  const int groups = plan.groups, n_per_unit = plan.n_per_unit;
  const int units = ((M + kBM - 1) / kBM) * groups;

  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  if (wg == 2) {
    setmaxnreg_dec<72>();
    if (warp == 3) {
      // ---- producer: one thread streams the weight and x, each as far ahead as its ring allows ----
      // It polls both rings, and one thread's instructions follow each other
      // slowly: what a turn of the loop computes is kept to a few additions, and
      // what a unit of work needs is computed when a unit begins.
      if (lane == 0) {
        int wu = blockIdx.x, w_n0 = 0, w_tiles = 0, wkt = 0, sw = 0, pw = 0;  // next weight tile
        int xu = blockIdx.x, x_m0 = 0, xkt = 0, sx = 0, px = 0;               // next x tile
        const auto begin_w = [&] {  // the first column and the column tiles of unit wu
          const int n_first = (wu % groups) * n_per_unit;
          w_n0 = n_first * kBN;
          w_tiles = min(n_per_unit, n_tiles - n_first);
        };
        if (wu < units) begin_w();
        if (xu < units) x_m0 = (xu / groups) * kBM;
        uint32_t idle = 0;  // turns that moved nothing; the clock is read every 4,096th
        uint64_t idle_since = 0;
        while (wu < units || xu < units) {
          bool moved = false;
          if (wu < units && mbar_test_wait(empty_w + 8 * sw, pw ^ 1)) {
            mbar_arrive_expect_tx(full_w + 8 * sw, kWStage);
            tma_load_2d(ring + w_off + sw * kWStage, &tm_w, wkt * kBK, w_n0, full_w + 8 * sw);
            advance(sw, pw, w_stages);
            if (++wkt == k_tiles) {
              wkt = 0;
              w_n0 += kBN;
              if (--w_tiles == 0) {
                wu += gridDim.x;
                if (wu < units) begin_w();
              }
            }
            moved = true;
          }
          if (xu < units && mbar_test_wait(empty_x + 8 * sx, px ^ 1)) {
            mbar_arrive_expect_tx(full_x + 8 * sx, kRaw);
            tma_load_2d(ring + x_off + sx * kRaw, &tm_x, xkt * kBK, x_m0, full_x + 8 * sx);
            advance(sx, px, x_stages);
            if (++xkt == k_tiles) {
              xkt = 0;
              xu += gridDim.x;
              if (xu < units) x_m0 = (xu / groups) * kBM;
            }
            moved = true;
          }
          if (moved) {
            idle = 0;
          } else if ((++idle & 4095u) == 0) {  // as mbar_wait: a ring gone wrong fails the launch
            const uint64_t now = global_timer_ns();
            if (idle == 4096u) idle_since = now;
            if (now - idle_since > 2000000000ull) __trap();
          }
        }
      }
    } else {
      // ---- converter (three warps): raw x tile -> int8 A tile, once a unit ----
      // A warp takes 32 16-byte chunks at a time ("pass": 4 rows of bf16, 2 of
      // float32); passes go round the three warps, kBlock at a time with all
      // loads ahead of the arithmetic, and the passes left over one each.
      constexpr int kChunks = kBK * (int)sizeof(T) / 16;  // 16-byte chunks of a raw row: 8 or 16
      constexpr int kVals = 16 / (int)sizeof(T);          // values a chunk: 8 or 4
      constexpr int kRowsPass = 32 / kChunks;
      constexpr int kPasses = kBM / kRowsPass;            // 32 or 64
      constexpr int kPer = kPasses / kConvertWarps;       // 10 or 21 a warp, and 2 or 1 left over
      constexpr int kBlock = sizeof(T) == 2 ? 5 : 7;
      static_assert(kPer % kBlock == 0, "whole blocks of passes");
      const int c = lane % kChunks, r0 = lane / kChunks;
      const float inv = 127.0f / fmaxf(__ldg(a_scale), 1e-12f);
      const auto load = [&](const uint8_t* src, int pass) {
        return *reinterpret_cast<const uint4*>(src + (pass * kRowsPass + r0) * (kBK * (int)sizeof(T)) + c * 16);
      };
      const auto store = [&](uint8_t* dst, int pass, const uint4& v) {
        const uint32_t off = swizzle64((pass * kRowsPass + r0) * kBK + c * kVals);
        if constexpr (sizeof(T) == 2) {
          uint2 q;
          q.x = pack4(bf16_lo(v.x), bf16_hi(v.x), bf16_lo(v.y), bf16_hi(v.y), inv);
          q.y = pack4(bf16_lo(v.z), bf16_hi(v.z), bf16_lo(v.w), bf16_hi(v.w), inv);
          *reinterpret_cast<uint2*>(dst + off) = q;
        } else {
          *reinterpret_cast<uint32_t*>(dst + off) =
              pack4(__uint_as_float(v.x), __uint_as_float(v.y), __uint_as_float(v.z), __uint_as_float(v.w), inv);
        }
      };
      int sa = 0, pa = 0, sx = 0, px = 0;
      for (int u = blockIdx.x; u < units; u += gridDim.x) {
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(full_x + 8 * sx, px);
          mbar_wait(empty_a + 8 * sa, pa ^ 1);
          const uint8_t* src = ring_ptr + x_off + sx * kRaw;
          uint8_t* dst = ring_ptr + a_off + sa * kAStage;
          if constexpr (!(K2_ABLATE & 2)) {
#pragma unroll
            for (int blk = 0; blk < kPer / kBlock; ++blk) {
              uint4 v[kBlock];
#pragma unroll
              for (int i = 0; i < kBlock; ++i) v[i] = load(src, warp + kConvertWarps * (blk * kBlock + i));
#pragma unroll
              for (int i = 0; i < kBlock; ++i) store(dst, warp + kConvertWarps * (blk * kBlock + i), v[i]);
            }
            if (warp < kPasses - kPer * kConvertWarps) {
              const int pass = kPer * kConvertWarps + warp;
              store(dst, pass, load(src, pass));
            }
          }
          fence_proxy_async();  // the A tile is read by wgmma, through the asynchronous proxy
          mbar_arrive(full_a + 8 * sa);
          mbar_arrive(empty_x + 8 * sx);
          advance(sa, pa, a_stages);
          advance(sx, px, x_stages);
        }
      }
    }
  } else {
    // ---- consumers: wgmma on 64 rows each, and the epilogue ----
    setmaxnreg_inc<216>();
    const int t = threadIdx.x & 127;
    const bool elected = t == 0;
    const float a_over = __fdiv_rn(__ldg(a_scale), 127.0f);
    const int row_l = lane >> 2, q4 = lane & 3;
    uint8_t* const stg = ring_ptr + stg_off + (wg * 4 + warp) * kStagingWarp;
    // (scale, bias) of the tile's 256 columns, one copy a warpgroup
    float2* const col_sb = reinterpret_cast<float2*>(ring_ptr + col_off) + wg * kBN;
    int acc[128];
    // This thread's share of the coming tile's columns, t and t + 128: (weight
    // scale, bias).  Asked for one tile ahead, before the stores of the tile in
    // hand: a load queues behind the stores its warp has issued.
    float2 coming[2];
    const auto fetch_columns = [&](int n0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int col = n0 + t + 128 * i;
        coming[i].x = col < N ? __ldg(ws + col) : 0.f;
        coming[i].y = col < N && bias != nullptr ? __ldg(bias + col) : 0.f;
      }
    };
    if (blockIdx.x < units) fetch_columns((blockIdx.x % groups) * n_per_unit * kBN);
    int sw = 0, pw = 0, sa_base = 0, pa_base = 0;
    [[maybe_unused]] int tiles_done = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x) {
      const int m0 = (u / groups) * kBM, n_first = (u % groups) * n_per_unit;
      const int n_count = min(n_per_unit, n_tiles - n_first);
      int sa = sa_base, pa = pa_base;
      for (int nn = 0; nn < n_count; ++nn) {
        const int n0 = (n_first + nn) * kBN;
        // the x tiles of a unit are read again by every column tile and released by the last
        sa = sa_base;
        pa = pa_base;
        const bool release_a = nn == n_count - 1;
        int prev_w = 0, prev_a = 0;
        K2_STAMP(0);
        for (int kt = 0; kt < k_tiles; ++kt) {
          mbar_wait(full_a + 8 * sa, pa);
          mbar_wait(full_w + 8 * sw, pw);
          const uint32_t a_addr = ring + a_off + sa * kAStage + wg * (64 * kBK);
          const uint32_t b_addr = ring + w_off + sw * kWStage;
          wgmma_fence();
          if constexpr (!(K2_ABLATE & 1)) {
#pragma unroll
            for (int kk = 0; kk < kBK / 32; ++kk)
              WgmmaS8<kBN>::ss(acc, make_desc(a_addr + kk * 32, 16, 8 * kBK, kLayoutSw64),
                               make_desc(b_addr + kk * 32, 16, 8 * kBK, kLayoutSw64), (kt | kk) != 0);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the tile before is done with its stages
          if (kt > 0 && elected) {
            mbar_arrive(empty_w + 8 * prev_w);
            if (release_a) mbar_arrive(empty_a + 8 * prev_a);
          }
          prev_w = sw;
          prev_a = sa;
          advance(sw, pw, w_stages);
          advance(sa, pa, a_stages);
        }
        wgmma_wait<0>();
        keep_all(acc);
        K2_STAMP(1);
        if (elected) {
          mbar_arrive(empty_w + 8 * prev_w);
          if (release_a) mbar_arrive(empty_a + 8 * prev_a);
        }

        named_barrier_sync(1 + wg, 128);  // the warpgroup is done reading the tile before's columns
#pragma unroll
        for (int i = 0; i < 2; ++i) col_sb[t + 128 * i] = make_float2(__fmul_rn(coming[i].x, a_over), coming[i].y);
        if (nn + 1 < n_count)
          fetch_columns(n0 + kBN);
        else if (u + gridDim.x < units)
          fetch_columns(((u + gridDim.x) % groups) * n_per_unit * kBN);
        named_barrier_sync(1 + wg, 128);

        // Epilogue: acc[4 j + 2 h + e] is (row_l + 8 h, column 8 j + 2 q4 + e) of
        // the warp's 16 rows.  8 rows x 64 columns at a time go through the warp's
        // staging buffer (128-byte rows, swizzled: fragment writes and row reads
        // both hit 32 banks) and leave in 16-byte stores of 128-byte row pieces.
        const int warp_row0 = m0 + wg * 64 + warp * 16;
        if constexpr (K2_ABLATE & 4) continue;
#pragma unroll
        for (int g = 0; g < kBN / 64; ++g) {
          uint32_t packed[8][2];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * g + jj;
            // columns 8 j + 2 q4 and + 1 of the tile: (scale, bias, scale, bias)
            const float4 c4 = *reinterpret_cast<const float4*>(col_sb + 8 * j + 2 * q4);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float v0 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h]), c4.x), c4.y);
              float v1 = __fadd_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1]), c4.z), c4.w);
              if constexpr (TANH) {
                v0 = tanh_gelu(v0);
                v1 = tanh_gelu(v1);
              } else if (act == 1) {
                v0 = quick_gelu(v0);
                v1 = quick_gelu(v1);
              }
              packed[jj][h] = pack_bf16x2(v0, v1);
            }
          }
#pragma unroll
          for (int h = 0; h < 2; ++h) {
#pragma unroll
            for (int jj = 0; jj < 8; ++jj)
              *reinterpret_cast<uint32_t*>(stg + swizzle128(row_l * 128 + 16 * jj) + 4 * q4) = packed[jj][h];
            __syncwarp();
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              const int idx = lane + 32 * i;
              const int r = idx >> 3, ch = idx & 7;
              const int row = warp_row0 + 8 * h + r, col = n0 + 64 * g + 8 * ch;  // N % 8 == 0: a chunk is in or out
              if (row < M && col < N && !(K2_ABLATE & 8))
                *reinterpret_cast<uint4*>(out + (long long)row * N + col) =
                    *reinterpret_cast<const uint4*>(stg + swizzle128(r * 128 + 16 * ch));
            }
            __syncwarp();
          }
        }
        K2_STAMP(2);
        ++tiles_done;
      }
      sa_base = sa;
      pa_base = pa;
    }
  }
}

// --- host side ----------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, without linking against it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                       : nullptr;
  }();
  return fn;
}

// A 2-D tensor map: `inner` contiguous elements a row, `outer` rows `row_bytes`
// apart, loaded in boxes of box_inner x box_outer; out-of-bounds reads give zeros.
bool encode_2d(CUtensorMap* map, CUtensorMapDataType dtype, const void* base, uint64_t inner,
               uint64_t outer, uint64_t row_bytes, uint32_t box_inner, uint32_t box_outer,
               CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The weight's map depends only on (pointer, N, K): made once per weight.
bool weight_map(const int8_t* wt, int N, int K, CUtensorMap* map) {
  static std::mutex mutex;
  static std::map<std::tuple<const void*, int, int>, CUtensorMap> cache;
  const std::lock_guard<std::mutex> lock(mutex);
  const auto key = std::make_tuple(static_cast<const void*>(wt), N, K);
  const auto it = cache.find(key);
  if (it != cache.end()) {
    *map = it->second;
    return true;
  }
  if (!encode_2d(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, wt, K, N, K, kBK, kBN, CU_TENSOR_MAP_SWIZZLE_64B))
    return false;
  if (cache.size() >= 4096) cache.clear();
  cache.emplace(key, *map);
  return true;
}

// SMs of the current device, asked once a device.
cudaError_t sm_count(int* count) {
  static int cached[64] = {0};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  const bool slot = device >= 0 && device < 64;
  if (slot && cached[device] > 0) {
    *count = cached[device];
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(count, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess && slot) cached[device] = *count;
  return err;
}

template <typename T, bool TANH>
cudaError_t launch(const void* x, const float* a_scale, const int8_t* wt, const float* ws,
                   const float* bias, __nv_bfloat16* out, int M, int N, int K, long long lda,
                   int act, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(int8_gemm_kernel<T, TANH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return err;
  int sms = 0;
  err = sm_count(&sms);
  if (err != cudaSuccess) return err;

  const Plan plan = make_plan(M, N, K, (int)sizeof(T), sms);
  const long long units = (long long)((M + kBM - 1) / kBM) * plan.groups;
  if (units > 0x7fffffffLL) return cudaErrorInvalidValue;

  alignas(64) CUtensorMap tm_x, tm_w;
  const CUtensorMapDataType x_type =
      sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!weight_map(wt, N, K, &tm_w) ||
      !encode_2d(&tm_x, x_type, x, K, M, (uint64_t)lda * sizeof(T), kBK, kBM, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;

  const int grid = (int)(units < sms ? units : sms);
  int8_gemm_kernel<T, TANH><<<grid, kThreads, kSmemBytes, stream>>>(
      tm_x, tm_w, a_scale, ws, bias, out, M, N, K, act, plan);
  return cudaGetLastError();
}

}  // namespace

#ifdef K2_TRACE
// Waits for the device, copies the time notes (k2_trace above) to host memory at dst and clears them.
extern "C" int arp_int8_gemm_trace(void* dst) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess) err = cudaMemcpyFromSymbol(dst, k2_trace, sizeof(k2_trace));
  void* notes = nullptr;
  if (err == cudaSuccess) err = cudaGetSymbolAddress(&notes, k2_trace);
  if (err == cudaSuccess) err = cudaMemset(notes, 0, sizeof(k2_trace));
  return (int)err;
}
#endif

// dtype: 0 = float32, 1 = bfloat16 x.  x is (M, K) with row stride lda
// elements (16-byte aligned rows); a_scale points at one float32 on the
// device; wt is the (N, K) int8 weight, contiguous; ws (N) float32; bias (N)
// float32 or null; out (M, N) bf16, contiguous.  act: 0 none, 1 quick-GELU, 2 tanh-GELU.
// Needs K % 32 == 0 and N % 8 == 0.  Launches on `stream`, allocates nothing,
// does not synchronise.  Returns the launch's cudaError_t.
extern "C" int arp_int8_gemm(const void* x, const void* a_scale, const void* wt, const void* ws,
                             const void* bias, void* out, int dtype, int M, int N, int K,
                             long long lda, int act, void* stream) {
  if (M == 1) lda = K;  // one row: its stride means nothing, and a tensor map wants a valid one
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0 || N % 8 != 0 || act < 0 || act > 2 || lda < K)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* ap = static_cast<const float*>(a_scale);
  const int8_t* wp = static_cast<const int8_t*>(wt);
  const float* wsp = static_cast<const float*>(ws);
  const float* bp = static_cast<const float*>(bias);
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(out);
  if (dtype == 0)
    return (int)(act == 2 ? launch<float, true>(x, ap, wp, wsp, bp, op, M, N, K, lda, act, s)
                          : launch<float, false>(x, ap, wp, wsp, bp, op, M, N, K, lda, act, s));
  if (dtype == 1)
    return (int)(act == 2 ? launch<__nv_bfloat16, true>(x, ap, wp, wsp, bp, op, M, N, K, lda, act, s)
                          : launch<__nv_bfloat16, false>(x, ap, wp, wsp, bp, op, M, N, K, lda, act, s));
  return (int)cudaErrorInvalidValue;
}
