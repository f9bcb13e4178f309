// ARPS shard format: native multithreaded record reader, and the host's
// Pillow-exact bicubic resize (the PyTorch port's own copy of the JAX
// package's native/arps.cpp; the shard format is the same byte for byte).
//
// A simple binary shard format (header + offset index + zlib-compressed
// records) read by a C++ thread pool that decompresses batches in parallel
// straight into a caller-provided buffer, with the Python GIL released for the
// whole call (ctypes releases it).
//
// Format (little-endian):
//   magic   "ARPS"                      4 bytes
//   version u32                         (=1)
//   ndim    u32
//   shape   u64[ndim]                   per-record shape
//   dtype   u32                         (0=u8, 1=i32, 2=i64, 3=f32)
//   count   u64                         number of records
//   offsets u64[count+1]                byte offsets into the data section
//   data    concatenated zlib streams (or raw when offsets encode equality
//           with uncompressed size)
//
// C API (ctypes): arps_open / arps_close / arps_count / arps_record_bytes /
//                 arps_ndim / arps_shape / arps_dtype /
//                 arps_read_batch(handle, idx*, n, out*, nthreads);
//                 pil_resize_batch (below).
//
// Built with g++ at first use and linked with -lz (arp_tpu_torch/data/arps.py).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <unistd.h>

#include <zlib.h>

extern "C" {

struct ArpsFile {
  FILE* f = nullptr;
  uint32_t ndim = 0;
  uint64_t shape[8] = {0};
  uint32_t dtype = 0;
  uint64_t count = 0;
  uint64_t record_bytes = 0;  // uncompressed
  std::vector<uint64_t> offsets;
  uint64_t data_start = 0;
  uint64_t data_size = 0;  // bytes in the data section (file size - header)
};

static uint64_t dtype_size(uint32_t code) {
  switch (code) {
    case 0: return 1;  // u8
    case 1: return 4;  // i32
    case 2: return 8;  // i64
    case 3: return 4;  // f32
  }
  return 0;
}

void* arps_open(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  char magic[4];
  if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "ARPS", 4) != 0) {
    fclose(f);
    return nullptr;
  }
  ArpsFile* af = new ArpsFile();
  af->f = f;
  uint32_t version;
  if (fread(&version, 4, 1, f) != 1 || version != 1) goto fail;
  if (fread(&af->ndim, 4, 1, f) != 1 || af->ndim > 8) goto fail;
  if (fread(af->shape, 8, af->ndim, f) != af->ndim) goto fail;
  if (fread(&af->dtype, 4, 1, f) != 1) goto fail;
  if (fread(&af->count, 8, 1, f) != 1) goto fail;
  // bound the header count by the file size BEFORE allocating: a corrupt
  // count would otherwise wrap (count+1 == 0), bad_alloc across the ctypes
  // boundary, or index an undersized offsets table out of bounds
  {
    long header_pos = ftell(f);
    if (header_pos < 0 || fseek(f, 0, SEEK_END) != 0) goto fail;
    uint64_t file_size = (uint64_t)ftell(f);
    if (fseek(f, header_pos, SEEK_SET) != 0) goto fail;
    uint64_t remaining = file_size > (uint64_t)header_pos ? file_size - (uint64_t)header_pos : 0;
    if (af->count == UINT64_MAX || (af->count + 1) > remaining / 8) goto fail;
  }
  af->record_bytes = dtype_size(af->dtype);
  for (uint32_t i = 0; i < af->ndim; i++) af->record_bytes *= af->shape[i];
  af->offsets.resize(af->count + 1);
  if (fread(af->offsets.data(), 8, af->count + 1, f) != af->count + 1) goto fail;
  af->data_start = ftell(f);
  if (fseek(f, 0, SEEK_END) != 0) goto fail;
  af->data_size = (uint64_t)ftell(f) - af->data_start;
  return af;
fail:
  fclose(f);
  delete af;
  return nullptr;
}

void arps_close(void* handle) {
  ArpsFile* af = static_cast<ArpsFile*>(handle);
  if (af) {
    fclose(af->f);
    delete af;
  }
}

uint64_t arps_count(void* handle) { return static_cast<ArpsFile*>(handle)->count; }

uint64_t arps_record_bytes(void* handle) {
  return static_cast<ArpsFile*>(handle)->record_bytes;
}

uint32_t arps_ndim(void* handle) { return static_cast<ArpsFile*>(handle)->ndim; }

void arps_shape(void* handle, uint64_t* out) {
  ArpsFile* af = static_cast<ArpsFile*>(handle);
  memcpy(out, af->shape, af->ndim * 8);
}

uint32_t arps_dtype(void* handle) { return static_cast<ArpsFile*>(handle)->dtype; }

// Read `n` records by index into `out` (n * record_bytes). Returns 0 on
// success. File reads are serialized (single descriptor, per-read lock via
// pread); decompression fans out over `nthreads`.
int arps_read_batch(void* handle, const uint64_t* indices, uint64_t n,
                    uint8_t* out, int nthreads) {
  ArpsFile* af = static_cast<ArpsFile*>(handle);
  if (!af) return 1;
  if (nthreads < 1) nthreads = 1;

  // Stage compressed payloads (serial reads; pread is thread-safe but seek
  // locality matters more on spinning storage; payloads are small).
  std::vector<std::vector<uint8_t>> payloads(n);
  for (uint64_t i = 0; i < n; i++) {
    uint64_t idx = indices[i];
    if (idx >= af->count) return 2;
    uint64_t begin = af->offsets[idx], end = af->offsets[idx + 1];
    // corrupt index: underflow, or a payload past the end of the file —
    // either would turn into a huge allocation / failed read
    if (end < begin || end > af->data_size) return 2;
    payloads[i].resize(end - begin);
    if (pread(fileno(af->f), payloads[i].data(), end - begin,
              af->data_start + begin) != (ssize_t)(end - begin))
      return 3;
  }

  std::atomic<uint64_t> next(0);
  std::atomic<int> err(0);
  auto worker = [&]() {
    for (;;) {
      uint64_t i = next.fetch_add(1);
      if (i >= n) return;
      uint8_t* dst = out + i * af->record_bytes;
      const auto& src = payloads[i];
      if (src.size() == af->record_bytes) {
        // stored raw
        memcpy(dst, src.data(), src.size());
        continue;
      }
      uLongf dst_len = af->record_bytes;
      int rc = uncompress(dst, &dst_len, src.data(), src.size());
      if (rc != Z_OK || dst_len != af->record_bytes) err.store(4);
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return err.load();
}

// ---------------------------------------------------------------------------
// pil_resize_batch — Pillow-bit-exact uint8 bicubic resize, threaded over the
// batch.  Coefficient tables (gather indices + fixed-point weights, one row
// per output position, PRECISION_BITS=22 as in Pillow 8bpc) are computed in
// Python (ops/preprocess.py::_pil_coeffs, the same tables as the on-device
// matmul formulation's) and passed in.
//
// Two separable passes with per-pass rounding to uint8, matching Pillow's
// ImagingResampleHorizontal_8bpc / Vertical arithmetic exactly:
//   acc = sum_k kk[o,k] * src[idx[o,k]];  out = clip((acc + 2^21) >> 22)
//
// Layout: src (n, in_h, in_w, c) uint8 -> dst (n, out_h, out_w, c) uint8.
// Each thread owns a scratch intermediate (in_h, out_w, c).

static inline uint8_t pil_round_clip(int64_t acc) {
  const int64_t kPrecisionBits = 22;
  int64_t v = (acc + (1ll << (kPrecisionBits - 1))) >> kPrecisionBits;
  if (v < 0) v = 0;
  if (v > 255) v = 255;
  return (uint8_t)v;
}

void pil_resize_batch(const uint8_t* src, uint8_t* dst, int64_t n,
                      int32_t in_h, int32_t in_w, int32_t channels,
                      int32_t out_h, int32_t out_w,
                      const int32_t* idx_w, const int32_t* kk_w, int32_t ksize_w,
                      const int32_t* idx_h, const int32_t* kk_h, int32_t ksize_h,
                      int32_t nthreads) {
  if (nthreads < 1) nthreads = 1;
  const int64_t src_img = (int64_t)in_h * in_w * channels;
  const int64_t dst_img = (int64_t)out_h * out_w * channels;
  const int64_t tmp_img = (int64_t)in_h * out_w * channels;

  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    std::vector<uint8_t> tmp(tmp_img);
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      const uint8_t* im = src + i * src_img;
      uint8_t* out = dst + i * dst_img;
      // horizontal pass: (in_h, in_w, c) -> tmp (in_h, out_w, c)
      for (int32_t y = 0; y < in_h; y++) {
        const uint8_t* row = im + (int64_t)y * in_w * channels;
        uint8_t* trow = tmp.data() + (int64_t)y * out_w * channels;
        for (int32_t o = 0; o < out_w; o++) {
          const int32_t* idx = idx_w + (int64_t)o * ksize_w;
          const int32_t* kk = kk_w + (int64_t)o * ksize_w;
          for (int32_t c = 0; c < channels; c++) {
            int64_t acc = 0;
            for (int32_t k = 0; k < ksize_w; k++)
              acc += (int64_t)kk[k] * row[(int64_t)idx[k] * channels + c];
            trow[(int64_t)o * channels + c] = pil_round_clip(acc);
          }
        }
      }
      // vertical pass: tmp (in_h, out_w, c) -> out (out_h, out_w, c)
      const int64_t tstride = (int64_t)out_w * channels;
      for (int32_t o = 0; o < out_h; o++) {
        const int32_t* idx = idx_h + (int64_t)o * ksize_h;
        const int32_t* kk = kk_h + (int64_t)o * ksize_h;
        uint8_t* orow = out + (int64_t)o * tstride;
        for (int64_t xc = 0; xc < tstride; xc++) {
          int64_t acc = 0;
          for (int32_t k = 0; k < ksize_h; k++)
            acc += (int64_t)kk[k] * tmp[(int64_t)idx[k] * tstride + xc];
          orow[xc] = pil_round_clip(acc);
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int t = 0; t < nthreads; t++) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

}  // extern "C"
