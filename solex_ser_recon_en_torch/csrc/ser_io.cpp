// Native SER container I/O for the TPU pipeline.
//
// reference equivalent: video_reader.py:12-109 (header parse + buffered
// frame reads).  The Python fast path already memory-maps the file; this
// native layer adds what Python cannot express efficiently:
//   - posix madvise-driven sequential readahead on the scan payload,
//   - an explicit prefetch window that overlaps disk I/O with the
//     host->device transfer of the previous slab,
//   - a single-copy slab read into a caller-provided (pinnable) buffer.
//
// Exposed as a minimal C ABI consumed via ctypes (io/native.py); the
// framework silently falls back to the pure-Python mmap reader when the
// shared library is unavailable.

#include <algorithm>
#include <cmath>
#include <cstdint>
#if defined(__AVX512F__)
#include <immintrin.h>
#endif
#include <limits>
#include <cstring>
#include <cstdio>
#include <new>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int64_t kHeaderSize = 178;

struct SerFile {
  int fd = -1;
  const uint8_t* map = nullptr;
  int64_t file_size = 0;
  uint32_t width = 0;
  uint32_t height = 0;
  uint32_t pixel_depth = 0;
  uint32_t frame_count = 0;   // clamped to payload
  int64_t frame_bytes = 0;
};

uint32_t read_u32le(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

}  // namespace

extern "C" {

// Error codes: 0 ok, -1 open/stat, -2 short header, -3 bad header, -4 mmap.
int ser_open(const char* path, void** handle_out, uint32_t* width,
             uint32_t* height, uint32_t* pixel_depth, uint32_t* frame_count) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0) {
    close(fd);
    return -1;
  }
  if (st.st_size < kHeaderSize) {
    close(fd);
    return -2;
  }
  void* map = mmap(nullptr, st.st_size, PROT_READ, MAP_SHARED, fd, 0);
  if (map == MAP_FAILED) {
    close(fd);
    return -4;
  }
  const uint8_t* bytes = static_cast<const uint8_t*>(map);
  SerFile* f = new SerFile;
  f->fd = fd;
  f->map = bytes;
  f->file_size = st.st_size;
  f->width = read_u32le(bytes + 26);
  f->height = read_u32le(bytes + 30);
  f->pixel_depth = read_u32le(bytes + 34);
  f->frame_count = read_u32le(bytes + 38);
  if (f->width == 0 || f->height == 0 ||
      (f->pixel_depth != 8 && f->pixel_depth != 16)) {
    munmap(map, st.st_size);
    close(fd);
    delete f;
    return -3;
  }
  f->frame_bytes =
      static_cast<int64_t>(f->width) * f->height * (f->pixel_depth / 8);
  int64_t payload = f->file_size - kHeaderSize;
  int64_t n = payload / f->frame_bytes;
  if (n < static_cast<int64_t>(f->frame_count)) f->frame_count = static_cast<uint32_t>(n);
  // NOTE: deliberately no MADV_SEQUENTIAL here — it marks the pages as
  // preferential reclaim victims, so under page-cache pressure every pass
  // over a multi-pass scan re-reads from (throttled) disk.  Readahead is
  // requested explicitly per window via ser_prefetch instead.
  *handle_out = f;
  *width = f->width;
  *height = f->height;
  *pixel_depth = f->pixel_depth;
  *frame_count = f->frame_count;
  return 0;
}

// Hint the kernel to start paging in [start, start+count) frames.
int ser_prefetch(void* handle, uint32_t start, uint32_t count) {
  SerFile* f = static_cast<SerFile*>(handle);
  if (!f || start >= f->frame_count) return -1;
  if (start + count > f->frame_count) count = f->frame_count - start;
  const uint8_t* p = f->map + kHeaderSize + static_cast<int64_t>(start) * f->frame_bytes;
  // round down to the page for madvise
  uintptr_t addr = reinterpret_cast<uintptr_t>(p);
  uintptr_t page = addr & ~static_cast<uintptr_t>(4095);
  size_t len = static_cast<size_t>(f->frame_bytes) * count + (addr - page);
  madvise(reinterpret_cast<void*>(page), len, MADV_WILLNEED);
  return 0;
}

// Copy frames [start, start+count) into out (count*frame_bytes bytes).
int ser_read(void* handle, uint32_t start, uint32_t count, uint8_t* out) {
  SerFile* f = static_cast<SerFile*>(handle);
  if (!f || start + count > f->frame_count) return -1;
  const uint8_t* src =
      f->map + kHeaderSize + static_cast<int64_t>(start) * f->frame_bytes;
  memcpy(out, src, static_cast<size_t>(f->frame_bytes) * count);
  return 0;
}

}  // extern "C"

namespace {

// Tile-major fused sum+max sweep for one frame group [g0, g1): for each
// 4096-pixel block, visit every frame in the group before moving on.  The
// block's uint32 accumulator (16 KB) + uint16 running max (8 KB) + the 8 KB
// frame slice all sit in L1, so the only sustained memory stream is the
// frame data itself — measured 8.5 GB/s vs 5.0 GB/s for the frame-major
// loop, whose 7.2 MB of L2/L3 accumulator traffic per 1.2 MB frame was the
// real bound (the DRAM read ceiling on this host is ~8-12 GB/s).
// T is the source pixel type (uint16_t or uint8_t widened on load).
template <typename T>
void sweep_tile_major(const uint8_t* base, int64_t frame_bytes, uint32_t g0,
                      uint32_t g1, int64_t px, uint32_t* __restrict acc32,
                      uint16_t* __restrict max_out) {
  // 16384-px blocks (96 KB of acc+max+slice, L2-resident) measured ~5-8%
  // faster than the 4096-px L1-sized blocks on this host — fewer frame-loop
  // restarts per block outweigh the L1->L2 working-set spill (docs/PERF.md)
  constexpr int64_t kBlock = 16384;
  for (int64_t b = 0; b < px; b += kBlock) {
    const int64_t n = (b + kBlock < px) ? kBlock : px - b;
    uint32_t* __restrict a = acc32 + b;
    uint16_t* __restrict m = max_out + b;
    for (uint32_t fr = g0; fr < g1; ++fr) {
      const T* __restrict p = reinterpret_cast<const T*>(
                                  base + static_cast<int64_t>(fr) * frame_bytes) +
                              b;
      for (int64_t i = 0; i < n; ++i) {
        uint16_t v = static_cast<uint16_t>(p[i]);
        a[i] += v;
        m[i] = v > m[i] ? v : m[i];
      }
    }
  }
}

}  // namespace

extern "C" {

// Fused single-pass sum + max + optional band extraction over all frames
// (pass A of the pipeline, reference: solex_util.py:174-188).  NumPy needs
// two reduction passes per chunk (sum, then max) — 2x the host memory
// traffic of this loop, which the autovectoriser turns into one
// widening-add + max sweep.  Accumulates into cache-resident uint32 tiles,
// folding to the uint64 output before overflow; prefetches the next frame
// window so cold reads overlap compute.  Without band extraction the sweep
// runs tile-major per prefetch group (see sweep_tile_major above, ~1.65x);
// with a band copy it stays frame-major so each frame's band rows are
// copied while the frame is cache-hot.
// sum_out: width*height uint64 (raw layout), max_out: width*height uint16
// (8-bit inputs are widened, NOT shifted — scaling is the caller's job).
//
// Band extraction: when band_out != nullptr, the raw-coordinate rectangle
// rows [r0, r1) x cols [c0, c1) of every frame is copied (while the frame
// is hot in cache) into band_out, laid out (frames, r1-r0, c1-c0) in the
// file's pixel type.  This lets pass B (the recon's spectral-column
// gathers, io/hostreduce.py) read from a compact contiguous buffer instead
// of re-sweeping the whole multi-GB scan — the second pass the two-pass
// reference design pays (Solex_recon.py:61-73) disappears.
int ser_mean_max_band(void* handle, uint64_t* sum_out, uint16_t* max_out,
                      uint32_t r0, uint32_t r1, uint32_t c0, uint32_t c1,
                      uint8_t* band_out) {
  SerFile* f = static_cast<SerFile*>(handle);
  if (!f) return -1;
  if (band_out && (r0 >= r1 || c0 >= c1 || r1 > f->height || c1 > f->width))
    return -3;
  const int64_t px = static_cast<int64_t>(f->width) * f->height;
  uint32_t* acc32 = new (std::nothrow) uint32_t[px]();
  if (!acc32) return -2;
  const int64_t elem = f->pixel_depth / 8;
  const int64_t band_row_bytes = static_cast<int64_t>(c1 - c0) * elem;
  const int64_t band_frame_bytes = band_row_bytes * (r1 - r0);
  for (int64_t i = 0; i < px; ++i) {
    sum_out[i] = 0;
    max_out[i] = 0;
  }
  const uint8_t* base = f->map + kHeaderSize;
  // uint32 accumulator overflow bound: 65535 * 65537 > 2^32
  const uint32_t fold_every = (f->pixel_depth == 16) ? 65000u : 16000000u;
  const uint32_t prefetch_win = 256;
  uint32_t since_fold = 0;
  if (!band_out) {
    // tile-major sweep per prefetch group (no per-frame band copy to keep
    // cache-hot, so the block-major order is free to minimise acc traffic)
    for (uint32_t g0 = 0; g0 < f->frame_count; g0 += prefetch_win) {
      const uint32_t g1 = (g0 + prefetch_win < f->frame_count)
                              ? g0 + prefetch_win
                              : f->frame_count;
      if (g1 < f->frame_count) {
        const uint8_t* p = base + static_cast<int64_t>(g1) * f->frame_bytes;
        uintptr_t addr = reinterpret_cast<uintptr_t>(p);
        uintptr_t page = addr & ~static_cast<uintptr_t>(4095);
        uint32_t nxt = (g1 + prefetch_win < f->frame_count)
                           ? prefetch_win
                           : f->frame_count - g1;
        madvise(reinterpret_cast<void*>(page),
                static_cast<size_t>(f->frame_bytes) * nxt + (addr - page),
                MADV_WILLNEED);
      }
      if (since_fold + (g1 - g0) > fold_every) {
        for (int64_t i = 0; i < px; ++i) {
          sum_out[i] += acc32[i];
          acc32[i] = 0;
        }
        since_fold = 0;
      }
      if (f->pixel_depth == 16) {
        sweep_tile_major<uint16_t>(base, f->frame_bytes, g0, g1, px, acc32,
                                   max_out);
      } else {
        sweep_tile_major<uint8_t>(base, f->frame_bytes, g0, g1, px, acc32,
                                  max_out);
      }
      since_fold += g1 - g0;
    }
    for (int64_t i = 0; i < px; ++i) sum_out[i] += acc32[i];
    delete[] acc32;
    return 0;
  }
  for (uint32_t fr = 0; fr < f->frame_count; ++fr) {
    if (fr % prefetch_win == 0 && fr + prefetch_win < f->frame_count) {
      const uint8_t* p =
          base + static_cast<int64_t>(fr + prefetch_win) * f->frame_bytes;
      uintptr_t addr = reinterpret_cast<uintptr_t>(p);
      uintptr_t page = addr & ~static_cast<uintptr_t>(4095);
      madvise(reinterpret_cast<void*>(page),
              static_cast<size_t>(f->frame_bytes) * prefetch_win +
                  (addr - page),
              MADV_WILLNEED);
    }
    const uint8_t* fp = base + static_cast<int64_t>(fr) * f->frame_bytes;
    if (f->pixel_depth == 16) {
      const uint16_t* p = reinterpret_cast<const uint16_t*>(fp);
      for (int64_t i = 0; i < px; ++i) {
        uint16_t v = p[i];
        acc32[i] += v;
        if (v > max_out[i]) max_out[i] = v;
      }
    } else {
      for (int64_t i = 0; i < px; ++i) {
        uint16_t v = fp[i];
        acc32[i] += v;
        if (v > max_out[i]) max_out[i] = v;
      }
    }
    if (band_out) {
      uint8_t* dst = band_out + static_cast<int64_t>(fr) * band_frame_bytes;
      if (c0 == 0 && c1 == f->width) {
        // full-width row range (wide-stored scans): one contiguous copy
        memcpy(dst, fp + static_cast<int64_t>(r0) * f->width * elem,
               static_cast<size_t>(band_frame_bytes));
      } else {
        for (uint32_t r = r0; r < r1; ++r) {
          memcpy(dst + static_cast<int64_t>(r - r0) * band_row_bytes,
                 fp + (static_cast<int64_t>(r) * f->width + c0) * elem,
                 static_cast<size_t>(band_row_bytes));
        }
      }
    }
    if (++since_fold == fold_every) {
      for (int64_t i = 0; i < px; ++i) {
        sum_out[i] += acc32[i];
        acc32[i] = 0;
      }
      since_fold = 0;
    }
  }
  if (since_fold) {
    for (int64_t i = 0; i < px; ++i) sum_out[i] += acc32[i];
  }
  delete[] acc32;
  return 0;
}

// Back-compat entry: fused sum + max only, no band extraction.
int ser_mean_max(void* handle, uint64_t* sum_out, uint16_t* max_out) {
  return ser_mean_max_band(handle, sum_out, max_out, 0, 0, 0, 0, nullptr);
}

// Subsampled full-frame sum + max: every `step`-th frame only.  The cheap
// leg of the two-step pass A (io/hostreduce.py:fast_passa): ~F/step frames
// locate the spectral band and the sun's vertical extent, then
// ser_band_stats touches ONLY that band at full frame resolution.
// Returns the number of frames accumulated (the mean divisor), or <0 on
// error.  sum_out/max_out are width*height, raw layout.
int ser_sample_stats(void* handle, uint32_t step, uint64_t* sum_out,
                     uint16_t* max_out) {
  SerFile* f = static_cast<SerFile*>(handle);
  if (!f || step == 0) return -1;
  const int64_t px = static_cast<int64_t>(f->width) * f->height;
  for (int64_t i = 0; i < px; ++i) {
    sum_out[i] = 0;
    max_out[i] = 0;
  }
  if (f->frame_count == 0) return 0;
  // Every step-th frame IS a dense frame sequence of stride
  // step*frame_bytes, so the cache-resident tile-major sweep applies
  // verbatim (the old frame-major loop's uint64 accumulator pushed ~12 MB
  // of L2/L3 traffic per 1.2 MB sampled frame — 27 -> ~9 ms on the bench
  // scan).  uint32 tiles fold to the uint64 output before overflow.
  uint32_t* acc32 = new (std::nothrow) uint32_t[px]();
  if (!acc32) return -2;
  const uint8_t* base = f->map + kHeaderSize;
  const int64_t sstride = static_cast<int64_t>(f->frame_bytes) * step;
  const uint32_t n_total = (f->frame_count + step - 1) / step;
  const uint32_t fold_every = (f->pixel_depth == 16) ? 65000u : 16000000u;
  uint32_t done = 0;
  while (done < n_total) {
    const uint32_t g = (n_total - done < fold_every) ? n_total - done
                                                     : fold_every;
    const uint8_t* gbase = base + static_cast<int64_t>(done) * sstride;
    if (f->pixel_depth == 16) {
      sweep_tile_major<uint16_t>(gbase, sstride, 0, g, px, acc32, max_out);
    } else {
      sweep_tile_major<uint8_t>(gbase, sstride, 0, g, px, acc32, max_out);
    }
    for (int64_t i = 0; i < px; ++i) {
      sum_out[i] += acc32[i];
      acc32[i] = 0;
    }
    done += g;
  }
  delete[] acc32;
  return static_cast<int>(n_total);
}

// Full-frame-count sum + max restricted to the raw-coordinate rectangle
// rows [r0, r1) x cols [c0, c1): the expensive leg of the two-step pass A.
// Reads ONLY the band bytes of every frame (for wide-stored scans the band
// is a contiguous slice of each frame), so a 2.4 GB scan whose recon
// gathers from a ~60-column spectral band costs ~1/5 of a full sweep.
// sum_out/max_out are (r1-r0)*(c1-c0), band-local layout.
int ser_band_stats(void* handle, uint32_t r0, uint32_t r1, uint32_t c0,
                   uint32_t c1, uint64_t* sum_out, uint16_t* max_out) {
  SerFile* f = static_cast<SerFile*>(handle);
  if (!f || r0 >= r1 || c0 >= c1 || r1 > f->height || c1 > f->width)
    return -1;
  const int64_t bw = c1 - c0;
  const int64_t bh = r1 - r0;
  const int64_t bpx = bw * bh;
  uint32_t* acc32 = new (std::nothrow) uint32_t[bpx]();
  if (!acc32) return -2;
  for (int64_t i = 0; i < bpx; ++i) {
    sum_out[i] = 0;
    max_out[i] = 0;
  }
  const uint8_t* base = f->map + kHeaderSize;
  const int64_t elem = f->pixel_depth / 8;
  const uint32_t fold_every = (f->pixel_depth == 16) ? 65000u : 16000000u;
  const uint32_t prefetch_win = 256;
  uint32_t since_fold = 0;
  const bool full_width = (c0 == 0 && c1 == f->width);
  if (full_width) {
    // the band is a contiguous sub-frame at a fixed offset in every frame
    // (wide-stored scans keep the spectral axis on raw rows), so the
    // tile-major sweep applies verbatim with a shifted base — same ~1.65x
    // over the frame-major loop as the full-frame pass (sweep_tile_major)
    const uint8_t* bbase = base + static_cast<int64_t>(r0) * f->width * elem;
    for (uint32_t g0 = 0; g0 < f->frame_count; g0 += prefetch_win) {
      const uint32_t g1 = (g0 + prefetch_win < f->frame_count)
                              ? g0 + prefetch_win
                              : f->frame_count;
      if (g1 < f->frame_count) {
        const uint32_t nxt = (g1 + prefetch_win < f->frame_count)
                                 ? prefetch_win
                                 : f->frame_count - g1;
        for (uint32_t g = g1; g < g1 + nxt; ++g) {
          const uint8_t* p = bbase + static_cast<int64_t>(g) * f->frame_bytes;
          uintptr_t addr = reinterpret_cast<uintptr_t>(p);
          uintptr_t page = addr & ~static_cast<uintptr_t>(4095);
          madvise(reinterpret_cast<void*>(page),
                  static_cast<size_t>(bpx) * elem + (addr - page),
                  MADV_WILLNEED);
        }
      }
      if (since_fold + (g1 - g0) > fold_every) {
        for (int64_t i = 0; i < bpx; ++i) {
          sum_out[i] += acc32[i];
          acc32[i] = 0;
        }
        since_fold = 0;
      }
      if (f->pixel_depth == 16) {
        sweep_tile_major<uint16_t>(bbase, f->frame_bytes, g0, g1, bpx, acc32,
                                   max_out);
      } else {
        sweep_tile_major<uint8_t>(bbase, f->frame_bytes, g0, g1, bpx, acc32,
                                  max_out);
      }
      since_fold += g1 - g0;
    }
    for (int64_t i = 0; i < bpx; ++i) sum_out[i] += acc32[i];
    delete[] acc32;
    return 0;
  }
  for (uint32_t fr = 0; fr < f->frame_count; ++fr) {
    if (fr % prefetch_win == 0 && fr + prefetch_win < f->frame_count) {
      // hint the next window's BAND slices (not whole frames): on a cold
      // cache the kernel reads in page granularity anyway, and the band
      // slice of a wide-stored scan is one contiguous run per frame
      for (uint32_t g = fr; g < fr + prefetch_win; ++g) {
        const uint8_t* p = base + static_cast<int64_t>(g) * f->frame_bytes +
                           (static_cast<int64_t>(r0) * f->width + c0) * elem;
        uintptr_t addr = reinterpret_cast<uintptr_t>(p);
        uintptr_t page = addr & ~static_cast<uintptr_t>(4095);
        // one run from the band's first to last byte within this frame
        size_t len = static_cast<size_t>((bh - 1) * f->width + bw) * elem;
        madvise(reinterpret_cast<void*>(page), len + (addr - page),
                MADV_WILLNEED);
      }
    }
    const uint8_t* fp = base + static_cast<int64_t>(fr) * f->frame_bytes;
    // strided (tall-stored) band: per-row copy loops, frame-major so each
    // frame's touched pages are visited once (full-width bands returned
    // via the tile-major path above)
    if (f->pixel_depth == 16) {
      const uint16_t* frame = reinterpret_cast<const uint16_t*>(fp);
      for (int64_t r = 0; r < bh; ++r) {
        const uint16_t* p = frame + (r0 + r) * f->width + c0;
        uint32_t* a = acc32 + r * bw;
        uint16_t* m = max_out + r * bw;
        for (int64_t i = 0; i < bw; ++i) {
          uint16_t v = p[i];
          a[i] += v;
          if (v > m[i]) m[i] = v;
        }
      }
    } else {
      for (int64_t r = 0; r < bh; ++r) {
        const uint8_t* p = fp + (r0 + r) * f->width + c0;
        uint32_t* a = acc32 + r * bw;
        uint16_t* m = max_out + r * bw;
        for (int64_t i = 0; i < bw; ++i) {
          uint16_t v = p[i];
          a[i] += v;
          if (v > m[i]) m[i] = v;
        }
      }
    }
    if (++since_fold == fold_every) {
      for (int64_t i = 0; i < bpx; ++i) {
        sum_out[i] += acc32[i];
        acc32[i] = 0;
      }
      since_fold = 0;
    }
  }
  if (since_fold) {
    for (int64_t i = 0; i < bpx; ++i) sum_out[i] += acc32[i];
  }
  delete[] acc32;
  return 0;
}

// Pass B: multi-shift disk reconstruction gathers, float64, bit-exact to
// the reference's hot loop (solex_util.py:113-134) and to the numpy path
// in io/hostreduce.py: per output pixel
//   v = src[flat_l[si][y]] * w_l[y] + src[flat_l[si][y]+right_off] * w_r[y]
// (two IEEE multiplies then one add, matching numpy's multiply/multiply/add
// sequence), optionally *256 for 8-bit sources (exact power of two), then
// a truncating uint16 store (C cast == numpy's C-style float64->uint16
// assignment for in-range values; v <= 65535 by construction since
// w_l + w_r == 1).
//
// Layout: src points at `frame_count` frames of `frame_stride` BYTES each
// (the mmap payload, or a compact band slab); flat_l is (S, ih) int64
// ELEMENT indices into a frame viewed flat (rotation pre-encoded by the
// caller); out points at the (S, ih, F_total) uint16 disk cube at column
// `0` of THIS call's frame range — out[si][y][fr] lives at
// out[(si*ih + y) * out_stride + fr], so chunked calls pass
// out_base + start and keep out_stride = F_total.
//
// This replaces numpy's per-shift np.take pair (4 temporaries, 2 gather
// passes + 3 arithmetic passes over chunk*ih doubles) with one fused
// sweep: ~2x less host memory traffic, the throttled resource here.
int ser_recon_f64(const uint8_t* src, int64_t frame_stride,
                  uint32_t frame_count, int is_u16, int upscale,
                  const int64_t* flat_l, int64_t right_off,
                  const double* w_l, const double* w_r, uint32_t S,
                  uint32_t ih, uint16_t* out, int64_t out_stride,
                  int do_prefetch) {
  if (!src || !flat_l || !w_l || !w_r || !out) return -1;
  const uint32_t prefetch_win = 256;
  uint32_t fr0 = 0;
#if defined(__AVX512F__)
  // Frame-block fast path (u16 sources).  The scalar loop below writes one
  // u16 per frame at a 2*out_stride-byte stride — every store touches a
  // fresh cache line, ~32x more write-allocate traffic than the disk's
  // actual bytes.  Re-tiling to 32-frame blocks with y inner writes each
  // 64-byte output line exactly once, and 8 f64 lanes (one 32-bit i64
  // gather per tap, low 16 bits kept) compute the identical
  // multiply/multiply/add per lane — bit-exact to the scalar statements
  // (no FMA contraction in intrinsics; fuzz-asserted in test_hostrecon).
  // The FINAL frame stays scalar: a 32-bit gather of a frame's last u16
  // reads 2 bytes into the next frame, which exists for every frame but
  // the buffer's last.
  if (is_u16 && frame_count > 32) {
    const uint32_t kBlk = 32;
    const uint32_t vlimit = frame_count - 1;  // last frame -> scalar tail
    const __m512i vlane_off = _mm512_setr_epi64(
        0, frame_stride, 2 * frame_stride, 3 * frame_stride,
        4 * frame_stride, 5 * frame_stride, 6 * frame_stride,
        7 * frame_stride);
    const __m256i low16 = _mm256_set1_epi32(0xFFFF);
    for (; fr0 + kBlk <= vlimit; fr0 += kBlk) {
      if (do_prefetch && fr0 % prefetch_win == 0 &&
          fr0 + prefetch_win < frame_count) {
        const uint8_t* p =
            src + static_cast<int64_t>(fr0 + prefetch_win) * frame_stride;
        uintptr_t addr = reinterpret_cast<uintptr_t>(p);
        uintptr_t page = addr & ~static_cast<uintptr_t>(4095);
        madvise(reinterpret_cast<void*>(page),
                static_cast<size_t>(frame_stride) * prefetch_win +
                    (addr - page),
                MADV_WILLNEED);
      }
      const uint8_t* bp = src + static_cast<int64_t>(fr0) * frame_stride;
      for (uint32_t si = 0; si < S; ++si) {
        const int64_t* fl = flat_l + static_cast<int64_t>(si) * ih;
        uint16_t* obase =
            out + static_cast<int64_t>(si) * ih * out_stride + fr0;
        for (uint32_t y = 0; y < ih; ++y) {
          const __m512d wl = _mm512_set1_pd(w_l[y]);
          const __m512d wr = _mm512_set1_pd(w_r[y]);
          const __m512i bl = _mm512_set1_epi64(fl[y] * 2);
          const __m512i br = _mm512_set1_epi64((fl[y] + right_off) * 2);
          uint16_t* orow = obase + static_cast<int64_t>(y) * out_stride;
          for (int g = 0; g < 4; ++g) {
            const uint8_t* gp =
                bp + static_cast<int64_t>(g) * 8 * frame_stride;
            const __m256i pl = _mm512_i64gather_epi32(
                _mm512_add_epi64(vlane_off, bl), gp, 1);
            const __m256i pr = _mm512_i64gather_epi32(
                _mm512_add_epi64(vlane_off, br), gp, 1);
            const __m512d dl =
                _mm512_cvtepi32_pd(_mm256_and_si256(pl, low16));
            const __m512d dr =
                _mm512_cvtepi32_pd(_mm256_and_si256(pr, low16));
            const __m512d v = _mm512_add_pd(_mm512_mul_pd(dl, wl),
                                            _mm512_mul_pd(dr, wr));
            const __m256i vi = _mm512_cvttpd_epi32(v);
            // packusdw saturates at 65535; v <= 65535*(w_l+w_r) can only
            // exceed 65535 by < 1 ulp, where the scalar cast truncates to
            // 65535 too
            const __m128i vu =
                _mm_packus_epi32(_mm256_castsi256_si128(vi),
                                 _mm256_extracti128_si256(vi, 1));
            _mm_storeu_si128(reinterpret_cast<__m128i*>(orow + g * 8), vu);
          }
        }
      }
    }
  }
#endif  // __AVX512F__
  for (uint32_t fr = fr0; fr < frame_count; ++fr) {
    if (do_prefetch && fr % prefetch_win == 0 &&
        fr + prefetch_win < frame_count) {
      const uint8_t* p = src + static_cast<int64_t>(fr + prefetch_win) *
                                   frame_stride;
      uintptr_t addr = reinterpret_cast<uintptr_t>(p);
      uintptr_t page = addr & ~static_cast<uintptr_t>(4095);
      madvise(reinterpret_cast<void*>(page),
              static_cast<size_t>(frame_stride) * prefetch_win +
                  (addr - page),
              MADV_WILLNEED);
    }
    const uint8_t* fp = src + static_cast<int64_t>(fr) * frame_stride;
    for (uint32_t si = 0; si < S; ++si) {
      const int64_t* fl = flat_l + static_cast<int64_t>(si) * ih;
      uint16_t* o = out + static_cast<int64_t>(si) * ih * out_stride + fr;
      if (is_u16) {
        const uint16_t* p = reinterpret_cast<const uint16_t*>(fp);
        for (uint32_t y = 0; y < ih; ++y) {
          double v = static_cast<double>(p[fl[y]]) * w_l[y] +
                     static_cast<double>(p[fl[y] + right_off]) * w_r[y];
          o[static_cast<int64_t>(y) * out_stride] = static_cast<uint16_t>(v);
        }
      } else {
        for (uint32_t y = 0; y < ih; ++y) {
          double v = static_cast<double>(fp[fl[y]]) * w_l[y] +
                     static_cast<double>(fp[fl[y] + right_off]) * w_r[y];
          if (upscale) v *= 256.0;
          o[static_cast<int64_t>(y) * out_stride] = static_cast<uint16_t>(v);
        }
      }
    }
  }
  return 0;
}

// Projective bilinear warp, float32, numpy-twin-exact.
//
// Mirrors ops/warp.py:warp_projective_host + warp_to_u16_host STATEMENT FOR
// STATEMENT in float32 (same left-associated coordinate sums, the same
// four masked cval taps weighted in the same multiply order, the same
// *65536 clip-truncate u16 store), so the output is BIT-identical to the
// numpy twin — which itself tracks the device warp to <=1 LSB.  The numpy
// twin pays ~15 full-image float32 temporaries (masks, clipped index
// planes, four gathered tap planes); this loop keeps everything in
// registers — 430 -> ~45 ms on the 2074x2100 bench disk.
//
// fp-contract off: a fused multiply-add rounds differently from numpy's
// separate multiply and add, which would break the bit-exactness contract.
}  // extern "C"

#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")

// src_f32: (h, w_in) C-contiguous; src_u16 variant converts v/65536.0f
// inline (exact power-of-two scale, identical to numpy's astype/divide).
// mat3: 9 doubles, row-major.  out: (out_h, out_w) uint16.
static void warp_body(const float* __restrict srcf,
                      const uint16_t* __restrict srcu, int64_t h,
                      int64_t w_in, const double* mat3, int64_t out_h,
                      int64_t out_w, float cval, uint16_t* __restrict out) {
  const float m00 = static_cast<float>(mat3[0]);
  const float m01 = static_cast<float>(mat3[1]);
  const float m02 = static_cast<float>(mat3[2]);
  const float m10 = static_cast<float>(mat3[3]);
  const float m11 = static_cast<float>(mat3[4]);
  const float m12 = static_cast<float>(mat3[5]);
  const float m20 = static_cast<float>(mat3[6]);
  const float m21 = static_cast<float>(mat3[7]);
  const float m22 = static_cast<float>(mat3[8]);
  for (int64_t y = 0; y < out_h; ++y) {
    const float gy = static_cast<float>(y);
    uint16_t* __restrict orow = out + y * out_w;
    for (int64_t x = 0; x < out_w; ++x) {
      const float gx = static_cast<float>(x);
      const float w = m20 * gx + m21 * gy + m22;
      const float sx = (m00 * gx + m01 * gy + m02) / w;
      const float sy = (m10 * gx + m11 * gy + m12) / w;
      const float x0 = floorf(sx);
      const float y0 = floorf(sy);
      const float dx = sx - x0;
      const float dy = sy - y0;
      const int64_t x0i = static_cast<int64_t>(static_cast<int32_t>(x0));
      const int64_t y0i = static_cast<int64_t>(static_cast<int32_t>(y0));
      float s[4];
      const int64_t ys[2] = {y0i, y0i + 1};
      const int64_t xs[2] = {x0i, x0i + 1};
      for (int ti = 0; ti < 4; ++ti) {
        const int64_t yi = ys[ti >> 1];
        const int64_t xi = xs[ti & 1];
        if (yi >= 0 && yi < h && xi >= 0 && xi < w_in) {
          const int64_t idx = yi * w_in + xi;
          s[ti] = srcf ? srcf[idx]
                       : static_cast<float>(srcu[idx]) / 65536.0f;
        } else {
          s[ti] = cval;
        }
      }
      const float ody = 1.0f - dy;
      const float odx = 1.0f - dx;
      const float t0 = s[0] * ody * odx;
      const float t1 = s[1] * ody * dx;
      const float t2 = s[2] * dy * odx;
      const float t3 = s[3] * dy * dx;
      const float acc = ((t0 + t1) + t2) + t3;
      float v = acc * 65536.0f;
      if (v < 0.0f) v = 0.0f;
      if (v > 65535.0f) v = 65535.0f;
      orow[x] = static_cast<uint16_t>(v);
    }
  }
}

// Batched variant: K uint16 sources warped with ONE shared matrix (the
// Doppler sweep circularises every shift with the same correction matrix,
// Solex_recon.py:120-123).  The per-pixel coordinate math (two divides,
// floors, int casts) depends only on (x, y), so it is hoisted into a
// per-row precompute reused across all K images; the per-tap float math
// is kept statement-for-statement identical to warp_body (same
// left-associated products), so each output plane is BIT-identical to K
// independent warp_u16_u16 calls (asserted by test_native warp-batch).
#if defined(__AVX512F__)
// AVX-512 lane-for-lane twin of the scalar batch body below.  Bit-exactness
// argument: under fp-contract=off every scalar float statement is one IEEE
// mul/add/sub/div, and the 512-bit intrinsics used here (_mm512_mul_ps,
// _mm512_add_ps, _mm512_sub_ps, _mm512_div_ps, _mm512_roundscale_ps with
// FROUND_TO_NEG_INF == floorf, _mm512_cvttps_epi32 == the scalar int cast's
// cvttss2si) apply the SAME correctly-rounded operation per lane, in the
// same left-associated order — so each lane reproduces the scalar dataflow
// bit-for-bit (fuzz-asserted against the numpy twin in test_native).
// Structure: a vectorised per-row coordinate precompute fills x0i/y0i/
// fraction/tap-base planes plus a per-16-lane "all four taps in bounds"
// mask; fully-interior blocks take a gather body (one 32-bit gather per
// tap-row pair fetches both adjacent u16 taps at once), everything else
// (image border, row tails) drops to a per-lane scalar path reading the
// same planes.
static void warp_body_batch_u16_avx512(
    const uint16_t* const* __restrict srcs, int64_t k, int64_t h,
    int64_t w_in, const double* mat3, int64_t out_h, int64_t out_w,
    const float* cvals, uint16_t* const* __restrict outs) {
  const float m00 = static_cast<float>(mat3[0]);
  const float m01 = static_cast<float>(mat3[1]);
  const float m02 = static_cast<float>(mat3[2]);
  const float m10 = static_cast<float>(mat3[3]);
  const float m11 = static_cast<float>(mat3[4]);
  const float m12 = static_cast<float>(mat3[5]);
  const float m20 = static_cast<float>(mat3[6]);
  const float m21 = static_cast<float>(mat3[7]);
  const float m22 = static_cast<float>(mat3[8]);
  const int64_t nb = (out_w + 15) / 16;
  const int64_t np = nb * 16;  // padded plane length
  int32_t* x0p = new int32_t[np];
  int32_t* y0p = new int32_t[np];
  int32_t* basep = new int32_t[np];
  float* dyp = new float[np];
  float* odyp = new float[np];
  float* dxp = new float[np];
  float* odxp = new float[np];
  uint16_t* bmask = new uint16_t[nb];  // interior mask per 16-lane block

  const __m512 vm00 = _mm512_set1_ps(m00);
  const __m512 vm02 = _mm512_set1_ps(m02);
  const __m512 vm10 = _mm512_set1_ps(m10);
  const __m512 vm12 = _mm512_set1_ps(m12);
  const __m512 vm20 = _mm512_set1_ps(m20);
  const __m512 vm22 = _mm512_set1_ps(m22);
  const __m512 vone = _mm512_set1_ps(1.0f);
  const __m512 vzero = _mm512_setzero_ps();
  const __m512 v65536 = _mm512_set1_ps(65536.0f);
  const __m512 v65535 = _mm512_set1_ps(65535.0f);
  const __m512i izero = _mm512_setzero_si512();
  const __m512i ilow16 = _mm512_set1_epi32(0xFFFF);
  const __m512i iwin = _mm512_set1_epi32(static_cast<int32_t>(w_in));
  const __m512i ixlim = _mm512_set1_epi32(static_cast<int32_t>(w_in - 1));
  const __m512i iylim = _mm512_set1_epi32(static_cast<int32_t>(h - 1));
  const __m512i iota =
      _mm512_setr_epi32(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15);

  for (int64_t y = 0; y < out_h; ++y) {
    const float gy = static_cast<float>(y);
    // same value the scalar body computes per pixel (identical operands)
    const __m512 vm01gy = _mm512_set1_ps(m01 * gy);
    const __m512 vm11gy = _mm512_set1_ps(m11 * gy);
    const __m512 vm21gy = _mm512_set1_ps(m21 * gy);
    for (int64_t b = 0; b < nb; ++b) {
      const __m512i vx =
          _mm512_add_epi32(_mm512_set1_epi32(static_cast<int32_t>(b * 16)),
                           iota);
      const __m512 gx = _mm512_cvtepi32_ps(vx);
      const __m512 w = _mm512_add_ps(
          _mm512_add_ps(_mm512_mul_ps(vm20, gx), vm21gy), vm22);
      const __m512 sx = _mm512_div_ps(
          _mm512_add_ps(_mm512_add_ps(_mm512_mul_ps(vm00, gx), vm01gy), vm02),
          w);
      const __m512 sy = _mm512_div_ps(
          _mm512_add_ps(_mm512_add_ps(_mm512_mul_ps(vm10, gx), vm11gy), vm12),
          w);
      const __m512 x0 = _mm512_roundscale_ps(
          sx, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
      const __m512 y0 = _mm512_roundscale_ps(
          sy, _MM_FROUND_TO_NEG_INF | _MM_FROUND_NO_EXC);
      const __m512 dx = _mm512_sub_ps(sx, x0);
      const __m512 dy = _mm512_sub_ps(sy, y0);
      const __m512i x0i = _mm512_cvttps_epi32(x0);
      const __m512i y0i = _mm512_cvttps_epi32(y0);
      // all four taps in bounds: 0 <= x0i, x0i+1 <= w_in-1 (i.e. x0i <
      // w_in-1), same for y — out-of-range float->int lanes land on
      // INT32_MIN and fail the >= 0 test
      const __mmask16 inx =
          _mm512_cmp_epi32_mask(x0i, izero, _MM_CMPINT_NLT) &
          _mm512_cmp_epi32_mask(x0i, ixlim, _MM_CMPINT_LT);
      const __mmask16 iny =
          _mm512_cmp_epi32_mask(y0i, izero, _MM_CMPINT_NLT) &
          _mm512_cmp_epi32_mask(y0i, iylim, _MM_CMPINT_LT);
      bmask[b] = static_cast<uint16_t>(inx & iny);
      const __m512i base =
          _mm512_add_epi32(_mm512_mullo_epi32(y0i, iwin), x0i);
      _mm512_storeu_si512(reinterpret_cast<void*>(x0p + b * 16), x0i);
      _mm512_storeu_si512(reinterpret_cast<void*>(y0p + b * 16), y0i);
      _mm512_storeu_si512(reinterpret_cast<void*>(basep + b * 16), base);
      _mm512_storeu_ps(dyp + b * 16, dy);
      _mm512_storeu_ps(odyp + b * 16, _mm512_sub_ps(vone, dy));
      _mm512_storeu_ps(dxp + b * 16, dx);
      _mm512_storeu_ps(odxp + b * 16, _mm512_sub_ps(vone, dx));
    }
    for (int64_t ki = 0; ki < k; ++ki) {
      const uint16_t* __restrict src = srcs[ki];
      const float cval = cvals[ki];
      uint16_t* __restrict orow = outs[ki] + y * out_w;
      for (int64_t b = 0; b < nb; ++b) {
        const int64_t xb = b * 16;
        const int64_t lanes = std::min<int64_t>(16, out_w - xb);
        if (lanes == 16 && bmask[b] == 0xFFFFu) {
          const __m512i vbase = _mm512_loadu_si512(
              reinterpret_cast<const void*>(basep + xb));
          // 32-bit gather at byte offset base*2 covers taps (x0, x0+1) of
          // the u16 row; x0+1 <= w_in-1 keeps the 4-byte read in bounds
          const __m512i g0 = _mm512_i32gather_epi32(vbase, src, 2);
          const __m512i g1 =
              _mm512_i32gather_epi32(_mm512_add_epi32(vbase, iwin), src, 2);
          const __m512 s0 = _mm512_div_ps(
              _mm512_cvtepi32_ps(_mm512_and_si512(g0, ilow16)), v65536);
          const __m512 s1 = _mm512_div_ps(
              _mm512_cvtepi32_ps(_mm512_srli_epi32(g0, 16)), v65536);
          const __m512 s2 = _mm512_div_ps(
              _mm512_cvtepi32_ps(_mm512_and_si512(g1, ilow16)), v65536);
          const __m512 s3 = _mm512_div_ps(
              _mm512_cvtepi32_ps(_mm512_srli_epi32(g1, 16)), v65536);
          const __m512 vdy = _mm512_loadu_ps(dyp + xb);
          const __m512 vody = _mm512_loadu_ps(odyp + xb);
          const __m512 vdx = _mm512_loadu_ps(dxp + xb);
          const __m512 vodx = _mm512_loadu_ps(odxp + xb);
          const __m512 t0 = _mm512_mul_ps(_mm512_mul_ps(s0, vody), vodx);
          const __m512 t1 = _mm512_mul_ps(_mm512_mul_ps(s1, vody), vdx);
          const __m512 t2 = _mm512_mul_ps(_mm512_mul_ps(s2, vdy), vodx);
          const __m512 t3 = _mm512_mul_ps(_mm512_mul_ps(s3, vdy), vdx);
          const __m512 acc =
              _mm512_add_ps(_mm512_add_ps(_mm512_add_ps(t0, t1), t2), t3);
          __m512 v = _mm512_mul_ps(acc, v65536);
          v = _mm512_max_ps(v, vzero);
          v = _mm512_min_ps(v, v65535);
          const __m512i vi = _mm512_cvttps_epi32(v);
          _mm256_storeu_si256(reinterpret_cast<__m256i*>(orow + xb),
                              _mm512_cvtepi32_epi16(vi));
        } else {
          for (int64_t i = 0; i < lanes; ++i) {
            const int64_t x = xb + i;
            const int64_t x0s = static_cast<int64_t>(x0p[x]);
            const int64_t y0s = static_cast<int64_t>(y0p[x]);
            const int64_t ys[2] = {y0s, y0s + 1};
            const int64_t xs[2] = {x0s, x0s + 1};
            float s[4];
            for (int ti = 0; ti < 4; ++ti) {
              const int64_t yi = ys[ti >> 1];
              const int64_t xi = xs[ti & 1];
              s[ti] = (yi >= 0 && yi < h && xi >= 0 && xi < w_in)
                          ? static_cast<float>(src[yi * w_in + xi]) / 65536.0f
                          : cval;
            }
            const float sdy = dyp[x];
            const float sody = odyp[x];
            const float sdx = dxp[x];
            const float sodx = odxp[x];
            const float t0 = s[0] * sody * sodx;
            const float t1 = s[1] * sody * sdx;
            const float t2 = s[2] * sdy * sodx;
            const float t3 = s[3] * sdy * sdx;
            const float acc = ((t0 + t1) + t2) + t3;
            float v = acc * 65536.0f;
            if (v < 0.0f) v = 0.0f;
            if (v > 65535.0f) v = 65535.0f;
            orow[x] = static_cast<uint16_t>(v);
          }
        }
      }
    }
  }
  delete[] x0p;
  delete[] y0p;
  delete[] basep;
  delete[] dyp;
  delete[] odyp;
  delete[] dxp;
  delete[] odxp;
  delete[] bmask;
}
#endif  // __AVX512F__

static void warp_body_batch_u16(const uint16_t* const* __restrict srcs,
                                int64_t k, int64_t h, int64_t w_in,
                                const double* mat3, int64_t out_h,
                                int64_t out_w, const float* cvals,
                                uint16_t* const* __restrict outs) {
#if defined(__AVX512F__)
  // int32 tap-base arithmetic needs h*w_in (and the per-row +w_in step)
  // inside int32; every real disk is orders of magnitude under the limit
  if (h * w_in <= static_cast<int64_t>(INT32_MAX) - w_in && w_in >= 2 &&
      h >= 2) {
    warp_body_batch_u16_avx512(srcs, k, h, w_in, mat3, out_h, out_w, cvals,
                               outs);
    return;
  }
#endif
  const float m00 = static_cast<float>(mat3[0]);
  const float m01 = static_cast<float>(mat3[1]);
  const float m02 = static_cast<float>(mat3[2]);
  const float m10 = static_cast<float>(mat3[3]);
  const float m11 = static_cast<float>(mat3[4]);
  const float m12 = static_cast<float>(mat3[5]);
  const float m20 = static_cast<float>(mat3[6]);
  const float m21 = static_cast<float>(mat3[7]);
  const float m22 = static_cast<float>(mat3[8]);
  int64_t* idx = new int64_t[out_w * 4];  // element index or -1 per tap
  float* fr = new float[out_w * 4];       // dy, ody, dx, odx per x
  for (int64_t y = 0; y < out_h; ++y) {
    const float gy = static_cast<float>(y);
    for (int64_t x = 0; x < out_w; ++x) {
      const float gx = static_cast<float>(x);
      const float w = m20 * gx + m21 * gy + m22;
      const float sx = (m00 * gx + m01 * gy + m02) / w;
      const float sy = (m10 * gx + m11 * gy + m12) / w;
      const float x0 = floorf(sx);
      const float y0 = floorf(sy);
      const int64_t x0i = static_cast<int64_t>(static_cast<int32_t>(x0));
      const int64_t y0i = static_cast<int64_t>(static_cast<int32_t>(y0));
      const int64_t ys[2] = {y0i, y0i + 1};
      const int64_t xs[2] = {x0i, x0i + 1};
      for (int ti = 0; ti < 4; ++ti) {
        const int64_t yi = ys[ti >> 1];
        const int64_t xi = xs[ti & 1];
        idx[x * 4 + ti] = (yi >= 0 && yi < h && xi >= 0 && xi < w_in)
                              ? yi * w_in + xi
                              : -1;
      }
      const float dy = sy - y0;
      const float dx = sx - x0;
      fr[x * 4 + 0] = dy;
      fr[x * 4 + 1] = 1.0f - dy;
      fr[x * 4 + 2] = dx;
      fr[x * 4 + 3] = 1.0f - dx;
    }
    for (int64_t ki = 0; ki < k; ++ki) {
      const uint16_t* __restrict src = srcs[ki];
      const float cval = cvals[ki];
      uint16_t* __restrict orow = outs[ki] + y * out_w;
      for (int64_t x = 0; x < out_w; ++x) {
        const int64_t* tap = idx + x * 4;
        float s[4];
        for (int ti = 0; ti < 4; ++ti) {
          s[ti] = tap[ti] >= 0
                      ? static_cast<float>(src[tap[ti]]) / 65536.0f
                      : cval;
        }
        const float dy = fr[x * 4 + 0];
        const float ody = fr[x * 4 + 1];
        const float dx = fr[x * 4 + 2];
        const float odx = fr[x * 4 + 3];
        const float t0 = s[0] * ody * odx;
        const float t1 = s[1] * ody * dx;
        const float t2 = s[2] * dy * odx;
        const float t3 = s[3] * dy * dx;
        const float acc = ((t0 + t1) + t2) + t3;
        float v = acc * 65536.0f;
        if (v < 0.0f) v = 0.0f;
        if (v > 65535.0f) v = 65535.0f;
        orow[x] = static_cast<uint16_t>(v);
      }
    }
  }
  delete[] idx;
  delete[] fr;
}

#pragma GCC pop_options

extern "C" {

// Batched numpy-twin-exact warp: K u16 sources, one shared matrix.
// srcs/outs are arrays of K pointers ((h, w_in) / (out_h, out_w) each,
// C-contiguous); cvals one [0,1)-scale fill value per source.
int warp_u16_u16_batch(const uint16_t* const* srcs, int64_t k, int64_t h,
                       int64_t w_in, const double* mat3, int64_t out_h,
                       int64_t out_w, const float* cvals,
                       uint16_t* const* outs) {
  if (!srcs || !mat3 || !outs || !cvals || k <= 0 || h <= 0 || w_in <= 0)
    return -1;
  warp_body_batch_u16(srcs, k, h, w_in, mat3, out_h, out_w, cvals, outs);
  return 0;
}

// numpy-twin-exact warp, float32 [0,1) source -> uint16 output.
int warp_f32_u16(const float* src, int64_t h, int64_t w_in,
                 const double* mat3, int64_t out_h, int64_t out_w,
                 float cval, uint16_t* out) {
  if (!src || !mat3 || !out || h <= 0 || w_in <= 0) return -1;
  warp_body(src, nullptr, h, w_in, mat3, out_h, out_w, cval, out);
  return 0;
}

// Same, uint16 source converted /65536 inline (one less image-sized pass).
int warp_u16_u16(const uint16_t* src, int64_t h, int64_t w_in,
                 const double* mat3, int64_t out_h, int64_t out_w,
                 float cval, uint16_t* out) {
  if (!src || !mat3 || !out || h <= 0 || w_in <= 0) return -1;
  warp_body(nullptr, src, h, w_in, mat3, out_h, out_w, cval, out);
  return 0;
}

}  // extern "C"

extern "C" {

// Zero-copy pointer to frame payload (valid until ser_close).
const uint8_t* ser_data(void* handle) {
  SerFile* f = static_cast<SerFile*>(handle);
  return f ? f->map + kHeaderSize : nullptr;
}

void ser_close(void* handle) {
  SerFile* f = static_cast<SerFile*>(handle);
  if (!f) return;
  munmap(const_cast<uint8_t*>(f->map), f->file_size);
  close(f->fd);
  delete f;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Transversalium row statistics: the per-row masked-median selection core of
// pipeline/transversalium._row_stats_host, numpy-EXACT.
//
// The numpy twin pays ~10 full-array passes (two full-width row sorts, abs
// deviations, masked where/sums) per disk image; on the 1-core host this is
// the dominant cost of the products stage for Doppler sweeps.  This kernel
// keeps each row (a few KB) L1-resident and replaces the O(W log W) sorts
// with O(W) nth_element selections.  The log-ratio input `rat` stays
// numpy-computed (np.log's SIMD polynomial is not reproducible from libm),
// and the final kept-sum runs in numpy (pairwise summation order) — this
// kernel only emits the masked kept values + counts, so every float the
// caller consumes is bit-identical to the pure-numpy path (fuzz-tested,
// tests/test_photometric.py).
//
// numpy-order selection subtleties reproduced exactly:
//  - the twin sorts the FULL-width row with invalid columns pushed to +inf,
//    and NaN sorts after inf; so for selection index i >= (count of
//    non-NaN valid values), numpy picks +inf while any invalid padding
//    exists (n < W), and NaN only when the row is fully valid;
//  - median = 0.5f * (s[(n-1)/2] + s[n/2]) in float32;
//  - s = mdev > 0 ? d / max(mdev, 1e-30f) : 0, keep = s < 2.0f (NaN-false).
// reference semantics: solex_util.py:300-340 (row ratio median/MAD clip).

namespace {

inline bool np_less(float a, float b) {
  // numpy sort order: -inf < finite < +inf < NaN (any NaN sign)
  if (std::isnan(b)) return !std::isnan(a);
  if (std::isnan(a)) return false;
  return a < b;
}

// idx-th value of numpy's FULL-width sorted row: the valid segment's
// non-NaN values merge with the (W - n) invalid +inf paddings (all >= any
// finite, == any valid +inf), and every NaN — valid or not — sorts after
// ALL infs.  sorted[0, W) = [non-NaN valid ∪ padding infs asc][NaNs].
inline float np_row_select_sorted(const float* s, int64_t n, int64_t n_nonnan,
                                  int64_t W, int64_t idx) {
  if (idx < n_nonnan) return s[idx];
  if (idx - n_nonnan < W - n) return std::numeric_limits<float>::infinity();
  return std::numeric_limits<float>::quiet_NaN();
}

// Monotone total-order key: transformed u32 compares like the float
// (negatives reversed).  Callers map NaNs to 0xFFFFFFFF separately.
inline uint32_t f32_key(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

inline float f32_unkey(uint32_t k) {
  uint32_t u = (k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k;
  float v;
  std::memcpy(&v, &u, 4);
  return v;
}

// LSD radix sort of n u32 keys (scratch tmp[n]); returns the pointer
// holding the sorted keys (keys or tmp).  Passes whose byte is constant
// across all keys are skipped — log-ratio rows cluster tightly, so most
// rows take 1-2 of the 4 passes.
inline uint32_t* radix_sort_u32(uint32_t* keys, uint32_t* tmp, int64_t n) {
  uint32_t hist[4][256];
  std::memset(hist, 0, sizeof(hist));
  for (int64_t i = 0; i < n; ++i) {
    uint32_t k = keys[i];
    ++hist[0][k & 0xFF];
    ++hist[1][(k >> 8) & 0xFF];
    ++hist[2][(k >> 16) & 0xFF];
    ++hist[3][(k >> 24) & 0xFF];
  }
  uint32_t* src = keys;
  uint32_t* dst = tmp;
  for (int pass = 0; pass < 4; ++pass) {
    const uint32_t* h = hist[pass];
    // constant byte -> identity permutation -> skip (the first nonzero
    // bucket holds either all n keys or the byte is not constant)
    bool skip = false;
    for (int b = 0; b < 256; ++b) {
      if (h[b] == static_cast<uint32_t>(n)) { skip = true; break; }
      if (h[b] != 0) break;
    }
    if (!skip) {
      uint32_t off[256];
      uint32_t sum = 0;
      for (int b = 0; b < 256; ++b) { off[b] = sum; sum += h[b]; }
      const int shift = pass * 8;
      for (int64_t i = 0; i < n; ++i) {
        uint32_t k = src[i];
        dst[off[(k >> shift) & 0xFF]++] = k;
      }
      std::swap(src, dst);
    }
  }
  return src;
}

}  // namespace

extern "C" {

// rat: (R, W) float32 log-ratios (any values at invalid columns — unread).
// row_ok/x_lo/x_hi: the interval mask (strip_mask rows are chords).
// value_out (R, W) float32: kept ? rat : 0 (invalid columns zeroed);
// nk_out (R) int64: kept count.  Caller finishes with numpy:
//   mean_r = where(nk > 0, value.sum(axis=1, dtype=f32) / maximum(nk, 1), 0)
int row_medstats_f32(const float* rat, int64_t R, int64_t W,
                     const uint8_t* row_ok, const int32_t* x_lo,
                     const int32_t* x_hi, float* value_out,
                     int64_t* nk_out) {
  if (!rat || !row_ok || !x_lo || !x_hi || !value_out || !nk_out || R < 0 ||
      W <= 0)
    return -1;
  uint32_t* keys = new (std::nothrow) uint32_t[W];
  uint32_t* ktmp = new (std::nothrow) uint32_t[W];
  float* fbuf = new (std::nothrow) float[W];
  float* db = new (std::nothrow) float[W];
  if (!keys || !ktmp || !fbuf || !db) {
    delete[] keys; delete[] ktmp; delete[] fbuf; delete[] db;
    return -2;
  }
  for (int64_t r = 0; r < R; ++r) {
    float* vrow = value_out + r * W;
    std::memset(vrow, 0, W * sizeof(float));
    nk_out[r] = 0;
    int64_t lo = x_lo[r], hi = x_hi[r];
    if (lo < 0) lo = 0;
    if (hi > W) hi = W;
    if (!row_ok[r] || hi <= lo) continue;
    const int64_t n = hi - lo;
    const float* src = rat + r * W + lo;
    const int64_t lo_i = (n - 1) / 2, hi_i = n / 2;

    bool finite = true;
    for (int64_t j = 0; j < n; ++j) {
      keys[j] = f32_key(src[j]);
      finite &= std::isfinite(src[j]);
    }

    float med, mdev;
    if (finite) {
      // fast path: radix-sort the keys once; both order statistics index
      // the sorted row directly, and the MAD median merges the V-shaped
      // |x - med| distances with a two-pointer walk (no second sort)
      const uint32_t* s = radix_sort_u32(keys, ktmp, n);
      med = 0.5f * (f32_unkey(s[lo_i]) + f32_unkey(s[hi_i]));
      if (std::isfinite(med)) {
        // insertion point of med in the sorted keys
        const uint32_t mk = f32_key(med);
        int64_t p = std::lower_bound(s, s + n, mk) - s;
        // k-th smallest |x - med|: merge distances growing leftward from
        // p-1 and rightward from p (float32 |x - med| is monotone along
        // each arm, so the merge yields exact order statistics)
        int64_t li = p - 1, ri = p;
        float d_lo = 0.0f, d_hi = 0.0f;
        for (int64_t k = 0; k <= hi_i; ++k) {
          float dl = (li >= 0)
              ? std::fabs(f32_unkey(s[li]) - med)
              : std::numeric_limits<float>::infinity();
          float dr = (ri < n)
              ? std::fabs(f32_unkey(s[ri]) - med)
              : std::numeric_limits<float>::infinity();
          float d;
          if (dl <= dr) { d = dl; --li; } else { d = dr; ++ri; }
          if (k == lo_i) d_lo = d;
          if (k == hi_i) d_hi = d;
        }
        mdev = 0.5f * (d_lo + d_hi);
      } else {
        // med overflowed to +-inf (0.5f*(a+b) can): distances are inf/NaN;
        // replicate numpy literally on the small set
        for (int64_t j = 0; j < n; ++j) db[j] = std::fabs(src[j] - med);
        std::sort(db, db + n, np_less);
        int64_t dnan = 0;
        for (int64_t j = 0; j < n; ++j) dnan += std::isnan(db[j]);
        mdev = 0.5f * (np_row_select_sorted(db, n, n - dnan, W, lo_i) +
                       np_row_select_sorted(db, n, n - dnan, W, hi_i));
      }
    } else {
      // non-finite values present (log 0/0 NaNs, log(0) infs): exact
      // numpy full-width selection semantics via a comparison sort
      for (int64_t j = 0; j < n; ++j) fbuf[j] = src[j];
      std::sort(fbuf, fbuf + n, np_less);
      int64_t nan_cnt = 0;
      for (int64_t j = 0; j < n; ++j) nan_cnt += std::isnan(fbuf[j]);
      med = 0.5f * (np_row_select_sorted(fbuf, n, n - nan_cnt, W, lo_i) +
                    np_row_select_sorted(fbuf, n, n - nan_cnt, W, hi_i));
      for (int64_t j = 0; j < n; ++j) fbuf[j] = std::fabs(src[j] - med);
      std::sort(fbuf, fbuf + n, np_less);
      int64_t dnan = 0;
      for (int64_t j = 0; j < n; ++j) dnan += std::isnan(fbuf[j]);
      mdev = 0.5f * (np_row_select_sorted(fbuf, n, n - dnan, W, lo_i) +
                     np_row_select_sorted(fbuf, n, n - dnan, W, hi_i));
    }

    const float mden = mdev > 1e-30f ? mdev : 1e-30f;
    int64_t nk = 0;
    float* vdst = vrow + lo;
    if (mdev > 0.0f) {
      for (int64_t j = 0; j < n; ++j) {
        const float s = std::fabs(src[j] - med) / mden;
        if (s < 2.0f) {
          vdst[j] = src[j];
          ++nk;
        }
      }
    } else {  // s == 0 everywhere (numpy: where(mdev>0, ..., 0)) -> keep all
      for (int64_t j = 0; j < n; ++j) vdst[j] = src[j];
      nk = n;
    }
    nk_out[r] = nk;
  }
  delete[] keys; delete[] ktmp; delete[] fbuf; delete[] db;
  return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Product-core pixel kernels (pipeline/products.py host path): the gain
// multiply, value histogram, and LUT gather each cost numpy a full-image
// pass with a temporary; fused/native they run at memory speed on the one
// host core.  All three are value-exact twins of the numpy forms (f32 IEEE
// multiply + clip + truncating uint16 cast; counting; gather).

extern "C" {

// out = (u16)clip(src * gain[row], 0, 65535); hist[out value] counted in the
// same pass (the detransversaliumed image's brightness histogram, consumed
// by the percentile stretches).  hist may be null.  reference forms:
// solex_util.py:489,515-516 (gain multiply) + 532-541 (histogram percentile).
int gain_hist_u16(const uint16_t* src, int64_t h, int64_t w,
                  const float* gain, uint16_t* out, uint32_t* hist) {
  if (!src || !gain || !out || h <= 0 || w <= 0) return -1;
  if (hist) std::memset(hist, 0, 65536 * sizeof(uint32_t));
  for (int64_t r = 0; r < h; ++r) {
    const float g = gain[r];
    const uint16_t* s = src + r * w;
    uint16_t* o = out + r * w;
    for (int64_t j = 0; j < w; ++j) {
      float v = static_cast<float>(s[j]) * g;
      v = v < 0.0f ? 0.0f : (v > 65535.0f ? 65535.0f : v);
      const uint16_t u = static_cast<uint16_t>(v);
      o[j] = u;
      if (hist) ++hist[u];
    }
  }
  return 0;
}

// Value histogram of a u16 image (np.bincount(img.ravel(), minlength=65536)
// twin, ~2x faster single-core via 4-way unrolled sub-histograms).
int hist_u16(const uint16_t* src, int64_t n, uint32_t* hist) {
  if (!src || !hist || n < 0) return -1;
  static thread_local uint32_t sub[4][65536];
  std::memset(sub, 0, sizeof(sub));
  int64_t i = 0;
  for (; i + 4 <= n; i += 4) {
    ++sub[0][src[i]];
    ++sub[1][src[i + 1]];
    ++sub[2][src[i + 2]];
    ++sub[3][src[i + 3]];
  }
  for (; i < n; ++i) ++sub[0][src[i]];
  for (int64_t v = 0; v < 65536; ++v)
    hist[v] = sub[0][v] + sub[1][v] + sub[2][v] + sub[3][v];
  return 0;
}

// out = lut[src] (uint16 value LUT gather, pipeline/products._stretch_lut).
int lut_u16(const uint16_t* src, int64_t n, const uint16_t* lut,
            uint16_t* out) {
  if (!src || !lut || !out || n < 0) return -1;
  for (int64_t i = 0; i < n; ++i) out[i] = lut[src[i]];
  return 0;
}

}  // extern "C"

extern "C" {

// Hybrid variant of row_medstats_f32: the caller pre-sorts the masked
// full-width rows with numpy (np.sort's AVX-512 qsort beats a scalar radix
// ~4x on this host: 8.4 vs ~25 ms on the bench band shape — docs/PERF.md),
// and this kernel consumes the sorted rows: both medians index them
// directly (numpy full-width semantics by construction), the MAD median
// two-pointer-merges the V-shaped |x - med| distances (invalid columns were
// masked to +inf by the caller, exactly numpy's big2 padding), and the
// keep/value pass is shared with the radix variant.  Rows containing
// non-finite log-ratios (or an overflowed med) take the exact
// comparison-sort fallback on the raw segment.
int row_medstats_sorted_f32(const float* srt, const float* rat, int64_t R,
                            int64_t W, const uint8_t* row_ok,
                            const int32_t* x_lo, const int32_t* x_hi,
                            float* value_out, int64_t* nk_out) {
  if (!srt || !rat || !row_ok || !x_lo || !x_hi || !value_out || !nk_out ||
      R < 0 || W <= 0)
    return -1;
  float* fbuf = new (std::nothrow) float[W];
  if (!fbuf) return -2;
  for (int64_t r = 0; r < R; ++r) {
    float* vrow = value_out + r * W;
    std::memset(vrow, 0, W * sizeof(float));
    nk_out[r] = 0;
    int64_t lo = x_lo[r], hi = x_hi[r];
    if (lo < 0) lo = 0;
    if (hi > W) hi = W;
    if (!row_ok[r] || hi <= lo) continue;
    const int64_t n = hi - lo;
    const float* src = rat + r * W + lo;
    const float* s = srt + r * W;
    const int64_t lo_i = (n - 1) / 2, hi_i = n / 2;
    const float med = 0.5f * (s[lo_i] + s[hi_i]);

    // the fast path needs a finite med and no NaN anywhere in the row's
    // valid values (NaNs sort to srt[W-1]); valid +-infs are fine — their
    // distances are inf, indistinguishable from numpy's invalid-padding
    // infs in the distance multiset, which is exactly numpy's big2
    const bool finite = std::isfinite(med) && !std::isnan(s[W - 1]);
    float mdev;
    if (finite) {
      // j-th smallest |x - med| over the sorted row: the (j+1) closest
      // elements form a contiguous window; binary-search its left edge
      // (classic k-closest), the j-th distance is the window's worse end
      auto kth_dist = [&](int64_t j) -> float {
        int64_t l = 0, r = W - 1 - j;
        while (l < r) {
          const int64_t mid = (l + r) / 2;
          if (med - s[mid] > s[mid + j + 1] - med)
            l = mid + 1;
          else
            r = mid;
        }
        const float dl = std::fabs(s[l] - med);
        const float dr = std::fabs(s[l + j] - med);
        return dl > dr ? dl : dr;
      };
      const float d_lo = kth_dist(lo_i);
      const float d_hi = (hi_i == lo_i) ? d_lo : kth_dist(hi_i);
      mdev = 0.5f * (d_lo + d_hi);
    } else {
      // exact numpy full-width selection semantics on the raw segment
      for (int64_t j = 0; j < n; ++j) fbuf[j] = src[j];
      std::sort(fbuf, fbuf + n, np_less);
      int64_t nan_cnt = 0;
      for (int64_t j = 0; j < n; ++j) nan_cnt += std::isnan(fbuf[j]);
      const float m2 =
          0.5f * (np_row_select_sorted(fbuf, n, n - nan_cnt, W, lo_i) +
                  np_row_select_sorted(fbuf, n, n - nan_cnt, W, hi_i));
      for (int64_t j = 0; j < n; ++j) fbuf[j] = std::fabs(src[j] - m2);
      std::sort(fbuf, fbuf + n, np_less);
      int64_t dnan = 0;
      for (int64_t j = 0; j < n; ++j) dnan += std::isnan(fbuf[j]);
      mdev = 0.5f * (np_row_select_sorted(fbuf, n, n - dnan, W, lo_i) +
                     np_row_select_sorted(fbuf, n, n - dnan, W, hi_i));
      const float mden2 = mdev > 1e-30f ? mdev : 1e-30f;
      int64_t nk2 = 0;
      float* vdst2 = vrow + lo;
      if (mdev > 0.0f) {
        for (int64_t j = 0; j < n; ++j) {
          if (std::fabs(src[j] - m2) / mden2 < 2.0f) {
            vdst2[j] = src[j];
            ++nk2;
          }
        }
      } else {
        for (int64_t j = 0; j < n; ++j) vdst2[j] = src[j];
        nk2 = n;
      }
      nk_out[r] = nk2;
      continue;
    }

    const float mden = mdev > 1e-30f ? mdev : 1e-30f;
    int64_t nk = 0;
    float* vdst = vrow + lo;
    if (mdev > 0.0f) {
      for (int64_t j = 0; j < n; ++j) {
        if (std::fabs(src[j] - med) / mden < 2.0f) {
          vdst[j] = src[j];
          ++nk;
        }
      }
    } else {
      for (int64_t j = 0; j < n; ++j) vdst[j] = src[j];
      nk = n;
    }
    nk_out[r] = nk;
  }
  delete[] fbuf;
  return 0;
}

}  // extern "C"

extern "C" {

// out[r, j] = (row_ok[r] && x_lo[r] <= j < x_hi[r]) ? src[r, j] : +inf —
// the masked-row build for the sorted-hybrid row stats in ONE pass
// (numpy needs a boolean-mask build plus a where, ~3x the traffic).
int mask_interval_f32(const float* src, int64_t R, int64_t W,
                      const uint8_t* row_ok, const int32_t* x_lo,
                      const int32_t* x_hi, float* out) {
  if (!src || !row_ok || !x_lo || !x_hi || !out || R < 0 || W <= 0) return -1;
  const float inf = std::numeric_limits<float>::infinity();
  for (int64_t r = 0; r < R; ++r) {
    float* o = out + r * W;
    int64_t lo = x_lo[r], hi = x_hi[r];
    if (lo < 0) lo = 0;
    if (hi > W) hi = W;
    if (!row_ok[r] || hi <= lo) {
      for (int64_t j = 0; j < W; ++j) o[j] = inf;
      continue;
    }
    for (int64_t j = 0; j < lo; ++j) o[j] = inf;
    std::memcpy(o + lo, src + r * W + lo, (hi - lo) * sizeof(float));
    for (int64_t j = hi; j < W; ++j) o[j] = inf;
  }
  return 0;
}

}  // extern "C"

// --- exact box blur (ops/blur.py host-twin, native) --------------------
// Bit-identical twin of ops/blur.box_blur_host for uint16 input: int32
// sliding-window sums over a reflect-101 border (integer addition is
// order-independent, so any summation order is exact), then the same
// quotient/remainder float32 split, and (u16 output) the same
// round-half-to-even + clip.  Kernels larger than the image fall back to
// the numpy twin in the Python wrapper (multiple reflections).
// reference forms: cv2.blur call sites solex_util.py:168,230,
// ellipse_to_circle.py:163,241.

namespace {

inline int64_t reflect101(int64_t i, int64_t n) {
  // single reflection only (caller guarantees pad < n)
  if (i < 0) return -i;
  if (i >= n) return 2 * n - 2 - i;
  return i;
}

}  // namespace

extern "C" {

// out_f32 and/or out_u16 may each be null (at least one required).
int box_blur_u16_exact(const uint16_t* src, int64_t h, int64_t w, int kx,
                       int ky, float* out_f32, uint16_t* out_u16) {
  if (!src || h <= 0 || w <= 0 || kx < 1 || ky < 1 ||
      (!out_f32 && !out_u16))
    return -1;
  const int64_t lo_y = ky / 2, hi_y = ky - 1 - ky / 2;
  const int64_t lo_x = kx / 2, hi_x = kx - 1 - kx / 2;
  // reflect-101 is single-bounce only when the pad fits inside the axis
  if ((lo_y > h - 1) || (hi_y > h - 1) || (lo_x > w - 1) || (hi_x > w - 1))
    return -3;
  // 65535 * kx * ky must fit int32: beyond this the numpy twin wraps
  // (identically to the device program) while s / ki would truncate —
  // reject so the wrapper keeps that case on the numpy path
  if (static_cast<int64_t>(kx) * ky > 32767) return -3;
  const float k = static_cast<float>(kx) * static_cast<float>(ky);
  const int32_t ki = static_cast<int32_t>(kx) * static_cast<int32_t>(ky);

  int32_t* vs = new (std::nothrow) int32_t[w];          // vertical sums
  int32_t* pad = new (std::nothrow) int32_t[w + kx - 1];  // padded row
  if (!vs || !pad) {
    delete[] vs;
    delete[] pad;
    return -2;
  }

  // initial vertical window for output row 0: rows -lo_y .. hi_y
  std::memset(vs, 0, w * sizeof(int32_t));
  for (int64_t r = -lo_y; r <= hi_y; ++r) {
    const uint16_t* s = src + reflect101(r, h) * w;
    for (int64_t j = 0; j < w; ++j) vs[j] += s[j];
  }

  for (int64_t r = 0; r < h; ++r) {
    if (r > 0) {
      const uint16_t* add = src + reflect101(r + hi_y, h) * w;
      const uint16_t* sub = src + reflect101(r - 1 - lo_y, h) * w;
      for (int64_t j = 0; j < w; ++j)
        vs[j] += static_cast<int32_t>(add[j]) - static_cast<int32_t>(sub[j]);
    }
    // horizontal pass over the reflect-101-padded vertical sums
    for (int64_t j = 0; j < lo_x; ++j) pad[j] = vs[lo_x - j];
    std::memcpy(pad + lo_x, vs, w * sizeof(int32_t));
    for (int64_t j = 0; j < hi_x; ++j) pad[lo_x + w + j] = vs[w - 2 - j];
    int32_t s = 0;
    for (int64_t j = 0; j < kx; ++j) s += pad[j];
    float* of = out_f32 ? out_f32 + r * w : nullptr;
    uint16_t* ou = out_u16 ? out_u16 + r * w : nullptr;
    for (int64_t c = 0; c < w; ++c) {
      const int32_t q = s / ki;          // s >= 0: trunc == floor
      const int32_t rem = s - q * ki;
      const float v =
          static_cast<float>(q) + static_cast<float>(rem) / k;
      if (of) of[c] = v;
      if (ou) {
        float rv = nearbyintf(v);  // FE_TONEAREST: round-half-to-even
        rv = rv < 0.0f ? 0.0f : (rv > 65535.0f ? 65535.0f : rv);
        ou[c] = static_cast<uint16_t>(rv);
      }
      if (c + 1 < w) s += pad[c + kx] - pad[c];
    }
  }
  delete[] vs;
  delete[] pad;
  return 0;
}

}  // extern "C"

extern "C" {

// PNG grayscale scanline pack: each row of the (n_rows, w) source becomes
// [filter byte 0][w big-endian samples] in `out` (n_rows * (1 + bpp*w)
// bytes).  BIT-identical to the numpy pack in io/png.py (astype('>u2')
// bytes behind a zero filter byte) — the shared Python framing around it
// guarantees identical PNG files whichever side packs.  u16 sources are
// byteswapped; u8 copied.  The shift pair autovectorises under
// -march=native (gcc emits vpshufb byte swaps).
int png_pack_rows(const void* src, int64_t n_rows, int64_t w, int is16,
                  uint8_t* out) {
  if (!src || !out || n_rows < 0 || w <= 0) return -1;
  if (is16) {
    const uint16_t* s0 = static_cast<const uint16_t*>(src);
    const int64_t line = 1 + 2 * w;
    for (int64_t r = 0; r < n_rows; ++r) {
      const uint16_t* sp = s0 + r * w;
      uint8_t* op = out + r * line;
      op[0] = 0;
      uint8_t* od = op + 1;
      for (int64_t x = 0; x < w; ++x) {
        const uint16_t v = sp[x];
        od[2 * x] = static_cast<uint8_t>(v >> 8);
        od[2 * x + 1] = static_cast<uint8_t>(v & 0xFF);
      }
    }
  } else {
    const uint8_t* s0 = static_cast<const uint8_t*>(src);
    const int64_t line = 1 + w;
    for (int64_t r = 0; r < n_rows; ++r) {
      out[r * line] = 0;
      memcpy(out + r * line + 1, s0 + r * w, static_cast<size_t>(w));
    }
  }
  return 0;
}

}  // extern "C"

extern "C" {

// FITS BITPIX=16/BZERO=32768 payload pack in one pass:
// out[i] = bswap16(src[i] ^ 0x8000) — the xor equals the wraparound
// -32768 offset (two's complement), the swap is the big-endian store.
// Autovectorises under -march=native.
int fits_pack_u16(const uint16_t* src, int64_t n, uint16_t* out) {
  if (!src || !out || n < 0) return -1;
  for (int64_t i = 0; i < n; ++i) {
    const uint16_t v = static_cast<uint16_t>(src[i] ^ 0x8000u);
    out[i] = static_cast<uint16_t>((v >> 8) | (v << 8));
  }
  return 0;
}

}  // extern "C"

extern "C" {

// cv2-exact CLAHE on a uint16 image (OpenCV modules/imgproc clahe.cpp
// semantics; the reference calls cv2.createCLAHE(clipLimit=0.8,
// tileGridSize=(2,2)).apply on the final disk, solex_util.py:532-533).
// Pipeline:
//   1. BORDER_REFLECT_101 pad (right/bottom) to a tile-grid multiple —
//      histogram accumulation only, via reflected indices (no copy);
//   2. per-tile 65536-bin histogram, clip at
//      max(int(clip_limit*tile_area/65536), 1), uniform redistribution +
//      residual at stride max(65536/residual, 1);
//   3. LUT[i] = saturate_cast<u16>(cdf * (65535.0f/tile_area)) with
//      round-to-nearest-even (cvRound);
//   4. bilinear interpolation of the 4 neighbouring tile LUTs over the
//      ORIGINAL grid, float32 ops in cv2's exact association
//      (l11*xa1 + l12*xa)*ya1 + (l21*xa1 + l22*xa)*ya — the AVX-512 path
//      uses explicit mul/add (no FMA contraction) so every lane rounds
//      like cv2's scalar body.
// `out_hist` (optional, 65536 u32) accumulates the OUTPUT value histogram
// in the same pass — the product stage's percentile stretch needs it and
// the row is still in L1.  Bit-identity vs cv2 is fuzz-asserted in
// tests/test_clahe.py.
int clahe_u16(const uint16_t* src, int64_t h, int64_t w, int tiles_x,
              int tiles_y, double clip_limit, uint16_t* out,
              uint32_t* out_hist) {
  if (!src || !out || h <= 0 || w <= 0 || tiles_x <= 0 || tiles_y <= 0)
    return -1;
  constexpr int kHist = 65536;
  // cv2 pads BOTH axes whenever EITHER is non-divisible, each by
  // tiles - (dim % tiles) — a FULL extra tile on an already-divisible
  // axis (CLAHE_Impl::apply's copyMakeBorder takes the else branch for
  // both dimensions at once)
  int64_t pw = w, ph = h;
  if (w % tiles_x != 0 || h % tiles_y != 0) {
    pw = w + (tiles_x - (w % tiles_x));
    ph = h + (tiles_y - (h % tiles_y));
    // single-bounce reflect101 only: pad > dim-1 would need multi-bounce
    if (pw - w > w - 1 || ph - h > h - 1) return -1;
  }
  const int64_t tw = pw / tiles_x, th = ph / tiles_y;
  const int64_t tile_area = tw * th;
  if (tile_area > (int64_t)std::numeric_limits<int>::max()) return -1;
  int clip = 0;
  if (clip_limit > 0.0) {
    clip = static_cast<int>(clip_limit * static_cast<double>(tile_area) /
                            kHist);
    if (clip < 1) clip = 1;
  }
  const float lut_scale =
      static_cast<float>(kHist - 1) / static_cast<float>(tile_area);
  const int T = tiles_x * tiles_y;
  // +2 slots: the 32-bit gathers read 4 bytes at the last element
  uint16_t* lut = new (std::nothrow) uint16_t[(size_t)T * kHist + 2];
  // 4 interleaved sub-histograms: hist[v]++ on a smooth solar disk hits
  // long runs of equal values whose store-to-load dependency chains
  // dominate a single-array build; four banks break the chains and the
  // 3*65536 merge adds autovectorise
  uint32_t* hist4 = new (std::nothrow) uint32_t[4 * kHist];
  int* thist = new (std::nothrow) int[kHist];
  if (!lut || !hist4 || !thist) {
    delete[] lut; delete[] hist4; delete[] thist;
    return -1;
  }

  for (int tyi = 0; tyi < tiles_y; ++tyi) {
    for (int txi = 0; txi < tiles_x; ++txi) {
      memset(hist4, 0, sizeof(uint32_t) * 4 * kHist);
      const int64_t x0 = (int64_t)txi * tw, x1 = x0 + tw;
      const int64_t xin = x1 < w ? x1 : w;
      for (int64_t yy = tyi * th; yy < (tyi + 1) * th; ++yy) {
        const int64_t sy = yy < h ? yy : 2 * h - 2 - yy;
        const uint16_t* row = src + sy * w;
        int64_t xx = x0;
        for (; xx + 4 <= xin; xx += 4) {
          ++hist4[row[xx]];
          ++hist4[(size_t)kHist + row[xx + 1]];
          ++hist4[(size_t)2 * kHist + row[xx + 2]];
          ++hist4[(size_t)3 * kHist + row[xx + 3]];
        }
        for (; xx < xin; ++xx) ++hist4[row[xx]];
        for (; xx < x1; ++xx) ++hist4[row[2 * w - 2 - xx]];  // reflect101
      }
      for (int i = 0; i < kHist; ++i)
        thist[i] = (int)(hist4[i] + hist4[kHist + i] + hist4[2 * kHist + i] +
                         hist4[3 * kHist + i]);
      if (clip > 0) {
        int clipped = 0;
        for (int i = 0; i < kHist; ++i) {
          if (thist[i] > clip) {
            clipped += thist[i] - clip;
            thist[i] = clip;
          }
        }
        const int redist = clipped / kHist;
        int residual = clipped - redist * kHist;
        if (redist)
          for (int i = 0; i < kHist; ++i) thist[i] += redist;
        if (residual != 0) {
          const int step = kHist / residual > 1 ? kHist / residual : 1;
          for (int i = 0; i < kHist && residual > 0; i += step, --residual)
            ++thist[i];
        }
      }
      uint16_t* tl = lut + (size_t)(tyi * tiles_x + txi) * kHist;
      int sum = 0;
      for (int i = 0; i < kHist; ++i) {
        sum += thist[i];
        // cv2: saturate_cast<ushort>(sum * lutScale) — float multiply,
        // round-to-nearest-even (cvRound), clamp
        const float v = (float)sum * lut_scale;
#if defined(__AVX512F__)
        int r = _mm_cvtss_si32(_mm_set_ss(v));
#else
        int r = (int)std::nearbyintf(v);
#endif
        if (r < 0) r = 0;
        if (r > 65535) r = 65535;
        tl[i] = (uint16_t)r;
      }
    }
  }
  delete[] thist;

  // per-column interpolation precompute (cv2 body's ind1_p/xa_p tables)
  int32_t* ind1p = new (std::nothrow) int32_t[w];
  int32_t* ind2p = new (std::nothrow) int32_t[w];
  float* xap = new (std::nothrow) float[w];
  float* xa1p = new (std::nothrow) float[w];
  if (!ind1p || !ind2p || !xap || !xa1p) {
    delete[] lut; delete[] hist4;
    delete[] ind1p; delete[] ind2p; delete[] xap; delete[] xa1p;
    return -1;
  }
  const float inv_tw = 1.0f / (float)tw;
  for (int64_t x = 0; x < w; ++x) {
    const float txf = (float)x * inv_tw - 0.5f;
    int tx1 = (int)std::floor(txf);
    int tx2 = tx1 + 1;
    xap[x] = txf - (float)tx1;
    xa1p[x] = 1.0f - xap[x];
    tx1 = tx1 > 0 ? tx1 : 0;
    tx2 = tx2 < tiles_x - 1 ? tx2 : tiles_x - 1;
    ind1p[x] = tx1 * kHist;
    ind2p[x] = tx2 * kHist;
  }
  uint32_t* oh4 = nullptr;
  if (out_hist) {
    oh4 = hist4;  // reuse: four interleaved output-histogram banks
    memset(oh4, 0, sizeof(uint32_t) * 4 * kHist);
  }
  const float inv_th = 1.0f / (float)th;
  for (int64_t y = 0; y < h; ++y) {
    const uint16_t* srow = src + y * w;
    uint16_t* drow = out + y * w;
    const float tyf = (float)y * inv_th - 0.5f;
    int ty1 = (int)std::floor(tyf);
    int ty2 = ty1 + 1;
    const float ya = tyf - (float)ty1, ya1 = 1.0f - ya;
    ty1 = ty1 > 0 ? ty1 : 0;
    ty2 = ty2 < tiles_y - 1 ? ty2 : tiles_y - 1;
    const uint16_t* p1 = lut + (size_t)(ty1 * tiles_x) * kHist;
    const uint16_t* p2 = lut + (size_t)(ty2 * tiles_x) * kHist;
    int64_t x = 0;
#if defined(__AVX512F__)
    const __m512 vya = _mm512_set1_ps(ya);
    const __m512 vya1 = _mm512_set1_ps(ya1);
    const __m512i vlow16 = _mm512_set1_epi32(0xFFFF);
    const __m512i vmax = _mm512_set1_epi32(65535);
    const __m512i vzero = _mm512_setzero_si512();
    for (; x + 16 <= w; x += 16) {
      const __m512i sv = _mm512_cvtepu16_epi32(
          _mm256_loadu_si256((const __m256i*)(srow + x)));
      const __m512i i1 =
          _mm512_add_epi32(sv, _mm512_loadu_si512(ind1p + x));
      const __m512i i2 =
          _mm512_add_epi32(sv, _mm512_loadu_si512(ind2p + x));
      const __m512 g11 = _mm512_cvtepi32_ps(_mm512_and_si512(
          _mm512_i32gather_epi32(i1, p1, 2), vlow16));
      const __m512 g12 = _mm512_cvtepi32_ps(_mm512_and_si512(
          _mm512_i32gather_epi32(i2, p1, 2), vlow16));
      const __m512 g21 = _mm512_cvtepi32_ps(_mm512_and_si512(
          _mm512_i32gather_epi32(i1, p2, 2), vlow16));
      const __m512 g22 = _mm512_cvtepi32_ps(_mm512_and_si512(
          _mm512_i32gather_epi32(i2, p2, 2), vlow16));
      const __m512 vxa = _mm512_loadu_ps(xap + x);
      const __m512 vxa1 = _mm512_loadu_ps(xa1p + x);
      // cv2's exact association, explicit mul/add (no contraction)
      const __m512 r1 = _mm512_add_ps(_mm512_mul_ps(g11, vxa1),
                                      _mm512_mul_ps(g12, vxa));
      const __m512 r2 = _mm512_add_ps(_mm512_mul_ps(g21, vxa1),
                                      _mm512_mul_ps(g22, vxa));
      const __m512 res = _mm512_add_ps(_mm512_mul_ps(r1, vya1),
                                       _mm512_mul_ps(r2, vya));
      // cvRound: cvtps_epi32 under the default MXCSR mode (nearest-even)
      __m512i ri = _mm512_cvtps_epi32(res);
      ri = _mm512_max_epi32(ri, vzero);
      ri = _mm512_min_epi32(ri, vmax);
      _mm256_storeu_si256((__m256i*)(drow + x), _mm512_cvtepi32_epi16(ri));
    }
#endif
    for (; x < w; ++x) {
      const int sv = srow[x];
      const int i1 = ind1p[x] + sv;
      const int i2 = ind2p[x] + sv;
      const float res = ((float)p1[i1] * xa1p[x] + (float)p1[i2] * xap[x]) *
                            ya1 +
                        ((float)p2[i1] * xa1p[x] + (float)p2[i2] * xap[x]) *
                            ya;
#if defined(__AVX512F__)
      int r = _mm_cvtss_si32(_mm_set_ss(res));
#else
      int r = (int)std::nearbyintf(res);
#endif
      if (r < 0) r = 0;
      if (r > 65535) r = 65535;
      drow[x] = (uint16_t)r;
    }
    if (oh4) {
      int64_t i = 0;
      for (; i + 4 <= w; i += 4) {
        ++oh4[drow[i]];
        ++oh4[(size_t)kHist + drow[i + 1]];
        ++oh4[(size_t)2 * kHist + drow[i + 2]];
        ++oh4[(size_t)3 * kHist + drow[i + 3]];
      }
      for (; i < w; ++i) ++oh4[drow[i]];
    }
  }
  if (out_hist)
    for (int i = 0; i < kHist; ++i)
      out_hist[i] =
          oh4[i] + oh4[kHist + i] + oh4[2 * kHist + i] + oh4[3 * kHist + i];
  delete[] ind1p; delete[] ind2p; delete[] xap; delete[] xa1p;
  delete[] lut; delete[] hist4;
  return 0;
}

}  // extern "C"

namespace {

// zlib-polynomial CRC-32 (reflected 0xEDB88320), slicing-by-8: the PNG
// chunk CRC.  SSE4.2's crc32 instruction is CRC-32C (Castagnoli) — a
// DIFFERENT polynomial — so a table implementation it is.
uint32_t g_crc_tab[8][256];
bool g_crc_init = false;

void crc32_init() {
  if (g_crc_init) return;
  for (uint32_t i = 0; i < 256; ++i) {
    uint32_t c = i;
    for (int k = 0; k < 8; ++k) c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
    g_crc_tab[0][i] = c;
  }
  for (uint32_t i = 0; i < 256; ++i)
    for (int t = 1; t < 8; ++t)
      g_crc_tab[t][i] =
          g_crc_tab[0][g_crc_tab[t - 1][i] & 0xFF] ^ (g_crc_tab[t - 1][i] >> 8);
  g_crc_init = true;
}

uint32_t crc32_update(uint32_t crc, const uint8_t* p, size_t n) {
  crc = ~crc;
  while (n && ((uintptr_t)p & 7)) {
    crc = g_crc_tab[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
    --n;
  }
  while (n >= 8) {
    uint32_t lo;
    uint32_t hi;
    memcpy(&lo, p, 4);
    memcpy(&hi, p + 4, 4);
    crc ^= lo;
    crc = g_crc_tab[7][crc & 0xFF] ^ g_crc_tab[6][(crc >> 8) & 0xFF] ^
          g_crc_tab[5][(crc >> 16) & 0xFF] ^ g_crc_tab[4][crc >> 24] ^
          g_crc_tab[3][hi & 0xFF] ^ g_crc_tab[2][(hi >> 8) & 0xFF] ^
          g_crc_tab[1][(hi >> 16) & 0xFF] ^ g_crc_tab[0][hi >> 24];
    p += 8;
    n -= 8;
  }
  while (n--) crc = g_crc_tab[0][(crc ^ *p++) & 0xFF] ^ (crc >> 8);
  return ~crc;
}

// adler32 (zlib stream checksum) with the standard 5552-byte deferral of
// the mod; scalar is plenty next to the CRC.
uint32_t adler32_update(uint32_t adler, const uint8_t* p, size_t n) {
  uint32_t a = adler & 0xFFFF, b = adler >> 16;
  while (n) {
    size_t blk = n < 5552 ? n : 5552;
    n -= blk;
    size_t i = 0;
    for (; i + 8 <= blk; i += 8) {
      a += p[0]; b += a; a += p[1]; b += a; a += p[2]; b += a;
      a += p[3]; b += a; a += p[4]; b += a; a += p[5]; b += a;
      a += p[6]; b += a; a += p[7]; b += a;
      p += 8;
    }
    for (; i < blk; ++i) { a += *p++; b += a; }
    a %= 65521; b %= 65521;
  }
  return (b << 16) | a;
}

}  // namespace

extern "C" {

// One PNG IDAT band in a single pass: pack the (n_rows, w) source into
// zlib stored-block framing ([filter 0][big-endian samples] per row,
// blocks split at exactly 65535 bytes within the band), update the
// zlib adler32 over the scanline payload, and compute the chunk crc32
// over the emitted bytes — all while each block is still cache-hot.
// Byte-identical to io/png.py's _pack_scanlines + _stored_parts +
// zlib.adler32/crc32 composition (asserted in tests/test_io.py).
//   first: prepend the 2-byte zlib header; final: append the adler
//   trailer after the last block (which gets BFINAL=1).
//   crc_in: running crc (python seeds with crc32(b"IDAT")).
// out must hold 2*first + payload + 5*ceil(payload/65535) + 4*final
// bytes where payload = n_rows*(1 + bpp*w).  Returns emitted length,
// or -1 on bad args.
int64_t png_encode_stored_band(const void* src, int64_t n_rows, int64_t w,
                               int is16, int first, int final,
                               uint32_t adler_in, uint32_t crc_in,
                               uint8_t* out, uint32_t* adler_out,
                               uint32_t* crc_out) {
  if (!src || !out || n_rows < 0 || w <= 0 || !adler_out || !crc_out)
    return -1;
  crc32_init();
  const int64_t bpr = 1 + (is16 ? 2 * w : w);  // bytes per packed row
  const int64_t payload = n_rows * bpr;
  uint8_t* op = out;
  if (first) {
    op[0] = 0x78; op[1] = 0x01;  // 32K window, fastest-compression hint
    op += 2;
  }
  // walk rows, emitting stored-block headers at 65535-byte boundaries
  int64_t emitted = 0;       // payload bytes emitted so far
  int64_t block_left = 0;    // room left in the current stored block
  const uint8_t* s8 = static_cast<const uint8_t*>(src);
  const uint16_t* s16 = static_cast<const uint16_t*>(src);
  for (int64_t r = 0; r < n_rows; ++r) {
    // stage one packed row into a small stack buffer? no — pack straight
    // into out, splitting headers mid-row when a block boundary lands
    // inside the row
    uint8_t rowbuf_filter = 0;
    int64_t row_pos = 0;  // position within this packed row
    while (row_pos < bpr) {
      if (block_left == 0) {
        const int64_t rest = payload - emitted;
        const int64_t blk = rest < 65535 ? rest : 65535;
        const int last_of_image = final && (blk == rest);
        op[0] = last_of_image ? 1 : 0;
        op[1] = (uint8_t)(blk & 0xFF);
        op[2] = (uint8_t)(blk >> 8);
        op[3] = (uint8_t)(~blk & 0xFF);
        op[4] = (uint8_t)((~blk >> 8) & 0xFF);
        op += 5;
        block_left = blk;
      }
      int64_t take = bpr - row_pos;
      if (take > block_left) take = block_left;
      // pack `take` payload bytes of this row at row_pos
      int64_t t = take;
      if (row_pos == 0 && t > 0) {
        *op++ = rowbuf_filter;  // filter byte
        ++row_pos; --t;
      }
      if (is16) {
        // sample bytes: big-endian u16; row_pos-1 is the byte offset
        // into the sample stream of this row
        const uint16_t* sp = s16 + r * w;
        int64_t byte_off = row_pos - 1;
        // head: odd byte (low half of a sample already half-emitted)
        if (byte_off & 1) {
          *op++ = (uint8_t)(sp[byte_off >> 1] & 0xFF);
          ++byte_off; ++row_pos; --t;
        }
        int64_t x = byte_off >> 1;
        for (; t >= 2; t -= 2, ++x) {
          const uint16_t v = sp[x];
          op[0] = (uint8_t)(v >> 8);
          op[1] = (uint8_t)(v & 0xFF);
          op += 2;
        }
        row_pos = 1 + 2 * x;
        if (t == 1) {  // block splits a sample: emit the high byte only
          *op++ = (uint8_t)(sp[x] >> 8);
          ++row_pos;
        }
      } else {
        memcpy(op, s8 + r * w + (row_pos - 1), (size_t)t);
        op += t;
        row_pos += t;
      }
      emitted += take;
      block_left -= take;
    }
  }
  // adler over the payload only = over everything between the framing
  // bytes; computing it on the packed output in one linear sweep needs
  // the block headers skipped — walk the emitted stream again block by
  // block (still cache-resident for typical band sizes)
  {
    uint32_t adler = adler_in;
    const uint8_t* p = out + (first ? 2 : 0);
    int64_t left = payload;
    while (left > 0) {
      const int64_t blk = left < 65535 ? left : 65535;
      adler = adler32_update(adler, p + 5, (size_t)blk);
      p += 5 + blk;
      left -= blk;
    }
    *adler_out = adler;
  }
  if (final) {
    const uint32_t adler = *adler_out;
    op[0] = (uint8_t)(adler >> 24);
    op[1] = (uint8_t)((adler >> 16) & 0xFF);
    op[2] = (uint8_t)((adler >> 8) & 0xFF);
    op[3] = (uint8_t)(adler & 0xFF);
    op += 4;
  }
  const int64_t total = op - out;
  *crc_out = crc32_update(crc_in, out, (size_t)total);
  return total;
}

}  // extern "C"
