// Host half of the served path: the run-length wires read back from the
// card, decoded to RGB or to palette-index rows, and the raw stream of a
// palette PNG's IDAT.
//
// The port's own copies of the decoders of native/pngenc.cpp
// (osmr_rle_decode_packed, osmr_rle_decode_words,
// osmr_rle_decode_words_idx), with the same wire formats and results,
// and osmr_png8_filter_up, the scanline filter of its
// osmr_png_encode_pal.  It needs neither libdeflate nor zlib.h: the
// caller (draw/png8.py) deflates the filtered stream with Python's zlib
// and writes the chunks.  Plain g++, no CUDA.

#include <cstdint>
#include <cstring>

namespace {

inline uint32_t word_at(const int32_t* packed32, int64_t k) {
  const uint32_t pair = uint32_t(packed32[k >> 1]);
  return (k & 1) ? (pair >> 16) : (pair & 0xFFFF);
}

inline void fill_rgb(uint8_t* out_rgb, int64_t pos, int64_t len, uint32_t v) {
  const uint8_t c0 = uint8_t(v >> 16), c1 = uint8_t(v >> 8), c2 = uint8_t(v);
  uint8_t* p = out_rgb + pos * 3;
  for (int64_t k = 0; k < len; ++k) {
    p[0] = c0;
    p[1] = c1;
    p[2] = c2;
    p += 3;
  }
}

}  // namespace

extern "C" {

// One tile's slice of the v1 wire: one int32 a run, (len-1) << 24 |
// 0xRRGGBB, row-major over h * w pixels -> interleaved RGB8.  Returns 1,
// or 0 when the runs do not cover exactly h * w pixels.
int32_t osmr_rle_decode_packed(const int32_t* packed, int32_t n_runs, int32_t h,
                               int32_t w, uint8_t* out_rgb) {
  const int64_t total = int64_t(h) * w;
  int64_t pos = 0;
  for (int32_t r = 0; r < n_runs; ++r) {
    const uint32_t pv = uint32_t(packed[r]);
    const int64_t len = int64_t(pv >> 24) + 1;
    if (pos + len > total) return 0;
    fill_rgb(out_rgb, pos, len, pv);
    pos += len;
  }
  return pos == total ? 1 : 0;
}

// One tile's slice of the v2 wire: 16-bit words, two to an int32, from
// word `word_off`.  A palette run is one word, idx << 8 | len-1 with
// idx < 255 read through `table`; a literal run is three words,
// 0xFF00 | len-1, rgb & 0xFFFF, rgb >> 16.  -> interleaved RGB8.
// Returns 1, or 0 when the runs do not cover exactly h * w pixels or
// the words end inside a literal.
int32_t osmr_rle_decode_words(const int32_t* packed32, int64_t word_off, int32_t n_words,
                              const int32_t* table, int32_t h, int32_t w,
                              uint8_t* out_rgb) {
  const int64_t total = int64_t(h) * w;
  int64_t pos = 0;
  int64_t i = word_off;
  const int64_t end = word_off + n_words;
  while (i < end) {
    const uint32_t hdr = word_at(packed32, i);
    const uint32_t pidx = hdr >> 8;
    const int64_t len = int64_t(hdr & 0xFF) + 1;
    uint32_t v;
    if (pidx == 0xFF) {
      if (i + 3 > end) return 0;
      v = word_at(packed32, i + 1) | ((word_at(packed32, i + 2) & 0xFF) << 16);
      i += 3;
    } else {
      v = uint32_t(table[pidx]);
      i += 1;
    }
    if (pos + len > total) return 0;
    fill_rgb(out_rgb, pos, len, v);
    pos += len;
  }
  return pos == total ? 1 : 0;
}

// The same slice -> palette-index rows (h * w bytes) and the tile's own
// palette: `plte` (256 slots) comes back with the 0x00RRGGBB colours the
// tile uses, in order of first use, table colours and literal colours
// alike.  Returns the palette's size (1..256), or 0 when the tile needs
// the RGB path: more than 256 colours, a palette index at or past
// `n_table`, runs that do not cover exactly h * w pixels, or words that
// end inside a literal.
int32_t osmr_rle_decode_words_idx(const int32_t* packed32, int64_t word_off,
                                  int32_t n_words, const int32_t* table, int32_t n_table,
                                  int32_t h, int32_t w, uint8_t* out_idx, int32_t* plte) {
  const int64_t total = int64_t(h) * w;
  int32_t remap[256];
  for (int32_t k = 0; k < 256; ++k) remap[k] = -1;
  int32_t n_pal = 0;
  int64_t pos = 0;
  int64_t i = word_off;
  const int64_t end = word_off + n_words;
  while (i < end) {
    const uint32_t hdr = word_at(packed32, i);
    const uint32_t pidx = hdr >> 8;
    const int64_t len = int64_t(hdr & 0xFF) + 1;
    int32_t idx;
    if (pidx == 0xFF) {
      if (i + 3 > end) return 0;
      const int32_t v = int32_t(word_at(packed32, i + 1) |
                                ((word_at(packed32, i + 2) & 0xFF) << 16));
      i += 3;
      idx = -1;
      for (int32_t k = 0; k < n_pal; ++k) {
        if (plte[k] == v) {
          idx = k;
          break;
        }
      }
      if (idx < 0) {
        if (n_pal >= 256) return 0;
        plte[n_pal] = v;
        idx = n_pal++;
      }
    } else {
      if (int32_t(pidx) >= n_table) return 0;
      idx = remap[pidx];
      if (idx < 0) {
        if (n_pal >= 256) return 0;
        plte[n_pal] = table[pidx];
        idx = remap[pidx] = n_pal++;
      }
      i += 1;
    }
    if (pos + len > total) return 0;
    std::memset(out_idx + pos, int(idx), size_t(len));
    pos += len;
  }
  return pos == total ? n_pal : 0;
}

// Index rows (h * w bytes) -> the raw stream a palette PNG's IDAT
// deflates: h * (w + 1) bytes, each scanline its filter byte and then its
// w filtered bytes.  Filter 0 (None) on the first scanline, 2 (Up) below
// it: map tiles repeat vertically, so most rows cancel to zeros.
void osmr_png8_filter_up(const uint8_t* idx, int32_t h, int32_t w, uint8_t* raw) {
  const size_t stride = size_t(w);
  if (h <= 0) return;
  uint8_t* dst = raw;
  *dst++ = 0;
  std::memcpy(dst, idx, stride);
  dst += stride;
  for (int32_t y = 1; y < h; ++y) {
    *dst++ = 2;
    const uint8_t* cur = idx + size_t(y) * stride;
    const uint8_t* up = cur - stride;
    for (size_t x = 0; x < stride; ++x) dst[x] = uint8_t(cur[x] - up[x]);
    dst += stride;
  }
}

}  // extern "C"
