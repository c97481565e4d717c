// Native COCO RLE codec (counterpart of pycocotools' C maskApi:
// rleEncode / rleDecode / rleToString / rleFrString). The evaluation loop
// RLE-encodes every predicted mask (reference: encode_mask_results,
// mmdet/apis/test.py:64-66) — this is the host-side hot path during eval,
// and the pure-python LEB128 string codec is byte-at-a-time. Built once at
// first use (see native/__init__.py) and loaded via ctypes.
#include <cstdint>
#include <cstring>

extern "C" {

// Run lengths of the mask in COLUMN-major order, alternating 0/1 starting
// with zeros. mask is row-major (h, w) uint8. Returns the number of counts
// written, or -1 if max_counts is too small.
int rle_encode_mask(const uint8_t* mask, int h, int w,
                    uint32_t* counts, int max_counts) {
  int n = 0;
  uint8_t prev = 0;
  uint32_t run = 0;
  for (int j = 0; j < w; ++j) {
    const uint8_t* col = mask + j;
    for (int i = 0; i < h; ++i) {
      uint8_t v = col[(size_t)i * w] ? 1 : 0;
      if (v == prev) {
        ++run;
      } else {
        if (n >= max_counts) return -1;
        counts[n++] = run;
        prev = v;
        run = 1;
      }
    }
  }
  if (n >= max_counts) return -1;
  counts[n++] = run;
  return n;
}

// counts -> row-major (h, w) uint8 mask (counts are column-major runs).
void rle_decode_counts(const uint32_t* counts, int n, int h, int w,
                       uint8_t* out) {
  std::memset(out, 0, (size_t)h * w);
  int64_t pos = 0;
  uint8_t val = 0;
  for (int k = 0; k < n; ++k) {
    uint32_t c = counts[k];
    if (val) {
      for (uint32_t t = 0; t < c; ++t) {
        int64_t p = pos + t;
        int i = (int)(p % h);       // row (column-major flat index)
        int j = (int)(p / h);       // col
        out[(size_t)i * w + j] = 1;
      }
    }
    pos += c;
    val ^= 1;
  }
}

// pycocotools rleToString: LEB128-ish base-48 with delta coding from i-2.
// Returns bytes written, or -1 if max_out too small.
int rle_string_encode(const uint32_t* counts, int n, char* out,
                      int max_out) {
  int m = 0;
  for (int i = 0; i < n; ++i) {
    int64_t x = (int64_t)counts[i];
    if (i > 2) x -= (int64_t)counts[i - 2];
    bool more = true;
    while (more) {
      int64_t c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? (x != -1) : (x != 0);
      if (more) c |= 0x20;
      if (m >= max_out) return -1;
      out[m++] = (char)(c + 48);
    }
  }
  return m;
}

// pycocotools rleFrString. Returns number of counts, or -1 on overflow.
int rle_string_decode(const char* s, int slen, uint32_t* counts,
                      int max_counts) {
  int n = 0;
  int i = 0;
  while (i < slen) {
    int64_t x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      if (i >= slen) return -1;
      int64_t c = (int64_t)s[i] - 48;
      x |= (c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      ++i;
      ++k;
      if (!more && (c & 0x10)) x |= (int64_t)(-1) << (5 * k);
    }
    if (n > 2) x += (int64_t)counts[n - 2];
    if (n >= max_counts) return -1;
    counts[n++] = (uint32_t)x;
  }
  return n;
}

}  // extern "C"
