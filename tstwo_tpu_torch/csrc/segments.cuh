// Column rows read where they lie: the by-value table of segments that the
// Merkle layer kernels (blake2s.cu, poseidon252.cu) walk in order.
#pragma once

#include <cstdint>

namespace tstwo {

constexpr int kMaxSegments = 16;

// Rows of 32-bit words, word-major: word r of node i at ptr[r * stride + i].
struct Segment {
  const uint32_t* ptr;
  long long stride;
  int rows;
};

struct Segments {
  Segment seg[kMaxSegments];
  int count;
};

// The cursor over the column words of node i: p points at the next word,
// `left` rows of the open segment remain, `next` is the segment after it.
// It moves the same way in every thread.
struct Cursor {
  const uint32_t* p;
  long long stride;
  int left;
  int next;
};

__device__ __forceinline__ void open_segment(Cursor& c, const Segments& segs,
                                             long long i) {
  if (c.next < segs.count) {
    const Segment& s = segs.seg[c.next++];
    c.p = s.ptr + i;
    c.stride = s.stride;
    c.left = s.rows;
  }
}

// The table from the host arrays of a C entry point (null if n_segs is 0);
// the sum of the rows, or -1 for arguments a kernel does not take.
inline long long fill_segments(Segments& segs, const void* const* seg_ptrs,
                               const long long* seg_strides, const int* seg_rows,
                               int n_segs) {
  if (n_segs < 0 || n_segs > kMaxSegments) return -1;
  if (n_segs > 0 && (seg_ptrs == nullptr || seg_strides == nullptr || seg_rows == nullptr))
    return -1;
  long long rows = 0;
  segs.count = n_segs;
  for (int s = 0; s < n_segs; ++s) {
    if (seg_rows[s] <= 0) return -1;
    segs.seg[s] = {static_cast<const uint32_t*>(seg_ptrs[s]), seg_strides[s], seg_rows[s]};
    rows += seg_rows[s];
  }
  return rows;
}

}  // namespace tstwo
