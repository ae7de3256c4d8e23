// The palette quantisers and the LZW coder of the port's GIF writer
// (core/image_save.py writes the GIF blocks; loaded by core/codecs.py).
// Host code, compiled with g++ at first use into the port's build
// directory (utils/build.py) and called through ctypes.
//
// It repeats Pillow 12.1's libImaging, whose results the GIF plugin writes:
// - Quant.c's median cut (Image.convert("P", palette=ADAPTIVE) of an RGB
//   image): the colours counted in QuantHash's table keyed by a hash of
//   the colour, so two colours of one hash are one entry (the first
//   inserted names it); past 65536 entries every channel loses one more
//   low bit and the entries merge. Boxes split in QuantHeap's order of
//   pixel count, each along the channel of the largest range weighted by
//   77, 150 and 29, at the first colour value (from the top) past half
//   its pixels, that value kept on the upper side (the lowest value moved
//   across where nothing is left below); a box of one colour is not split.
//   The palette is each box's rounded mean in the tree's left-first order,
//   and each pixel takes the nearest entry found from its box's entry
//   through the entries sorted by their distance to it (ties to the
//   earlier), searched while no farther than twice the first distance.
// - QuantOctree.c's fast octree (the method PIL takes for RGBA): a fine
//   and a coarse colour cube (4/4/4 and 2/2/2 bits, with alpha 3/4/3/3
//   and 2/2/2/2), the fine buckets taken by count (a stable sort, as
//   glibc's qsort sorts) after the coarse ones that still hold pixels,
//   the lookup cube filled from the last entry down; a bucket's colour is
//   its sums over its count in float, truncated. Fully transparent pixels
//   take the colour of the first one first (Quant.c ImagingQuantize).
// - GifEncode.c's LZW (Raymond Gardner's coder): a clear code first, codes
//   of 9 bits growing when the code to be added passes the largest of the
//   width, a clear code where the table would pass 4096 codes, the end
//   code, bits packed from the low end; sub-blocks of up to 255 bytes,
//   each encoder call of ImageFile._save filling a buffer of
//   max(65536, 4 x width) bytes; rows in the GIF interlace order where
//   asked.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Pixel {
  uint8_t v[4];   // r, g, b, a
};

uint32_t pixel_hash(uint32_t r, uint32_t g, uint32_t b) {
  return (r * 463u) ^ ((g << 8) * 10069u) ^ ((b << 16) * 64997u);
}

int dist2(const Pixel& p, const Pixel& q) {
  int dr = int(p.v[0]) - int(q.v[0]);
  int dg = int(p.v[1]) - int(q.v[1]);
  int db = int(p.v[2]) - int(q.v[2]);
  return dr * dr + dg * dg + db * db;
}

// ---------------------------------------------------------------------------
// Median cut (Quant.c)

struct Entry {
  Pixel p;        // the scaled colour of the entry's key
  uint32_t count;
};

struct Box {
  std::vector<int> entries;
  uint32_t count = 0;
  int l = -1, r = -1;
};

// QuantHeap.c: a max-heap on pixel count, 1-based.
struct Heap {
  std::vector<int> h{-1};
  const std::vector<Box>* boxes;
  int cmp(int a, int b) const {
    return int((*boxes)[a].count) - int((*boxes)[b].count);
  }
  bool pop(int* out) {
    if (h.size() <= 1) return false;
    *out = h[1];
    int v = h.back();
    h.pop_back();
    size_t count = h.size() - 1, k = 1, l;
    for (; k * 2 <= count; k = l) {
      l = k * 2;
      if (l < count && cmp(h[l], h[l + 1]) < 0) ++l;
      if (cmp(v, h[l]) > 0) break;
      h[k] = h[l];
    }
    if (count) h[k] = v;
    return true;
  }
  void add(int val) {
    h.push_back(val);
    size_t k = h.size() - 1;
    while (k != 1) {
      if (cmp(val, h[k / 2]) <= 0) break;
      h[k] = h[k / 2];
      k >>= 1;
    }
    h[k] = val;
  }
};

int box_volume(const Box& b, const std::vector<Entry>& e) {
  int lo[3] = {255, 255, 255}, hi[3] = {0, 0, 0};
  for (int i : b.entries)
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], int(e[i].p.v[a]));
      hi[a] = std::max(hi[a], int(e[i].p.v[a]));
    }
  return (hi[0] - lo[0] + 1) * (hi[1] - lo[1] + 1) * (hi[2] - lo[2] + 1);
}

void split(std::vector<Box>& boxes, int node, const std::vector<Entry>& e) {
  Box& b = boxes[node];
  int lo[3] = {255, 255, 255}, hi[3] = {0, 0, 0};
  for (int i : b.entries)
    for (int a = 0; a < 3; ++a) {
      lo[a] = std::min(lo[a], int(e[i].p.v[a]));
      hi[a] = std::max(hi[a], int(e[i].p.v[a]));
    }
  const int weight[3] = {77, 150, 29};
  int axis = 0, best = (hi[0] - lo[0]) * weight[0];
  for (int a = 1; a < 3; ++a)
    if (best < (hi[a] - lo[a]) * weight[a]) {
      best = (hi[a] - lo[a]) * weight[a];
      axis = a;
    }
  // Pixel counts by value along the axis, walked from the top.
  uint64_t by_value[256] = {0};
  for (int i : b.entries) by_value[e[i].p.v[axis]] += e[i].count;
  int cut = -1;   // values >= cut go left
  uint64_t left = 0;
  for (int v = 255; v >= 0; --v) {
    left += by_value[v];
    if (left * 2 > b.count) {
      cut = v;
      break;
    }
  }
  if (cut <= lo[axis]) cut = lo[axis] + 1;   // nothing right: move the lowest
  Box l, r;
  for (int i : b.entries) {
    Box& to = e[i].p.v[axis] >= cut ? l : r;
    to.entries.push_back(i);
    to.count += e[i].count;
  }
  b.entries.clear();
  b.entries.shrink_to_fit();
  boxes.push_back(std::move(l));
  boxes.push_back(std::move(r));
  boxes[node].l = int(boxes.size()) - 2;
  boxes[node].r = int(boxes.size()) - 1;
}

void leaves(const std::vector<Box>& boxes, int n, std::vector<int>& out) {
  if (boxes[n].l >= 0) {
    leaves(boxes, boxes[n].l, out);
    leaves(boxes, boxes[n].r, out);
  } else if (!boxes[n].entries.empty()) {
    out.push_back(n);
  }
}

// Builds each palette entry's list of entries sorted by distance to it
// (build_distance_tables), then maps the pixels (the map_image_pixels
// routines): start at `start`, search the sorted list while within
// 4 x the first distance.
struct NearestSearch {
  const std::vector<Pixel>& pal;
  std::vector<uint32_t> dist;        // n x n
  std::vector<uint32_t> order;       // n x n entry indices by distance
  explicit NearestSearch(const std::vector<Pixel>& p) : pal(p) {
    size_t n = pal.size();
    dist.assign(n * n, 0);
    order.resize(n * n);
    for (size_t i = 0; i < n; ++i)
      for (size_t j = 0; j < i; ++j)
        dist[j * n + i] = dist[i * n + j] = uint32_t(dist2(pal[i], pal[j]));
    for (size_t i = 0; i < n; ++i) {
      uint32_t* row = &order[i * n];
      for (size_t j = 0; j < n; ++j) row[j] = uint32_t(j);
      const uint32_t* d = &dist[i * n];
      std::sort(row, row + n, [d](uint32_t a, uint32_t b) {
        return d[a] != d[b] ? d[a] < d[b] : a < b;
      });
    }
  }
  uint32_t find(const Pixel& px, uint32_t start) const {
    size_t n = pal.size();
    uint32_t best = uint32_t(dist2(pal[start], px)), match = start;
    uint32_t limit = best << 2;
    const uint32_t* row = &order[start * n];
    const uint32_t* d = &dist[start * n];
    for (size_t j = 0; j < n; ++j) {
      uint32_t idx = row[j];
      if (d[idx] > limit) break;
      uint32_t dd = uint32_t(dist2(pal[idx], px));
      if (dd < best) {
        best = dd;
        match = idx;
      }
    }
    return match;
  }
};

uint32_t rgb_key(const Pixel& p) {
  return uint32_t(p.v[0]) << 16 | uint32_t(p.v[1]) << 8 | p.v[2];
}

// ---------------------------------------------------------------------------
// Fast octree (QuantOctree.c)

struct Bucket {
  uint32_t count;
  uint64_t r, g, b, a;
};

struct Cube {
  int bits[4], width[4], offset[4];
  std::vector<Bucket> buckets;
  Cube(int r, int g, int b, int a) {
    bits[0] = r; bits[1] = g; bits[2] = b; bits[3] = a;
    for (int i = 0; i < 4; ++i) width[i] = 1 << bits[i];
    offset[0] = g + b + a;
    offset[1] = b + a;
    offset[2] = a;
    offset[3] = 0;
    buckets.assign(size_t(width[0]) * width[1] * width[2] * width[3],
                   Bucket{0, 0, 0, 0, 0});
  }
  long pos(unsigned r, unsigned g, unsigned b, unsigned a) const {
    return long(r) << offset[0] | long(g) << offset[1] |
           long(b) << offset[2] | long(a) << offset[3];
  }
  Bucket& of(const Pixel& p) {
    return buckets[pos(p.v[0] >> (8 - bits[0]), p.v[1] >> (8 - bits[1]),
                       p.v[2] >> (8 - bits[2]), p.v[3] >> (8 - bits[3]))];
  }
  long used() const {
    long n = 0;
    for (auto& b : buckets) n += b.count > 0;
    return n;
  }
};

uint8_t clip8(int v) { return uint8_t(v < 0 ? 0 : v > 255 ? 255 : v); }

Pixel avg_color(const Bucket& b) {
  float count = float(b.count);
  Pixel p{{0, 0, 0, 0}};
  if (count != 0) {
    p.v[0] = clip8(int(float(b.r) / count));
    p.v[1] = clip8(int(float(b.g) / count));
    p.v[2] = clip8(int(float(b.b) / count));
    p.v[3] = clip8(int(float(b.a) / count));
  }
  return p;
}

Cube copy_cube(const Cube& src, int r, int g, int b, int a) {
  Cube dst(r, g, b, a);
  int sred[4] = {0, 0, 0, 0}, dred[4] = {0, 0, 0, 0}, width[4];
  for (int i = 0; i < 4; ++i) {
    if (src.bits[i] > dst.bits[i]) {
      dred[i] = src.bits[i] - dst.bits[i];
      width[i] = src.width[i];
    } else {
      sred[i] = dst.bits[i] - src.bits[i];
      width[i] = dst.width[i];
    }
  }
  for (int x0 = 0; x0 < width[0]; ++x0)
    for (int x1 = 0; x1 < width[1]; ++x1)
      for (int x2 = 0; x2 < width[2]; ++x2)
        for (int x3 = 0; x3 < width[3]; ++x3) {
          const Bucket& s = src.buckets[src.pos(x0 >> sred[0], x1 >> sred[1],
                                                x2 >> sred[2], x3 >> sred[3])];
          Bucket& d = dst.buckets[dst.pos(x0 >> dred[0], x1 >> dred[1],
                                          x2 >> dred[2], x3 >> dred[3])];
          d.count += s.count;
          d.r += s.r;
          d.g += s.g;
          d.b += s.b;
          d.a += s.a;
        }
  return dst;
}

std::vector<Bucket> sorted_buckets(const Cube& c) {
  std::vector<Bucket> out = c.buckets;
  std::stable_sort(out.begin(), out.end(),
                   [](const Bucket& x, const Bucket& y) {
                     return int(y.count - x.count) < 0;
                   });
  return out;
}

void subtract(Cube& cube, const Bucket* b, long n) {
  for (long i = 0; i < n; ++i) {
    if (b[i].count == 0) continue;
    Bucket& m = cube.of(avg_color(b[i]));
    m.count -= b[i].count;
    m.r -= b[i].r;
    m.g -= b[i].g;
    m.b -= b[i].b;
    m.a -= b[i].a;
  }
}

void add_lookup(Cube& cube, const std::vector<Bucket>& pal, long n, long off) {
  for (long i = off + n - 1; i >= off; --i)
    cube.of(avg_color(pal[i])).count = uint32_t(i);
}

// ---------------------------------------------------------------------------
// GifEncode.c

struct Lzw {
  std::vector<uint8_t>* out;
  uint32_t bits = 8, clear = 256, end = 257, next = 258, max_code = 511;
  uint32_t width = 9;
  std::vector<uint32_t> codes;   // (next_code << 20) | (head << 8) | tail
  uint32_t buffer = 0;
  int buf_bits_left = 8;
  void reset() {
    next = end + 1;
    max_code = 2 * clear - 1;
    width = bits + 1;
    std::fill(codes.begin(), codes.end(), 0);
  }
  void put(uint32_t code) {
    int code_bits_left = int(width);
    while (code_bits_left) {
      if (!buf_bits_left) {
        out->push_back(uint8_t(buffer));
        buffer = 0;
        buf_bits_left = 8;
      }
      int n = std::min(buf_bits_left, code_bits_left);
      buffer |= (code & ((1u << n) - 1)) << (8 - buf_bits_left);
      code >>= n;
      buf_bits_left -= n;
      code_bits_left -= n;
    }
  }
};

constexpr int kTableSize = 8192;

}  // namespace

// Image.convert("P", palette=ADAPTIVE) of an (n, 3) RGB image: writes each
// pixel's palette index and the palette (up to 256 x 3) and returns the
// palette's length.
extern "C" int64_t tb_quantize_median(const uint8_t* rgb, int64_t n,
                                      uint8_t* index, uint8_t* palette) {
  // create_pixel_hash: entries keyed by the hash of the scaled colour.
  int scale = 0;
  std::unordered_map<uint32_t, int> table;
  std::vector<Pixel> keys;
  std::vector<uint32_t> counts;
  auto hash_of = [&](const Pixel& p) {
    return pixel_hash(p.v[0] >> scale, p.v[1] >> scale, p.v[2] >> scale);
  };
  for (int64_t i = 0; i < n; ++i) {
    Pixel p{{rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2], 255}};
    auto it = table.find(hash_of(p));
    if (it != table.end()) {
      ++counts[it->second];
      continue;
    }
    table.emplace(hash_of(p), int(keys.size()));
    keys.push_back(p);
    counts.push_back(1);
    while (table.size() > 65536) {
      ++scale;
      std::unordered_map<uint32_t, int> merged;
      std::vector<Pixel> k2;
      std::vector<uint32_t> c2;
      for (size_t j = 0; j < keys.size(); ++j) {
        auto m = merged.find(hash_of(keys[j]));
        if (m != merged.end()) {
          c2[m->second] += counts[j];
        } else {
          merged.emplace(hash_of(keys[j]), int(k2.size()));
          k2.push_back(keys[j]);
          c2.push_back(counts[j]);
        }
      }
      table.swap(merged);
      keys.swap(k2);
      counts.swap(c2);
    }
  }
  std::vector<Entry> entries(keys.size());
  for (size_t j = 0; j < keys.size(); ++j) {
    for (int a = 0; a < 3; ++a)
      entries[j].p.v[a] = uint8_t(keys[j].v[a] >> scale);
    entries[j].p.v[3] = 0;
    entries[j].count = counts[j];
  }
  // median_cut
  std::vector<Box> boxes(1);
  boxes.reserve(1024);
  boxes[0].count = uint32_t(n);
  for (size_t j = 0; j < entries.size(); ++j)
    boxes[0].entries.push_back(int(j));
  Heap heap;
  heap.boxes = &boxes;
  heap.add(0);
  for (int left = 256; --left;) {
    int node;
    bool got;
    while ((got = heap.pop(&node)) && box_volume(boxes[node], entries) == 1) {
    }
    if (!got) break;
    split(boxes, node, entries);
    heap.add(boxes[node].l);
    heap.add(boxes[node].r);
  }
  std::vector<int> order;
  leaves(boxes, 0, order);
  std::vector<int> box_of_entry(entries.size());
  for (size_t k = 0; k < order.size(); ++k)
    for (int e : boxes[order[k]].entries) box_of_entry[e] = int(k);
  // compute_palette_from_median_cut
  size_t np = order.size();
  std::vector<uint64_t> sum(np * 3, 0), cnt(np, 0);
  std::vector<int> box_of_pixel(n);
  for (int64_t i = 0; i < n; ++i) {
    Pixel p{{rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2], 255}};
    int b = box_of_entry[table[hash_of(p)]];
    box_of_pixel[i] = b;
    for (int a = 0; a < 3; ++a) sum[b * 3 + a] += p.v[a];
    ++cnt[b];
  }
  std::vector<Pixel> pal(np);
  for (size_t k = 0; k < np; ++k)
    for (int a = 0; a < 3; ++a)
      pal[k].v[a] = uint8_t(int(.5 + double(uint32_t(sum[k * 3 + a])) /
                                         double(uint32_t(cnt[k]))));
  // map_image_pixels_from_median_box
  NearestSearch search(pal);
  std::unordered_map<uint32_t, uint32_t> seen;
  for (int64_t i = 0; i < n; ++i) {
    Pixel p{{rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2], 255}};
    auto it = seen.find(rgb_key(p));
    if (it == seen.end())
      it = seen.emplace(rgb_key(p),
                        search.find(p, uint32_t(box_of_pixel[i]))).first;
    index[i] = uint8_t(it->second);
  }
  for (size_t k = 0; k < np; ++k)
    for (int a = 0; a < 3; ++a) palette[k * 3 + a] = pal[k].v[a];
  return int64_t(np);
}

// Image.quantize(256, FASTOCTREE) of an (n, 4) RGBA image: writes each
// pixel's palette index and the palette (256 x 4) and returns its length.
extern "C" int64_t tb_quantize_octree(const uint8_t* rgba, int64_t n,
                                      uint8_t* index, uint8_t* palette) {
  const int kLevels[8] = {3, 4, 3, 3, 2, 2, 2, 2};
  const long quant = 256;
  std::vector<Pixel> px(n);
  bool transparent = false;
  uint8_t tr = 0, tg = 0, tb = 0;
  for (int64_t i = 0; i < n; ++i) {
    std::memcpy(px[i].v, rgba + 4 * i, 4);
    if (px[i].v[3] == 0) {
      if (!transparent) {
        transparent = true;
        tr = px[i].v[0];
        tg = px[i].v[1];
        tb = px[i].v[2];
      } else {
        px[i].v[0] = tr;
        px[i].v[1] = tg;
        px[i].v[2] = tb;
      }
    }
  }
  Cube fine(kLevels[0], kLevels[1], kLevels[2], kLevels[3]);
  for (auto& p : px) {
    Bucket& b = fine.of(p);
    b.count += 1;
    b.r += p.v[0];
    b.g += p.v[1];
    b.b += p.v[2];
    b.a += p.v[3];
  }
  Cube coarse = copy_cube(fine, kLevels[4], kLevels[5], kLevels[6], kLevels[7]);
  long n_coarse = std::min(coarse.used(), quant);
  long n_fine = quant - n_coarse;
  std::vector<Bucket> fine_pal = sorted_buckets(fine);
  subtract(coarse, fine_pal.data(), n_fine);
  while (n_coarse > coarse.used()) {
    long done = n_fine;
    n_coarse = coarse.used();
    n_fine = quant - n_coarse;
    subtract(coarse, fine_pal.data() + done, n_fine - done);
  }
  std::vector<Bucket> coarse_pal = sorted_buckets(coarse);
  std::vector<Bucket> pal(coarse_pal.begin(), coarse_pal.begin() + n_coarse);
  pal.insert(pal.end(), fine_pal.begin(), fine_pal.begin() + n_fine);
  Cube coarse_lookup(kLevels[4], kLevels[5], kLevels[6], kLevels[7]);
  add_lookup(coarse_lookup, pal, n_coarse, 0);
  Cube lookup = copy_cube(coarse_lookup, kLevels[0], kLevels[1], kLevels[2],
                          kLevels[3]);
  add_lookup(lookup, pal, n_fine, n_coarse);
  for (int64_t i = 0; i < n; ++i) index[i] = uint8_t(lookup.of(px[i]).count);
  for (long k = 0; k < n_coarse + n_fine; ++k) {
    Pixel c = avg_color(pal[k]);
    std::memcpy(palette + 4 * k, c.v, 4);
  }
  return n_coarse + n_fine;
}

// GifEncode.c on an (h, w) index image with 8-bit codes: the image data's
// sub-blocks (without the block terminator) into `out`; returns their
// length, or -1 past `cap`.
extern "C" int64_t tb_gif_lzw(const uint8_t* img, int64_t h, int64_t w,
                              int64_t interlace, uint8_t* out, int64_t cap) {
  std::vector<uint8_t> codes_out;
  codes_out.reserve(size_t(h * w) + 16);
  Lzw z;
  z.out = &codes_out;
  z.codes.assign(kTableSize, 0);
  z.reset();
  z.put(z.clear);
  // The rows in file order.
  std::vector<int64_t> rows;
  if (interlace) {
    const int start[4] = {0, 4, 2, 1}, step[4] = {8, 8, 4, 2};
    for (int p = 0; p < 4; ++p)
      for (int64_t y = start[p]; y < h; y += step[p]) rows.push_back(y);
  } else {
    for (int64_t y = 0; y < h; ++y) rows.push_back(y);
  }
  bool have_head = false;
  uint32_t head = 0;
  for (int64_t y : rows) {
    const uint8_t* row = img + y * w;
    for (int64_t x = 0; x < w; ++x) {
      uint32_t tail = row[x];
      if (!have_head) {
        head = tail;
        have_head = true;
        continue;
      }
      int probe = int(((head ^ (tail << 6)) * 31) & (kTableSize - 1));
      bool found = false;
      while (z.codes[probe]) {
        if ((z.codes[probe] & 0xFFFFF) == ((head << 8) | tail)) {
          head = z.codes[probe] >> 20;
          found = true;
          break;
        }
        probe -= int((tail << 2) | 1);
        if (probe < 0) probe += kTableSize;
      }
      if (found) continue;
      z.put(head);
      if (z.next < 4096) {
        z.codes[probe] = (z.next << 20) | (head << 8) | tail;
        if (z.next > z.max_code) {
          z.max_code = z.max_code * 2 + 1;
          ++z.width;
        }
        ++z.next;
      } else {
        z.put(z.clear);
        z.reset();
      }
      head = tail;
    }
  }
  if (have_head) z.put(head);
  z.put(z.end);
  if (z.buf_bits_left < 8) codes_out.push_back(uint8_t(z.buffer));
  // Sub-blocks: each buffer of ImageFile._save's size holds blocks of up to
  // 256 bytes (length byte included); a buffer with less than 2 bytes left
  // ends there.
  const int64_t bufsize = std::max<int64_t>(65536, 4 * w);
  std::vector<uint8_t> blocks;
  size_t pos = 0;
  while (pos < codes_out.size()) {
    int64_t room = bufsize;
    while (room >= 2 && pos < codes_out.size()) {
      int64_t len = std::min<int64_t>({255, room - 1,
                                       int64_t(codes_out.size() - pos)});
      blocks.push_back(uint8_t(len));
      blocks.insert(blocks.end(), codes_out.begin() + pos,
                    codes_out.begin() + pos + len);
      pos += len;
      room -= len + 1;
    }
  }
  if (int64_t(blocks.size()) > cap) return -1;
  std::memcpy(out, blocks.data(), blocks.size());
  return int64_t(blocks.size());
}
