// The ALPH chunk of the lossy WebP writer (core/image_save.py): libwebp
// 1.6's alpha_enc.c as WebPEncode runs it for PIL 12.1's Image.save of an
// image whose alpha is below 255 somewhere (alpha_quality 100, so no level
// quantisation; alpha_compression 1, lossless; alpha_filtering 1, fast;
// method 4). Host code, compiled with g++ at first use into the port's
// build directory (utils/build.py) and called through ctypes; the tables
// it shares with the VP8L decoder are in webp_vp8l_tables.inc.
//
// The stages follow libwebp's files:
// - the filter choice (alpha_enc.c GetFilterMap): 16 colours or fewer
//   take no filter, else WebPEstimateBestFilter's pick (filters_utils.c)
//   and, because the effort 4 is above 3, no filter as well; each
//   candidate is filtered (filters.c), coded, and the smaller kept, the
//   first on a tie; a coded stream larger than the plane is replaced by
//   the raw plane (compression 0);
// - the plane as a VP8L image (EncodeLossless): alpha in green, A, R and
//   B zero, coded by VP8LEncodeStream at quality 8 x 4 = 32, method 4,
//   exact, without the 5-byte VP8L header;
// - the analysis (vp8l_enc.c EncoderAnalyze, AnalyzeEntropy): the
//   palette, always possible here, and for more than 16 colours the
//   entropies of direct, spatial, subtract-green and palette coding, the
//   least taken; method 4 below quality 75 tries that one configuration,
//   and with 16 colours or fewer two LZ77 variants of it;
// - the colour-indexing transform (utils/palette.c): the palette sorted,
//   reordered greedily to small deltas where the deltas from 0 change
//   sign in some channel (PaletteSortMinimizeDeltas), delta-coded as an
//   image at quality 20, the indices bundled 2, 4 or 8 to a pixel for 16,
//   4 or 2 colours or fewer;
// - the predictor transform (predictor_enc.c): per tile (32x32, larger
//   where the map would pass 16,384 tiles) the mode of the 14 whose
//   residual histogram, added to those of the tiles before, costs least
//   with a bias to small residuals and to the neighbours' modes; the
//   residuals of the whole image; the modes as an image, subsampled up
//   to 512x512 tiles where they repeat (VP8LOptimizeSampling);
// - backward references (backward_references_enc.c,
//   backward_references_cost_enc.c): the hash chain, LZ77 standard, RLE
//   and box, each costed by its histogram with the best colour cache, the
//   standard and box ones refined by TraceBackwards (quality >= 25) with
//   its cost model and interval manager; distances to plane codes;
// - the histogram image (histogram_enc.c): a histogram per tile, empty
//   ones dropped, merged by entropy bins (more than 128 left), then
//   stochastically (pairs drawn by MINSTD from seed 1) and greedily in a
//   dense set where a removed histogram's slot takes the last one; each
//   tile remapped to its best cluster, an empty one to its predecessor's;
//   the map subsampled where its tiles repeat;
// - prefix codes (huffman_encode_utils.c): counts smoothed for run-length
//   coding, length-limited Huffman trees (15 bits, 7 for the code-length
//   code), code lengths coded with runs, trailing zeros trimmed, simple
//   codes for up to two symbols below 256;
// - the bit writer (bit_writer_utils.c VP8LBitWriter), LSB first.
//
// The picture has R, B and A zero, so the subtract-green modes never
// win the analysis (their entropy adds that of -G to the direct mode's)
// and the cross-colour transform is never tried; they are not written,
// and the entry points fail (-3) should the analysis pick one.
//
// Costs are libwebp 1.6's fixed point: log2 in 23 fractional bits from
// 256-entry tables, with its approximation above them.
//
// Entry points (a positive size on success, negative on error):
// - tb_webp_alpha_encode(alpha, w, h, out, cap): the ALPH chunk's payload
//   (the header byte, then the stream or the raw plane); returns its
//   size, or -(its size) when cap is too small;
// - tb_vp8l_encode_green(alpha, w, h, out, cap): the VP8L stream (without
//   header) of the plane unfiltered, as EncodeLossless writes it.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

#include "webp_vp8l_tables.inc"

constexpr int NUM_LITERAL_CODES = 256;
constexpr int NUM_LENGTH_CODES = 24;
constexpr int NUM_DISTANCE_CODES = 40;
constexpr int CODE_LENGTH_CODES = 19;
constexpr int MAX_COLOR_CACHE_BITS = 10;
constexpr int MIN_HUFFMAN_BITS = 2;
constexpr int MAX_HUFFMAN_BITS = 9;
constexpr int MAX_HUFF_IMAGE_SIZE = 2600;
constexpr int MIN_TRANSFORM_BITS = 2;
constexpr int MAX_TRANSFORM_BITS = 9;
constexpr int MAX_PREDICTOR_IMAGE_SIZE = 1 << 14;
constexpr int MAX_LENGTH_BITS = 12;
constexpr int MAX_LENGTH = (1 << MAX_LENGTH_BITS) - 1;
constexpr int WINDOW_SIZE = (1 << 20) - 120;
constexpr int MIN_LENGTH = 4;
constexpr int HASH_BITS = 18;
constexpr int HASH_SIZE = 1 << HASH_BITS;
constexpr uint32_t NON_TRIVIAL_SYM = 0xffffffffu;
constexpr int LOG_2_PRECISION_BITS = 23;
constexpr uint64_t LOG_2_RECIPROCAL_FIXED = 12102203;
constexpr double LOG_2_RECIPROCAL_FIXED_DOUBLE = 12102203.161561485379934310913085937500;
constexpr int kLZ77Standard = 1, kLZ77RLE = 2, kLZ77Box = 4;
enum EntropyIx { kDirect, kSpatial, kSubGreen, kSpatialSubGreen, kPalette };

inline int SubSampleSize(int size, int bits) {
  return (size + (1 << bits) - 1) >> bits;
}
inline int BitsLog2Floor(uint32_t v) { return 31 - __builtin_clz(v); }
inline int64_t DivRound(int64_t a, int64_t b) {
  return ((a < 0) == (b < 0)) ? ((a + b / 2) / b) : ((a - b / 2) / b);
}
inline uint32_t SubPixels(uint32_t a, uint32_t b) {
  const uint32_t ag = 0x00ff00ffu + (a & 0xff00ff00u) - (b & 0xff00ff00u);
  const uint32_t rb = 0xff00ff00u + (a & 0x00ff00ffu) - (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}

// ---------------------------------------------------------------------------
// Fixed-point log2 (lossless_enc.c): kLog2Table[i] = log2(i) and
// kSLog2Table[i] = i * log2(i), in LOG_2_PRECISION_BITS, rounded.

struct LogTables {
  uint32_t log2[256];
  uint64_t slog2[256];
  LogTables() {
    for (int i = 0; i < 256; ++i) {
      const long double l = i ? std::log2((long double)i) : 0.0L;
      log2[i] = uint32_t(std::llround(l * (1 << LOG_2_PRECISION_BITS)));
      slog2[i] = uint64_t(std::llround(l * i * (1 << LOG_2_PRECISION_BITS)));
    }
  }
};
const LogTables kLog;

uint32_t FastLog2(uint32_t v) {
  if (v < 256) return kLog.log2[v];
  if (v < 65536) {
    const uint32_t orig_v = v;
    const uint32_t log_cnt = BitsLog2Floor(v) - 7;
    const uint32_t y = 1u << log_cnt;
    v >>= log_cnt;
    uint32_t log_2 = kLog.log2[v] + (log_cnt << LOG_2_PRECISION_BITS);
    if (orig_v >= 4096) {
      const uint64_t correction = LOG_2_RECIPROCAL_FIXED * (orig_v & (y - 1));
      log_2 += uint32_t(DivRound(int64_t(correction), orig_v));
    }
    return log_2;
  }
  return uint32_t(LOG_2_RECIPROCAL_FIXED_DOUBLE * std::log(double(v)) + .5);
}

uint64_t FastSLog2(uint32_t v) {
  if (v < 256) return kLog.slog2[v];
  if (v < 65536) {
    const uint64_t orig_v = v;
    const uint32_t log_cnt = BitsLog2Floor(v) - 7;
    const uint32_t y = 1u << log_cnt;
    v >>= log_cnt;
    const uint64_t correction = LOG_2_RECIPROCAL_FIXED * (orig_v & (y - 1));
    return orig_v * (kLog.log2[v] + (uint64_t(log_cnt) << LOG_2_PRECISION_BITS))
        + correction;
  }
  return uint64_t(LOG_2_RECIPROCAL_FIXED_DOUBLE * v * std::log(double(v)) + .5);
}

// ---------------------------------------------------------------------------
// Entropy estimates (lossless_enc.c, histogram_enc.c)

struct BitEntropy {
  uint64_t entropy = 0;
  uint32_t sum = 0;
  int nonzeros = 0;
  uint32_t max_val = 0;
  uint32_t nonzero_code = NON_TRIVIAL_SYM;
};

struct Streaks {
  int counts[2] = {0, 0};
  int streaks[2][2] = {{0, 0}, {0, 0}};
};

uint64_t BitsEntropyRefine(const BitEntropy& e) {
  uint64_t mix;
  if (e.nonzeros < 5) {
    if (e.nonzeros <= 1) return 0;
    if (e.nonzeros == 2)
      return uint64_t(DivRound(
          int64_t(99 * (uint64_t(e.sum) << LOG_2_PRECISION_BITS) + e.entropy),
          100));
    mix = (e.nonzeros == 3) ? 950 : 700;
  } else {
    mix = 627;
  }
  uint64_t min_limit = uint64_t(2 * e.sum - e.max_val) << LOG_2_PRECISION_BITS;
  min_limit = uint64_t(DivRound(int64_t(mix * min_limit + (1000 - mix) * e.entropy),
                                1000));
  return e.entropy < min_limit ? min_limit : e.entropy;
}

uint64_t BitsEntropy(const uint32_t* array, int n) {
  BitEntropy e;
  for (int i = 0; i < n; ++i) {
    if (array[i] != 0) {
      e.sum += array[i];
      e.nonzero_code = i;
      ++e.nonzeros;
      e.entropy += FastSLog2(array[i]);
      if (e.max_val < array[i]) e.max_val = array[i];
    }
  }
  e.entropy = FastSLog2(e.sum) - e.entropy;
  return BitsEntropyRefine(e);
}

inline void EntropyHelper(uint32_t val, int i, uint32_t* val_prev, int* i_prev,
                          BitEntropy* be, Streaks* st) {
  const int streak = i - *i_prev;
  if (*val_prev != 0) {
    be->sum += *val_prev * streak;
    be->nonzeros += streak;
    be->nonzero_code = *i_prev;
    be->entropy += FastSLog2(*val_prev) * streak;
    if (be->max_val < *val_prev) be->max_val = *val_prev;
  }
  st->counts[*val_prev != 0] += (streak > 3);
  st->streaks[*val_prev != 0][(streak > 3)] += streak;
  *val_prev = val;
  *i_prev = i;
}

// GetEntropyUnrefined (y == nullptr) and GetCombinedEntropyUnrefined.
void EntropyUnrefined(const uint32_t* x, const uint32_t* y, int length,
                      BitEntropy* be, Streaks* st) {
  *be = BitEntropy();
  *st = Streaks();
  be->nonzero_code = NON_TRIVIAL_SYM;
  int i_prev = 0;
  uint32_t prev = x[0] + (y ? y[0] : 0);
  int i = 1;
  for (; i < length; ++i) {
    const uint32_t v = x[i] + (y ? y[i] : 0);
    if (v != prev) EntropyHelper(v, i, &prev, &i_prev, be, st);
  }
  EntropyHelper(0, i, &prev, &i_prev, be, st);
  be->entropy = FastSLog2(be->sum) - be->entropy;
}

uint64_t InitialHuffmanCost() {
  return (uint64_t(CODE_LENGTH_CODES * 3) << LOG_2_PRECISION_BITS) -
         uint64_t(DivRound(int64_t(91) << LOG_2_PRECISION_BITS, 10));
}

uint64_t FinalHuffmanCost(const Streaks& s) {
  uint64_t retval = InitialHuffmanCost();
  uint32_t extra = s.counts[0] * 1600 + 240 * s.streaks[0][1];
  extra += s.counts[1] * 2640 + 720 * s.streaks[1][1];
  extra += 1840 * s.streaks[0][0];
  extra += 3360 * s.streaks[1][0];
  return retval + (uint64_t(extra) << (LOG_2_PRECISION_BITS - 10));
}

// PopulationCost of x (+ y): the refined entropy plus the estimated cost
// of the code's lengths.
uint64_t PopulationCost(const uint32_t* x, const uint32_t* y, int length,
                        uint32_t* trivial_sym, uint8_t* is_used) {
  BitEntropy be;
  Streaks st;
  EntropyUnrefined(x, y, length, &be, &st);
  if (trivial_sym)
    *trivial_sym = (be.nonzeros == 1) ? be.nonzero_code : NON_TRIVIAL_SYM;
  if (is_used) *is_used = (st.streaks[1][0] != 0 || st.streaks[1][1] != 0);
  return BitsEntropyRefine(be) + FinalHuffmanCost(st);
}

uint32_t ExtraCost(const uint32_t* population, int length) {
  uint32_t cost = population[4] + population[5];
  for (int i = 2; i < length / 2 - 1; ++i)
    cost += i * (population[2 * i + 2] + population[2 * i + 3]);
  return cost;
}

// ---------------------------------------------------------------------------
// Prefix coding of lengths and distances

// VP8LPrefixEncode: the prefix code of a length or distance, its extra
// bits' count and value (distance 0, a cost table's first entry, as 1).
inline void PrefixEncode(int distance, int* code, int* extra_bits,
                         int* extra_value) {
  if (distance < 3) {
    *code = distance > 0 ? distance - 1 : 0;
    *extra_bits = 0;
    *extra_value = 0;
    return;
  }
  --distance;
  const int highest_bit = BitsLog2Floor(distance);
  const int second_highest_bit = (distance >> (highest_bit - 1)) & 1;
  *extra_bits = highest_bit - 1;
  *extra_value = distance & ((1 << *extra_bits) - 1);
  *code = 2 * highest_bit + second_highest_bit;
}

// VP8LDistanceToPlaneCode, its table the inverse of kDistanceMap.
struct PlaneLut {
  uint8_t lut[128];
  PlaneLut() {
    std::memset(lut, 255, sizeof(lut));
    for (int c = 0; c < 120; ++c)
      lut[kDistanceMap[c][1] * 16 + 8 - kDistanceMap[c][0]] = uint8_t(c);
  }
};
const PlaneLut kPlane;

int DistanceToPlaneCode(int xsize, int dist) {
  const int yoffset = dist / xsize;
  const int xoffset = dist - yoffset * xsize;
  if (xoffset <= 8 && yoffset < 8) {
    return kPlane.lut[yoffset * 16 + 8 - xoffset] + 1;
  } else if (xoffset > xsize - 8 && yoffset < 7) {
    return kPlane.lut[(yoffset + 1) * 16 + 8 + (xsize - xoffset)] + 1;
  }
  return dist + 120;
}

// ---------------------------------------------------------------------------
// The bit writer

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t bits = 0;
  int used = 0;
  void Put(uint32_t value, int n) {
    if (n <= 0) return;
    bits |= uint64_t(value) << used;
    used += n;
    while (used >= 8) {
      buf.push_back(uint8_t(bits));
      bits >>= 8;
      used -= 8;
    }
  }
  size_t NumBytes() const { return buf.size() + ((used + 7) >> 3); }
  std::vector<uint8_t> Finish() const {
    std::vector<uint8_t> out = buf;
    if (used > 0) out.push_back(uint8_t(bits));
    return out;
  }
};

// ---------------------------------------------------------------------------
// Backward references

struct PixOrCopy {
  uint8_t mode;      // 0 literal, 1 cache index, 2 copy
  uint16_t len;
  uint32_t argb_or_distance;
};
using Refs = std::vector<PixOrCopy>;

inline PixOrCopy Literal(uint32_t argb) { return {0, 1, argb}; }
inline PixOrCopy CacheIdx(uint32_t idx) { return {1, 1, idx}; }
inline PixOrCopy Copy(uint32_t dist, int len) {
  return {2, uint16_t(len), dist};
}

// VP8LHashPix: the colour cache's key of a pixel.
inline uint32_t HashPix(uint32_t argb, int shift) {
  return uint32_t((argb * 0x1e35a7bdull) & 0xffffffffu) >> shift;
}

struct ColorCache {
  std::vector<uint32_t> colors;
  int hash_shift = 0;
  void Init(int bits) {
    colors.assign(size_t(1) << bits, 0);
    hash_shift = 32 - bits;
  }
  uint32_t Index(uint32_t argb) const { return HashPix(argb, hash_shift); }
  void Insert(uint32_t argb) { colors[Index(argb)] = argb; }
  int Contains(uint32_t argb) const {
    const uint32_t key = Index(argb);
    return colors[key] == argb ? int(key) : -1;
  }
};


struct HashChain {
  std::vector<uint32_t> offset_length;
  int Offset(int pos) const { return int(offset_length[pos] >> MAX_LENGTH_BITS); }
  int Length(int pos) const {
    return int(offset_length[pos] & ((1u << MAX_LENGTH_BITS) - 1));
  }
};

inline uint32_t GetPixPairHash64(const uint32_t* argb) {
  uint32_t key = uint32_t((argb[1] * 0xc6a4a793ull) & 0xffffffffu);
  key += uint32_t((argb[0] * 0x5bd1e996ull) & 0xffffffffu);
  return key >> (32 - HASH_BITS);
}

inline int VectorMismatch(const uint32_t* a, const uint32_t* b, int length) {
  int match_len = 0;
  while (match_len < length && a[match_len] == b[match_len]) ++match_len;
  return match_len;
}

inline int FindMatchLength(const uint32_t* a1, const uint32_t* a2,
                           int best_len_match, int max_limit) {
  if (a1[best_len_match] != a2[best_len_match]) return 0;
  return VectorMismatch(a1, a2, max_limit);
}

inline int MaxFindCopyLength(int len) { return len < MAX_LENGTH ? len : MAX_LENGTH; }

void HashChainFill(HashChain* p, int quality, const uint32_t* argb, int xsize,
                   int ysize) {
  const int size = xsize * ysize;
  const int iter_max = 8 + (quality * quality) / 128;
  const int mws = (quality > 75) ? WINDOW_SIZE : (quality > 50) ? (xsize << 8)
                : (quality > 25) ? (xsize << 6) : (xsize << 4);
  const uint32_t window_size = uint32_t(mws > WINDOW_SIZE ? WINDOW_SIZE : mws);
  p->offset_length.assign(size, 0);
  if (size <= 2) return;
  std::vector<int32_t> hash_to_first_index(HASH_SIZE, -1);
  std::vector<int32_t> chain(size, -1);
  int pos;
  int argb_comp = (argb[0] == argb[1]);
  for (pos = 0; pos < size - 2;) {
    uint32_t hash_code;
    const int argb_comp_next = (argb[pos + 1] == argb[pos + 2]);
    if (argb_comp && argb_comp_next) {
      uint32_t tmp[2];
      uint32_t len = 1;
      tmp[0] = argb[pos];
      while (pos + int(len) + 2 < size && argb[pos + len + 2] == argb[pos]) ++len;
      if (len > MAX_LENGTH) {
        for (uint32_t k = 0; k < len - MAX_LENGTH; ++k) chain[pos + k] = -1;
        pos += len - MAX_LENGTH;
        len = MAX_LENGTH;
      }
      while (len) {
        tmp[1] = len--;
        hash_code = GetPixPairHash64(tmp);
        chain[pos] = hash_to_first_index[hash_code];
        hash_to_first_index[hash_code] = pos++;
      }
      argb_comp = 0;
    } else {
      hash_code = GetPixPairHash64(argb + pos);
      chain[pos] = hash_to_first_index[hash_code];
      hash_to_first_index[hash_code] = pos++;
      argb_comp = argb_comp_next;
    }
  }
  chain[pos] = hash_to_first_index[GetPixPairHash64(argb + pos)];

  p->offset_length[0] = p->offset_length[size - 1] = 0;
  for (uint32_t base_position = size - 2; base_position > 0;) {
    const int max_len = MaxFindCopyLength(size - 1 - int(base_position));
    const uint32_t* argb_start = argb + base_position;
    int iter = iter_max;
    int best_length = 0;
    uint32_t best_distance = 0;
    const int min_pos =
        (base_position > window_size) ? int(base_position - window_size) : 0;
    const int length_max = (max_len < 256) ? max_len : 256;
    pos = chain[base_position];
    int curr_length;
    if (base_position >= uint32_t(xsize)) {
      curr_length = FindMatchLength(argb_start - xsize, argb_start, best_length,
                                    max_len);
      if (curr_length > best_length) {
        best_length = curr_length;
        best_distance = xsize;
      }
      --iter;
    }
    curr_length = FindMatchLength(argb_start - 1, argb_start, best_length,
                                  max_len);
    if (curr_length > best_length) {
      best_length = curr_length;
      best_distance = 1;
    }
    --iter;
    if (best_length == MAX_LENGTH) pos = min_pos - 1;
    uint32_t best_argb = argb_start[best_length];
    for (; pos >= min_pos && --iter; pos = chain[pos]) {
      if (argb[pos + best_length] != best_argb) continue;
      curr_length = VectorMismatch(argb + pos, argb_start, max_len);
      if (best_length < curr_length) {
        best_length = curr_length;
        best_distance = base_position - pos;
        best_argb = argb_start[best_length];
        if (best_length >= length_max) break;
      }
    }
    uint32_t max_base_position = base_position;
    while (true) {
      p->offset_length[base_position] =
          (best_distance << MAX_LENGTH_BITS) | uint32_t(best_length);
      --base_position;
      if (best_distance == 0 || base_position == 0) break;
      if (base_position < best_distance ||
          argb[base_position - best_distance] != argb[base_position])
        break;
      if (best_length == MAX_LENGTH && best_distance != 1 &&
          base_position + MAX_LENGTH < max_base_position)
        break;
      if (best_length < MAX_LENGTH) {
        ++best_length;
        max_base_position = base_position;
      }
    }
  }
}

void AddSingleLiteral(uint32_t pixel, bool use_cache, ColorCache* cache,
                      Refs* refs) {
  if (use_cache) {
    const uint32_t key = cache->Index(pixel);
    if (cache->colors[key] == pixel) {
      refs->push_back(CacheIdx(key));
    } else {
      refs->push_back(Literal(pixel));
      cache->colors[key] = pixel;
    }
  } else {
    refs->push_back(Literal(pixel));
  }
}

void BackwardReferencesRle(int xsize, int ysize, const uint32_t* argb,
                           int cache_bits, Refs* refs) {
  const int pix_count = xsize * ysize;
  const bool use_cache = cache_bits > 0;
  ColorCache cache;
  if (use_cache) cache.Init(cache_bits);
  refs->clear();
  AddSingleLiteral(argb[0], use_cache, &cache, refs);
  int i = 1;
  while (i < pix_count) {
    const int max_len = MaxFindCopyLength(pix_count - i);
    const int rle_len = FindMatchLength(argb + i, argb + i - 1, 0, max_len);
    const int prev_row_len = (i < xsize) ? 0 :
        FindMatchLength(argb + i, argb + i - xsize, 0, max_len);
    if (rle_len >= prev_row_len && rle_len >= MIN_LENGTH) {
      refs->push_back(Copy(1, rle_len));
      i += rle_len;
    } else if (prev_row_len >= MIN_LENGTH) {
      refs->push_back(Copy(xsize, prev_row_len));
      if (use_cache)
        for (int k = 0; k < prev_row_len; ++k) cache.Insert(argb[i + k]);
      i += prev_row_len;
    } else {
      AddSingleLiteral(argb[i], use_cache, &cache, refs);
      i++;
    }
  }
}

void BackwardReferencesLz77(int xsize, int ysize, const uint32_t* argb,
                            int cache_bits, const HashChain& hash_chain,
                            Refs* refs) {
  const int pix_count = xsize * ysize;
  const bool use_cache = cache_bits > 0;
  ColorCache cache;
  if (use_cache) cache.Init(cache_bits);
  refs->clear();
  int i_last_check = -1;
  for (int i = 0; i < pix_count;) {
    int offset = hash_chain.Offset(i);
    int len = hash_chain.Length(i);
    if (len >= MIN_LENGTH) {
      const int len_ini = len;
      int max_reach = 0;
      const int j_max = (i + len_ini >= pix_count) ? pix_count - 1 : i + len_ini;
      i_last_check = (i > i_last_check) ? i : i_last_check;
      for (int j = i_last_check + 1; j <= j_max; ++j) {
        const int len_j = hash_chain.Length(j);
        const int reach = j + (len_j >= MIN_LENGTH ? len_j : 1);
        if (reach > max_reach) {
          len = j - i;
          max_reach = reach;
          if (max_reach >= pix_count) break;
        }
      }
    } else {
      len = 1;
    }
    if (len == 1) {
      AddSingleLiteral(argb[i], use_cache, &cache, refs);
    } else {
      refs->push_back(Copy(offset, len));
      if (use_cache)
        for (int j = i; j < i + len; ++j) cache.Insert(argb[j]);
    }
    i += len;
  }
}

void BackwardReferencesLz77Box(int xsize, int ysize, const uint32_t* argb,
                               int cache_bits, const HashChain& best,
                               HashChain* hash_chain, Refs* refs) {
  const int pix_count = xsize * ysize;
  constexpr int kWindowOffsetsSizeMax = 32;
  int window_offsets[kWindowOffsetsSizeMax] = {0};
  int window_offsets_new[kWindowOffsetsSizeMax] = {0};
  int window_offsets_size = 0;
  int window_offsets_new_size = 0;
  std::vector<uint16_t> counts_ini(pix_count);
  int best_offset_prev = -1, best_length_prev = -1;
  {
    int i = pix_count - 2;
    uint16_t* counts = counts_ini.data() + i;
    counts[1] = 1;
    for (; i >= 0; --i, --counts) {
      if (argb[i] == argb[i + 1]) {
        counts[0] = counts[1] + (counts[1] != MAX_LENGTH);
      } else {
        counts[0] = 1;
      }
    }
  }
  for (int y = 0; y <= 6; ++y) {
    for (int x = -6; x <= 6; ++x) {
      const int offset = y * xsize + x;
      if (offset <= 0) continue;
      const int plane_code = DistanceToPlaneCode(xsize, offset) - 1;
      if (plane_code >= kWindowOffsetsSizeMax) continue;
      window_offsets[plane_code] = offset;
    }
  }
  for (int i = 0; i < kWindowOffsetsSizeMax; ++i) {
    if (window_offsets[i] == 0) continue;
    window_offsets[window_offsets_size++] = window_offsets[i];
  }
  for (int i = 0; i < window_offsets_size; ++i) {
    bool is_reachable = false;
    for (int j = 0; j < window_offsets_size && !is_reachable; ++j)
      is_reachable |= (window_offsets[i] == window_offsets[j] + 1);
    if (!is_reachable)
      window_offsets_new[window_offsets_new_size++] = window_offsets[i];
  }

  hash_chain->offset_length.assign(pix_count, 0);
  for (int i = 1; i < pix_count; ++i) {
    int best_length = best.Length(i);
    int best_offset = 0;
    bool do_compute = true;
    if (best_length >= MAX_LENGTH) {
      best_offset = best.Offset(i);
      for (int ind = 0; ind < window_offsets_size; ++ind) {
        if (best_offset == window_offsets[ind]) {
          do_compute = false;
          break;
        }
      }
    }
    if (do_compute) {
      const bool use_prev = (best_length_prev > 1) && (best_length_prev < MAX_LENGTH);
      const int num_ind = use_prev ? window_offsets_new_size : window_offsets_size;
      best_length = use_prev ? best_length_prev - 1 : 0;
      best_offset = use_prev ? best_offset_prev : 0;
      for (int ind = 0; ind < num_ind; ++ind) {
        int curr_length = 0;
        int j = i;
        int j_offset = use_prev ? i - window_offsets_new[ind] : i - window_offsets[ind];
        if (j_offset < 0 || argb[j_offset] != argb[i]) continue;
        do {
          const int counts_j_offset = counts_ini[j_offset];
          const int counts_j = counts_ini[j];
          if (counts_j_offset != counts_j) {
            curr_length += (counts_j_offset < counts_j) ? counts_j_offset : counts_j;
            break;
          }
          curr_length += counts_j_offset;
          j_offset += counts_j_offset;
          j += counts_j_offset;
        } while (curr_length <= MAX_LENGTH && j < pix_count &&
                 argb[j_offset] == argb[j]);
        if (best_length < curr_length) {
          best_offset = use_prev ? window_offsets_new[ind] : window_offsets[ind];
          if (curr_length >= MAX_LENGTH) {
            best_length = MAX_LENGTH;
            break;
          } else {
            best_length = curr_length;
          }
        }
      }
    }
    if (best_length <= MIN_LENGTH) {
      hash_chain->offset_length[i] = 0;
      best_offset_prev = 0;
      best_length_prev = 0;
    } else {
      hash_chain->offset_length[i] =
          (uint32_t(best_offset) << MAX_LENGTH_BITS) | uint32_t(best_length);
      best_offset_prev = best_offset;
      best_length_prev = best_length;
    }
  }
  hash_chain->offset_length[0] = 0;
  BackwardReferencesLz77(xsize, ysize, argb, cache_bits, *hash_chain, refs);
}

// ---------------------------------------------------------------------------
// Histograms

inline int HistogramNumCodes(int cache_bits) {
  return NUM_LITERAL_CODES + NUM_LENGTH_CODES +
         ((cache_bits > 0) ? (1 << cache_bits) : 0);
}

struct Histogram {
  std::vector<uint32_t> literal;
  uint32_t red[256], blue[256], alpha[256], distance[NUM_DISTANCE_CODES];
  int palette_code_bits = 0;
  uint32_t trivial_symbol = NON_TRIVIAL_SYM;
  uint64_t bit_cost = 0;
  uint64_t costs[5] = {0, 0, 0, 0, 0};
  uint8_t is_used[5] = {0, 0, 0, 0, 0};
  int bin_id = 0;

  explicit Histogram(int cache_bits = 0) { Init(cache_bits); }
  void Init(int cache_bits) {
    palette_code_bits = cache_bits;
    literal.assign(HistogramNumCodes(cache_bits), 0);
    std::memset(red, 0, sizeof(red));
    std::memset(blue, 0, sizeof(blue));
    std::memset(alpha, 0, sizeof(alpha));
    std::memset(distance, 0, sizeof(distance));
    trivial_symbol = NON_TRIVIAL_SYM;
    bit_cost = 0;
    std::memset(costs, 0, sizeof(costs));
    std::memset(is_used, 0, sizeof(is_used));
  }
  const uint32_t* Population(int k, int* length) const {
    switch (k) {
      case 0: *length = int(literal.size()); return literal.data();
      case 1: *length = 256; return red;
      case 2: *length = 256; return blue;
      case 3: *length = 256; return alpha;
      default: *length = NUM_DISTANCE_CODES; return distance;
    }
  }
  uint32_t* Population(int k) {
    int length;
    return const_cast<uint32_t*>(
        static_cast<const Histogram*>(this)->Population(k, &length));
  }
};

// distance_xsize > 0 maps distances to plane codes first (CostModelBuild).
void AddSinglePixOrCopy(Histogram* h, const PixOrCopy& v, int distance_xsize) {
  if (v.mode == 0) {
    ++h->alpha[v.argb_or_distance >> 24];
    ++h->red[(v.argb_or_distance >> 16) & 0xff];
    ++h->literal[(v.argb_or_distance >> 8) & 0xff];
    ++h->blue[v.argb_or_distance & 0xff];
  } else if (v.mode == 1) {
    ++h->literal[NUM_LITERAL_CODES + NUM_LENGTH_CODES + v.argb_or_distance];
  } else {
    int code, extra_bits, extra_value;
    PrefixEncode(v.len, &code, &extra_bits, &extra_value);
    ++h->literal[NUM_LITERAL_CODES + code];
    const int d = distance_xsize > 0
        ? DistanceToPlaneCode(distance_xsize, int(v.argb_or_distance))
        : int(v.argb_or_distance);
    PrefixEncode(d, &code, &extra_bits, &extra_value);
    ++h->distance[code];
  }
}

void HistogramCreate(Histogram* h, const Refs& refs, int cache_bits) {
  h->Init(cache_bits);
  for (const PixOrCopy& v : refs) AddSinglePixOrCopy(h, v, 0);
}

uint64_t HistogramEstimateBits(Histogram* h) {
  uint64_t cost = 0;
  for (int k = 0; k < 5; ++k) {
    int length;
    const uint32_t* p = h->Population(k, &length);
    cost += PopulationCost(p, nullptr, length, nullptr, &h->is_used[k]);
  }
  cost += uint64_t(ExtraCost(h->literal.data() + NUM_LITERAL_CODES,
                             NUM_LENGTH_CODES) +
                   ExtraCost(h->distance, NUM_DISTANCE_CODES))
          << LOG_2_PRECISION_BITS;
  return cost;
}

void UpdateHistogramCost(Histogram* h) {
  uint32_t syms[5];
  for (int k = 0; k < 5; ++k) {
    int length;
    const uint32_t* p = h->Population(k, &length);
    h->costs[k] = PopulationCost(p, nullptr, length, &syms[k], &h->is_used[k]);
  }

  h->bit_cost = h->costs[0] + h->costs[1] + h->costs[2] + h->costs[3] +
                h->costs[4];
  if ((syms[3] | syms[1] | syms[2]) == NON_TRIVIAL_SYM ||
      syms[3] == NON_TRIVIAL_SYM || syms[1] == NON_TRIVIAL_SYM ||
      syms[2] == NON_TRIVIAL_SYM) {
    h->trivial_symbol = NON_TRIVIAL_SYM;
  } else {
    h->trivial_symbol = (syms[3] << 24) | (syms[1] << 16) | syms[2];
  }
}

void HistogramAdd(const Histogram& a, const Histogram& b, Histogram* out) {
  for (size_t i = 0; i < out->literal.size(); ++i)
    out->literal[i] = a.literal[i] + b.literal[i];
  for (int i = 0; i < 256; ++i) {
    out->red[i] = a.red[i] + b.red[i];
    out->blue[i] = a.blue[i] + b.blue[i];
    out->alpha[i] = a.alpha[i] + b.alpha[i];
  }
  for (int i = 0; i < NUM_DISTANCE_CODES; ++i)
    out->distance[i] = a.distance[i] + b.distance[i];
  out->trivial_symbol =
      (a.trivial_symbol == b.trivial_symbol) ? a.trivial_symbol : NON_TRIVIAL_SYM;
  for (int k = 0; k < 5; ++k) out->is_used[k] = a.is_used[k] | b.is_used[k];
}

// The cost of a + b, component by component, with libwebp's early exit
// once the partial sum reaches the threshold (false then).
bool GetCombinedHistogramEntropy(const Histogram& a, const Histogram& b,
                                 int64_t cost_threshold, uint64_t* cost,
                                 uint64_t costs[5]) {
  if (cost_threshold <= 0) return false;
  *cost = 0;
  for (int k = 0; k < 5; ++k) {
    int length;
    const uint32_t* x = a.Population(k, &length);
    const uint32_t* y = b.Population(k, &length);
    uint64_t c;
    if (!a.is_used[k] || !b.is_used[k]) {
      c = a.is_used[k] ? a.costs[k] : b.costs[k];
    } else {
      c = PopulationCost(x, y, length, nullptr, nullptr);
    }
    costs[k] = c;
    *cost += c;
    if (*cost >= uint64_t(cost_threshold)) return false;
  }
  return true;
}

inline void SaturateAdd(uint64_t a, int64_t* b) {
  if (*b < 0 || int64_t(a) <= INT64_MAX - *b) {
    *b += int64_t(a);
  } else {
    *b = INT64_MAX;
  }
}

// A dense set of histograms: removing one moves the last into its slot
// (HistogramSetRemoveHistogram).
struct HistoSet {
  std::vector<Histogram*> h;
  int size = 0;
  void Remove(int i) {
    h[i] = h[size - 1];
    --size;
  }
};

struct HistogramPair {
  int idx1, idx2;
  int64_t cost_diff;
  uint64_t cost_combo;
  uint64_t costs[5];
};

// Replaces bad_id by good_id in the pair, keeping idx1 < idx2.
void HistoQueueFixPair(int bad_id, int good_id, HistogramPair* pair) {
  if (pair->idx1 == bad_id) pair->idx1 = good_id;
  if (pair->idx2 == bad_id) pair->idx2 = good_id;
  if (pair->idx1 > pair->idx2) std::swap(pair->idx1, pair->idx2);
}

struct HistoQueue {
  std::vector<HistogramPair> queue;
  int size = 0;
  int max_size = 0;
  explicit HistoQueue(int n) : queue(std::max(n, 1)), max_size(n) {}
  void PopPair(HistogramPair* pair) {
    *pair = queue[size - 1];
    --size;
  }
  void UpdateHead(HistogramPair* pair) {
    if (pair->cost_diff < queue[0].cost_diff) std::swap(queue[0], *pair);
  }
};

bool HistoQueueUpdatePair(const Histogram& h1, const Histogram& h2,
                          int64_t threshold, HistogramPair* pair) {
  const uint64_t sum_cost = h1.bit_cost + h2.bit_cost;
  SaturateAdd(sum_cost, &threshold);
  if (!GetCombinedHistogramEntropy(h1, h2, threshold, &pair->cost_combo,
                                   pair->costs))
    return false;
  pair->cost_diff = int64_t(pair->cost_combo) - int64_t(sum_cost);
  return true;
}

int64_t HistoQueuePush(HistoQueue* q, Histogram** histograms, int idx1,
                       int idx2, int64_t threshold) {
  if (q->size == q->max_size) return 0;
  if (idx1 > idx2) std::swap(idx1, idx2);
  HistogramPair pair;
  pair.idx1 = idx1;
  pair.idx2 = idx2;
  if (!HistoQueueUpdatePair(*histograms[idx1], *histograms[idx2], threshold,
                            &pair))
    return 0;
  q->queue[q->size++] = pair;
  q->UpdateHead(&q->queue[q->size - 1]);
  return pair.cost_diff;
}

void MergeInto(const HistogramPair& pair, Histogram* dst, const Histogram& src) {
  HistogramAdd(src, *dst, dst);
  dst->bit_cost = pair.cost_combo;
  for (int k = 0; k < 5; ++k) dst->costs[k] = pair.costs[k];
}

void HistogramCombineGreedy(HistoSet* set) {
  const int n = set->size;
  Histogram** histograms = set->h.data();
  HistoQueue q(n * n);
  for (int i = 0; i < n; ++i)
    for (int j = i + 1; j < n; ++j) HistoQueuePush(&q, histograms, i, j, 0);
  while (q.size > 0) {
    const int idx1 = q.queue[0].idx1;
    const int idx2 = q.queue[0].idx2;
    MergeInto(q.queue[0], histograms[idx1], *histograms[idx2]);
    set->Remove(idx2);
    for (int i = 0; i < q.size;) {
      HistogramPair* p = &q.queue[i];
      if (p->idx1 == idx1 || p->idx2 == idx1 || p->idx1 == idx2 ||
          p->idx2 == idx2) {
        q.PopPair(p);
      } else {
        HistoQueueFixPair(set->size, idx2, p);
        q.UpdateHead(p);
        ++i;
      }
    }
    for (int i = 0; i < set->size; ++i) {
      if (i == idx1) continue;
      HistoQueuePush(&q, histograms, idx1, i, 0);
    }
  }
}

// MINSTD, libwebp's MyRand.
uint32_t MyRand(uint32_t* seed) {
  *seed = uint32_t((uint64_t(*seed) * 48271u) % 2147483647u);
  return *seed;
}

void HistogramCombineStochastic(HistoSet* set, int min_cluster_size,
                                bool* do_greedy) {
  uint32_t seed = 1;
  int tries_with_no_success = 0;
  const int outer_iters = set->size;
  const int num_tries_no_success = outer_iters / 2;
  Histogram** histograms = set->h.data();
  HistoQueue q(9);
  if (set->size < min_cluster_size) {
    *do_greedy = true;
    return;
  }
  for (int iter = 0; iter < outer_iters && set->size >= min_cluster_size &&
                     ++tries_with_no_success < num_tries_no_success;
       ++iter) {
    int64_t best_cost = (q.size == 0) ? 0 : q.queue[0].cost_diff;
    const uint32_t rand_range = uint32_t((set->size - 1) * set->size);
    const int num_tries = set->size / 2;
    for (int j = 0; set->size >= 2 && j < num_tries; ++j) {
      const uint32_t tmp = MyRand(&seed) % rand_range;
      const uint32_t idx1 = tmp / (set->size - 1);
      uint32_t idx2 = tmp % (set->size - 1);
      if (idx2 >= idx1) ++idx2;
      const int64_t curr_cost =
          HistoQueuePush(&q, histograms, int(idx1), int(idx2), best_cost);
      if (curr_cost < 0) {
        best_cost = curr_cost;
        if (q.size == q.max_size) break;
      }
    }
    if (q.size == 0) continue;

    const int best_idx1 = q.queue[0].idx1;
    const int best_idx2 = q.queue[0].idx2;
    MergeInto(q.queue[0], histograms[best_idx1], *histograms[best_idx2]);
    set->Remove(best_idx2);
    for (int j = 0; j < q.size;) {
      HistogramPair* p = &q.queue[j];
      const bool is_idx1_best = p->idx1 == best_idx1 || p->idx1 == best_idx2;
      const bool is_idx2_best = p->idx2 == best_idx1 || p->idx2 == best_idx2;
      if (is_idx1_best && is_idx2_best) {
        q.PopPair(p);
        continue;
      }
      if (is_idx1_best || is_idx2_best) {
        HistoQueueFixPair(best_idx2, best_idx1, p);
        if (!HistoQueueUpdatePair(*histograms[p->idx1], *histograms[p->idx2], 0,
                                  p)) {
          q.PopPair(p);
          continue;
        }
      }
      HistoQueueFixPair(set->size, best_idx2, p);
      q.UpdateHead(p);
      ++j;
    }
    tries_with_no_success = 0;
  }
  *do_greedy = (set->size <= min_cluster_size);
}

constexpr int NUM_PARTITIONS = 4;
constexpr int BIN_SIZE = NUM_PARTITIONS * NUM_PARTITIONS * NUM_PARTITIONS;

int GetBinIdForEntropy(uint64_t min, uint64_t max, uint64_t val) {
  const uint64_t range = max - min;
  if (range > 0) {
    const uint64_t delta = val - min;
    return int((NUM_PARTITIONS - 1e-6) * double(delta) / double(range));
  }
  return 0;
}

void HistogramAnalyzeEntropyBin(HistoSet* set) {
  uint64_t lmin = UINT64_MAX, lmax = 0, rmin = UINT64_MAX, rmax = 0,
           bmin = UINT64_MAX, bmax = 0;
  for (int i = 0; i < set->size; ++i) {
    const Histogram* h = set->h[i];
    lmax = std::max(lmax, h->costs[0]);
    lmin = std::min(lmin, h->costs[0]);
    rmax = std::max(rmax, h->costs[1]);
    rmin = std::min(rmin, h->costs[1]);
    bmax = std::max(bmax, h->costs[2]);
    bmin = std::min(bmin, h->costs[2]);
  }
  for (int i = 0; i < set->size; ++i) {
    Histogram* h = set->h[i];
    int bin_id = GetBinIdForEntropy(lmin, lmax, h->costs[0]);
    bin_id = bin_id * NUM_PARTITIONS + GetBinIdForEntropy(rmin, rmax, h->costs[1]);
    bin_id = bin_id * NUM_PARTITIONS + GetBinIdForEntropy(bmin, bmax, h->costs[2]);
    h->bin_id = bin_id;
  }
}

void HistogramCombineEntropyBin(HistoSet* set, Histogram* cur_combo,
                                int num_bins, int32_t combine_cost_factor) {
  Histogram** histograms = set->h.data();
  struct { int first; int num_combine_failures; } bin_info[BIN_SIZE];
  for (int idx = 0; idx < num_bins; ++idx) {
    bin_info[idx].first = -1;
    bin_info[idx].num_combine_failures = 0;
  }
  for (int idx = 0; idx < set->size;) {
    const int bin_id = histograms[idx]->bin_id;
    const int first = bin_info[bin_id].first;
    if (first == -1) {
      bin_info[bin_id].first = idx;
      ++idx;
      continue;
    }
    const uint64_t bit_cost = histograms[idx]->bit_cost;
    int64_t threshold = -DivRound(int64_t(bit_cost) * combine_cost_factor, 100);
    const Histogram& a = *histograms[first];
    const Histogram& b = *histograms[idx];
    SaturateAdd(a.bit_cost + b.bit_cost, &threshold);
    uint64_t cost, costs[5];
    if (!GetCombinedHistogramEntropy(a, b, threshold, &cost, costs)) {
      ++idx;
      continue;
    }
    HistogramAdd(a, b, cur_combo);
    cur_combo->bit_cost = cost;
    for (int k = 0; k < 5; ++k) cur_combo->costs[k] = costs[k];
    const bool try_combine =
        (cur_combo->trivial_symbol != NON_TRIVIAL_SYM) ||
        ((histograms[idx]->trivial_symbol == NON_TRIVIAL_SYM) &&
         (histograms[first]->trivial_symbol == NON_TRIVIAL_SYM));
    const int max_combine_failures = 32;
    if (try_combine ||
        bin_info[bin_id].num_combine_failures >= max_combine_failures) {
      std::swap(*cur_combo, *histograms[first]);
      set->Remove(idx);
    } else {
      ++bin_info[bin_id].num_combine_failures;
      ++idx;
    }
  }
}

int32_t GetCombineCostFactor(int histo_size, int quality) {
  int32_t f = 16;
  if (quality < 90) {
    if (histo_size > 256) f /= 2;
    if (histo_size > 512) f /= 2;
    if (histo_size > 1024) f /= 2;
    if (quality <= 50) f /= 2;
  }
  return f;
}

bool HistogramAddThresh(const Histogram& a, const Histogram& b,
                        int64_t cost_threshold, int64_t* cost_out) {
  uint64_t cost, costs[5];
  SaturateAdd(a.bit_cost, &cost_threshold);
  if (!GetCombinedHistogramEntropy(a, b, cost_threshold, &cost, costs))
    return false;
  *cost_out = int64_t(cost) - int64_t(a.bit_cost);
  return true;
}

// VP8LGetHistoImageSymbols: the clusters (out) and each tile's (symbols).
void GetHistoImageSymbols(int xsize, int ysize, const Refs& refs, int quality,
                          int histogram_bits, int cache_bits,
                          std::vector<Histogram>* out,
                          std::vector<uint32_t>* symbols) {
  const int histo_xsize = SubSampleSize(xsize, histogram_bits);
  const int histo_ysize = SubSampleSize(ysize, histogram_bits);
  const int raw_size = histo_xsize * histo_ysize;
  std::vector<Histogram> orig(raw_size, Histogram(cache_bits));
  {
    int x = 0, y = 0;
    for (const PixOrCopy& v : refs) {
      const int ix = (y >> histogram_bits) * histo_xsize + (x >> histogram_bits);
      AddSinglePixOrCopy(&orig[ix], v, 0);
      x += v.len;
      while (x >= xsize) {
        x -= xsize;
        ++y;
      }
    }
  }
  // HistogramCopyAndAnalyze: the tiles with something coded, in order.
  std::vector<bool> orig_used(raw_size, true);
  std::vector<Histogram> storage;
  storage.reserve(raw_size);
  for (int i = 0; i < raw_size; ++i) {
    UpdateHistogramCost(&orig[i]);
    const Histogram& h = orig[i];
    if (!h.is_used[0] && !h.is_used[1] && !h.is_used[2] && !h.is_used[3] &&
        !h.is_used[4]) {
      orig_used[i] = false;
    } else {
      storage.push_back(h);
    }
  }
  HistoSet set;
  for (Histogram& h : storage) set.h.push_back(&h);
  set.size = int(storage.size());
  symbols->assign(raw_size, 0);
  const int entropy_combine_num_bins = BIN_SIZE;
  const bool entropy_combine =
      (set.size > entropy_combine_num_bins * 2) && (quality < 100);
  if (entropy_combine) {
    Histogram cur_combo(cache_bits);
    const int32_t factor = GetCombineCostFactor(raw_size, quality);
    HistogramAnalyzeEntropyBin(&set);
    HistogramCombineEntropyBin(&set, &cur_combo, entropy_combine_num_bins,
                               factor);
  }
  {
    const int threshold_size =
        int(1 + DivRound(int64_t(quality) * quality * quality * (100 - 1),
                         100 * 100 * 100));
    bool do_greedy = false;
    HistogramCombineStochastic(&set, threshold_size, &do_greedy);
    if (do_greedy) HistogramCombineGreedy(&set);
  }
  // HistogramRemap
  const int out_size = set.size;
  if (out_size > 1) {
    for (int i = 0; i < raw_size; ++i) {
      if (!orig_used[i]) {
        (*symbols)[i] = (*symbols)[i - 1];
        continue;
      }
      int best_out = 0;
      int64_t best_bits = INT64_MAX;
      for (int k = 0; k < out_size; ++k) {
        int64_t cur_bits;
        if (HistogramAddThresh(*set.h[k], orig[i], best_bits, &cur_bits)) {
          best_bits = cur_bits;
          best_out = k;
        }
      }
      (*symbols)[i] = best_out;
    }
  } else {
    for (int i = 0; i < raw_size; ++i) (*symbols)[i] = 0;
  }
  out->assign(out_size, Histogram(cache_bits));
  for (int i = 0; i < raw_size; ++i) {
    if (!orig_used[i]) continue;
    Histogram& dst = (*out)[(*symbols)[i]];
    HistogramAdd(orig[i], dst, &dst);
  }
}

// ---------------------------------------------------------------------------
// The cost model and TraceBackwards (backward_references_cost_enc.c)

struct CostModel {
  uint32_t alpha[256], red[256], blue[256], distance[NUM_DISTANCE_CODES];
  std::vector<uint32_t> literal;
};

void ConvertPopulationCountTableToBitEstimates(int num_symbols,
                                               const uint32_t* counts,
                                               uint32_t* output) {
  uint32_t sum = 0;
  int nonzeros = 0;
  for (int i = 0; i < num_symbols; ++i) {
    sum += counts[i];
    if (counts[i] > 0) ++nonzeros;
  }
  if (nonzeros <= 1) {
    std::memset(output, 0, num_symbols * sizeof(*output));
  } else {
    const uint32_t logsum = FastLog2(sum);
    for (int i = 0; i < num_symbols; ++i) output[i] = logsum - FastLog2(counts[i]);
  }
}

void CostModelBuild(CostModel* m, int xsize, int cache_bits, const Refs& refs) {
  Histogram h(cache_bits);
  for (const PixOrCopy& v : refs) AddSinglePixOrCopy(&h, v, xsize);
  m->literal.assign(HistogramNumCodes(cache_bits), 0);
  ConvertPopulationCountTableToBitEstimates(HistogramNumCodes(cache_bits),
                                            h.literal.data(), m->literal.data());
  ConvertPopulationCountTableToBitEstimates(256, h.red, m->red);
  ConvertPopulationCountTableToBitEstimates(256, h.blue, m->blue);
  ConvertPopulationCountTableToBitEstimates(256, h.alpha, m->alpha);
  ConvertPopulationCountTableToBitEstimates(NUM_DISTANCE_CODES, h.distance,
                                            m->distance);
}

inline int64_t GetLiteralCost(const CostModel& m, uint32_t v) {
  return int64_t(m.alpha[v >> 24]) + m.red[(v >> 16) & 0xff] +
         m.literal[(v >> 8) & 0xff] + m.blue[v & 0xff];
}
inline int64_t GetCacheCost(const CostModel& m, uint32_t idx) {
  return m.literal[NUM_LITERAL_CODES + NUM_LENGTH_CODES + idx];
}
inline int64_t GetLengthCost(const CostModel& m, uint32_t length) {
  int code, extra_bits, extra_value;
  PrefixEncode(int(length), &code, &extra_bits, &extra_value);
  return int64_t(m.literal[NUM_LITERAL_CODES + code]) +
         (int64_t(extra_bits) << LOG_2_PRECISION_BITS);
}
inline int64_t GetDistanceCost(const CostModel& m, uint32_t distance) {
  int code, extra_bits, extra_value;
  PrefixEncode(int(distance), &code, &extra_bits, &extra_value);
  return int64_t(m.distance[code]) + (int64_t(extra_bits) << LOG_2_PRECISION_BITS);
}

struct CostInterval {
  int64_t cost;
  int start, end, index;
  CostInterval* previous;
  CostInterval* next;
};

struct CostCacheInterval {
  int64_t cost;
  int start, end;
};

constexpr int COST_CACHE_INTERVAL_SIZE_MAX = 500;

struct CostManager {
  CostInterval* head = nullptr;
  int count = 0;
  std::vector<CostCacheInterval> cache_intervals;
  std::vector<int64_t> cost_cache;
  std::vector<int64_t> costs;
  uint16_t* dist_array = nullptr;
  std::vector<CostInterval*> pool;
  std::vector<CostInterval*> free_list;

  ~CostManager() {
    for (CostInterval* p : pool) delete p;
  }
  CostInterval* Alloc() {
    if (!free_list.empty()) {
      CostInterval* p = free_list.back();
      free_list.pop_back();
      return p;
    }
    pool.push_back(new CostInterval());
    return pool.back();
  }
};

void CostManagerInit(CostManager* m, uint16_t* dist_array, int pix_count,
                     const CostModel& model) {
  const int cost_cache_size = (pix_count > MAX_LENGTH) ? MAX_LENGTH : pix_count;
  m->dist_array = dist_array;
  m->cost_cache.resize(cost_cache_size);
  for (int i = 0; i < cost_cache_size; ++i)
    m->cost_cache[i] = GetLengthCost(model, uint32_t(i));
  m->cache_intervals.clear();
  CostCacheInterval cur = {m->cost_cache[0], 0, 1};
  for (int i = 1; i < cost_cache_size; ++i) {
    const int64_t cost_val = m->cost_cache[i];
    if (cost_val != cur.cost) {
      m->cache_intervals.push_back(cur);
      cur.start = i;
      cur.cost = cost_val;
    }
    cur.end = i + 1;
  }
  m->cache_intervals.push_back(cur);
  m->costs.assign(pix_count, INT64_MAX);
}

inline void UpdateCost(CostManager* m, int i, int position, int64_t cost) {
  const int k = i - position;
  if (m->costs[i] > cost) {
    m->costs[i] = cost;
    m->dist_array[i] = uint16_t(k + 1);
  }
}

inline void UpdateCostPerInterval(CostManager* m, int start, int end,
                                  int position, int64_t cost) {
  for (int i = start; i < end; ++i) UpdateCost(m, i, position, cost);
}

inline void ConnectIntervals(CostManager* m, CostInterval* prev,
                             CostInterval* next) {
  if (prev != nullptr) {
    prev->next = next;
  } else {
    m->head = next;
  }
  if (next != nullptr) next->previous = prev;
}

inline void PopInterval(CostManager* m, CostInterval* interval) {
  if (interval == nullptr) return;
  ConnectIntervals(m, interval->previous, interval->next);
  m->free_list.push_back(interval);
  --m->count;
}

void UpdateCostAtIndex(CostManager* m, int i, bool do_clean_intervals) {
  CostInterval* current = m->head;
  while (current != nullptr && current->start <= i) {
    CostInterval* next = current->next;
    if (current->end <= i) {
      if (do_clean_intervals) PopInterval(m, current);
    } else {
      UpdateCost(m, i, current->index, current->cost);
    }
    current = next;
  }
}

void PositionOrphanInterval(CostManager* m, CostInterval* current,
                            CostInterval* previous) {
  if (previous == nullptr) previous = m->head;
  while (previous != nullptr && current->start < previous->start)
    previous = previous->previous;
  while (previous != nullptr && previous->next != nullptr &&
         previous->next->start < current->start)
    previous = previous->next;
  if (previous != nullptr) {
    ConnectIntervals(m, current, previous->next);
  } else {
    ConnectIntervals(m, current, m->head);
  }
  ConnectIntervals(m, previous, current);
}

void InsertInterval(CostManager* m, CostInterval* interval_in, int64_t cost,
                    int position, int start, int end) {
  if (start >= end) return;
  if (m->count >= COST_CACHE_INTERVAL_SIZE_MAX) {
    UpdateCostPerInterval(m, start, end, position, cost);
    return;
  }
  CostInterval* interval_new = m->Alloc();
  interval_new->cost = cost;
  interval_new->index = position;
  interval_new->start = start;
  interval_new->end = end;
  interval_new->previous = interval_new->next = nullptr;
  PositionOrphanInterval(m, interval_new, interval_in);
  ++m->count;
}

void PushInterval(CostManager* m, int64_t distance_cost, int position, int len) {
  const int kSkipDistance = 10;
  if (len < kSkipDistance) {
    for (int j = position; j < position + len; ++j) {
      const int k = j - position;
      const int64_t cost_tmp = distance_cost + m->cost_cache[k];
      if (m->costs[j] > cost_tmp) {
        m->costs[j] = cost_tmp;
        m->dist_array[j] = uint16_t(k + 1);
      }
    }
    return;
  }
  CostInterval* interval = m->head;
  for (size_t i = 0; i < m->cache_intervals.size() &&
                     m->cache_intervals[i].start < len;
       ++i) {
    int start = position + m->cache_intervals[i].start;
    const int end = position + (m->cache_intervals[i].end > len
                                    ? len : m->cache_intervals[i].end);
    const int64_t cost = distance_cost + m->cache_intervals[i].cost;
    CostInterval* interval_next;
    for (; interval != nullptr && interval->start < end;
         interval = interval_next) {
      interval_next = interval->next;
      if (start >= interval->end) continue;
      if (cost >= interval->cost) {
        const int start_new = interval->end;
        InsertInterval(m, interval, cost, position, start, interval->start);
        start = start_new;
        if (start >= end) break;
        continue;
      }
      if (start <= interval->start) {
        if (interval->end <= end) {
          PopInterval(m, interval);
        } else {
          interval->start = end;
          break;
        }
      } else {
        if (end < interval->end) {
          const int end_original = interval->end;
          interval->end = start;
          InsertInterval(m, interval, interval->cost, interval->index, end,
                         end_original);
          interval = interval->next;
          break;
        } else {
          interval->end = start;
        }
      }
    }
    InsertInterval(m, interval, cost, position, start, end);
  }
}

void AddSingleLiteralWithCostModel(const uint32_t* argb, ColorCache* cache,
                                   const CostModel& model, int idx,
                                   bool use_cache, int64_t prev_cost,
                                   int64_t* cost, uint16_t* dist_array) {
  int64_t cost_val = prev_cost;
  const uint32_t color = argb[idx];
  const int ix = use_cache ? cache->Contains(color) : -1;
  if (ix >= 0) {
    cost_val += DivRound(GetCacheCost(model, uint32_t(ix)) * 68, 100);
  } else {
    if (use_cache) cache->Insert(color);
    cost_val += DivRound(GetLiteralCost(model, color) * 82, 100);
  }
  if (cost[idx] > cost_val) {
    cost[idx] = cost_val;
    dist_array[idx] = 1;
  }
}

void BackwardReferencesHashChainDistanceOnly(int xsize, int ysize,
                                             const uint32_t* argb,
                                             int cache_bits,
                                             const HashChain& hash_chain,
                                             const Refs& refs,
                                             uint16_t* dist_array) {
  const int pix_count = xsize * ysize;
  const bool use_cache = cache_bits > 0;
  CostModel model;
  ColorCache cache;
  if (use_cache) cache.Init(cache_bits);
  CostModelBuild(&model, xsize, cache_bits, refs);
  CostManager m;
  CostManagerInit(&m, dist_array, pix_count, model);
  int offset_prev = -1, len_prev = -1;
  int64_t offset_cost = -1;
  int first_offset_is_constant = -1;
  int reach = 0;
  dist_array[0] = 0;
  AddSingleLiteralWithCostModel(argb, &cache, model, 0, use_cache, 0,
                                m.costs.data(), dist_array);
  for (int i = 1; i < pix_count; ++i) {
    const int64_t prev_cost = m.costs[i - 1];
    const int offset = hash_chain.Offset(i);
    const int len = hash_chain.Length(i);
    AddSingleLiteralWithCostModel(argb, &cache, model, i, use_cache, prev_cost,
                                  m.costs.data(), dist_array);
    if (len >= 2) {
      if (offset != offset_prev) {
        const int code = DistanceToPlaneCode(xsize, offset);
        offset_cost = GetDistanceCost(model, uint32_t(code));
        first_offset_is_constant = 1;
        PushInterval(&m, prev_cost + offset_cost, i, len);
      } else {
        if (first_offset_is_constant) {
          reach = i - 1 + len_prev - 1;
          first_offset_is_constant = 0;
        }
        if (i + len - 1 > reach) {
          int offset_j = 0, len_j = 0;
          int j;
          for (j = i; j <= reach; ++j) {
            offset_j = hash_chain.Offset(j + 1);
            len_j = hash_chain.Length(j + 1);
            if (offset_j != offset) {
              offset_j = hash_chain.Offset(j);
              len_j = hash_chain.Length(j);
              break;
            }
          }
          UpdateCostAtIndex(&m, j - 1, false);
          UpdateCostAtIndex(&m, j, false);
          PushInterval(&m, m.costs[j - 1] + offset_cost, j, len_j);
          reach = j + len_j - 1;
        }
      }
    }
    UpdateCostAtIndex(&m, i, true);
    offset_prev = offset;
    len_prev = len;
  }
}

void TraceBackwardsRefs(int xsize, int ysize, const uint32_t* argb,
                        int cache_bits, const HashChain& hash_chain,
                        const Refs& refs_src, Refs* refs_dst) {
  const int n = xsize * ysize;
  std::vector<uint16_t> dist_array(n);
  BackwardReferencesHashChainDistanceOnly(xsize, ysize, argb, cache_bits,
                                          hash_chain, refs_src,
                                          dist_array.data());
  std::vector<uint16_t> path;
  for (int cur = n - 1; cur >= 0;) {
    const int k = dist_array[cur];
    path.push_back(uint16_t(k));
    cur -= k;
  }
  std::reverse(path.begin(), path.end());
  const bool use_cache = cache_bits > 0;
  ColorCache cache;
  if (use_cache) cache.Init(cache_bits);
  refs_dst->clear();
  int i = 0;
  for (uint16_t len : path) {
    if (len == 1) {
      AddSingleLiteral(argb[i], use_cache, &cache, refs_dst);
      ++i;
    } else {
      const int offset = hash_chain.Offset(i);
      refs_dst->push_back(Copy(offset, len));
      if (use_cache)
        for (int k = 0; k < len; ++k) cache.Insert(argb[i + k]);
      i += len;
    }
  }
}

// ---------------------------------------------------------------------------
// The choice of backward references and colour cache

void CalculateBestCacheSize(const uint32_t* argb, int quality, const Refs& refs,
                            int* best_cache_bits) {
  const int cache_bits_max = (quality <= 25) ? 0 : *best_cache_bits;
  if (cache_bits_max == 0) {
    *best_cache_bits = 0;
    return;
  }
  std::vector<Histogram> histos;
  ColorCache hashers[MAX_COLOR_CACHE_BITS + 1];
  for (int i = 0; i <= cache_bits_max; ++i) {
    histos.emplace_back(i);
    if (i > 0) hashers[i].Init(i);
  }
  for (const PixOrCopy& v : refs) {
    if (v.mode != 2) {
      const uint32_t pix = *argb++;
      const uint32_t a = (pix >> 24) & 0xff, r = (pix >> 16) & 0xff,
                     g = (pix >> 8) & 0xff, b = pix & 0xff;
      uint32_t key = HashPix(pix, 32 - cache_bits_max);
      ++histos[0].blue[b];
      ++histos[0].literal[g];
      ++histos[0].red[r];
      ++histos[0].alpha[a];
      for (int i = cache_bits_max; i >= 1; --i, key >>= 1) {
        if (hashers[i].colors[key] == pix) {
          ++histos[i].literal[NUM_LITERAL_CODES + NUM_LENGTH_CODES + key];
        } else {
          hashers[i].colors[key] = pix;
          ++histos[i].blue[b];
          ++histos[i].literal[g];
          ++histos[i].red[r];
          ++histos[i].alpha[a];
        }
      }
    } else {
      int code, extra_bits, extra_value;
      int len = v.len;
      uint32_t argb_prev = *argb ^ 0xffffffffu;
      PrefixEncode(len, &code, &extra_bits, &extra_value);
      for (int i = 0; i <= cache_bits_max; ++i)
        ++histos[i].literal[NUM_LITERAL_CODES + code];
      do {
        if (*argb != argb_prev) {
          uint32_t key = HashPix(*argb, 32 - cache_bits_max);
          for (int i = cache_bits_max; i >= 1; --i, key >>= 1)
            hashers[i].colors[key] = *argb;
          argb_prev = *argb;
        }
        argb++;
      } while (--len != 0);
    }
  }
  uint64_t entropy_min = UINT64_MAX;
  for (int i = 0; i <= cache_bits_max; ++i) {
    const uint64_t entropy = HistogramEstimateBits(&histos[i]);
    if (i == 0 || entropy < entropy_min) {
      entropy_min = entropy;
      *best_cache_bits = i;
    }
  }
}

void BackwardRefsWithLocalCache(const uint32_t* argb, int cache_bits,
                                Refs* refs) {
  int pixel_index = 0;
  ColorCache cache;
  cache.Init(cache_bits);
  for (PixOrCopy& v : *refs) {
    if (v.mode == 0) {
      const uint32_t lit = v.argb_or_distance;
      const int ix = cache.Contains(lit);
      if (ix >= 0) {
        v = CacheIdx(uint32_t(ix));
      } else {
        cache.Insert(lit);
      }
      ++pixel_index;
    } else {
      for (int k = 0; k < v.len; ++k) cache.Insert(argb[pixel_index++]);
    }
  }
}

void BackwardReferences2DLocality(int xsize, Refs* refs) {
  for (PixOrCopy& v : *refs)
    if (v.mode == 2)
      v.argb_or_distance = uint32_t(DistanceToPlaneCode(xsize, int(v.argb_or_distance)));
}

// GetBackwardReferences without the no-cache variant (do_no_cache is 0
// at method 4 below quality 75): the best LZ77 of lz77_types with its best
// cache size into *best.
void GetBackwardReferences(int width, int height, const uint32_t* argb,
                           int quality, int lz77_types_to_try,
                           int cache_bits_max, const HashChain& hash_chain,
                           Refs* best, int* cache_bits_best) {
  int lz77_type_best = 0;
  uint64_t bit_cost_best = UINT64_MAX;
  HashChain hash_chain_box;
  Refs refs_tmp;
  Histogram histo(MAX_COLOR_CACHE_BITS);
  for (int lz77_type = 1; lz77_types_to_try;
       lz77_types_to_try &= ~lz77_type, lz77_type <<= 1) {
    if ((lz77_types_to_try & lz77_type) == 0) continue;
    if (lz77_type == kLZ77RLE) {
      BackwardReferencesRle(width, height, argb, 0, &refs_tmp);
    } else if (lz77_type == kLZ77Standard) {
      BackwardReferencesLz77(width, height, argb, 0, hash_chain, &refs_tmp);
    } else {
      BackwardReferencesLz77Box(width, height, argb, 0, hash_chain,
                                &hash_chain_box, &refs_tmp);
    }
    int cache_bits = cache_bits_max;
    CalculateBestCacheSize(argb, quality, refs_tmp, &cache_bits);
    if (cache_bits > 0) BackwardRefsWithLocalCache(argb, cache_bits, &refs_tmp);
    HistogramCreate(&histo, refs_tmp, cache_bits);
    const uint64_t bit_cost = HistogramEstimateBits(&histo);
    if (bit_cost < bit_cost_best) {
      std::swap(refs_tmp, *best);
      bit_cost_best = bit_cost;
      lz77_type_best = lz77_type;
      *cache_bits_best = cache_bits;
    }
  }
  if ((lz77_type_best == kLZ77Standard || lz77_type_best == kLZ77Box) &&
      quality >= 25) {
    const HashChain& hc = (lz77_type_best == kLZ77Standard) ? hash_chain
                                                             : hash_chain_box;
    TraceBackwardsRefs(width, height, argb, *cache_bits_best, hc, *best,
                       &refs_tmp);
    HistogramCreate(&histo, refs_tmp, *cache_bits_best);
    const uint64_t bit_cost_trace = HistogramEstimateBits(&histo);
    if (bit_cost_trace < bit_cost_best) std::swap(refs_tmp, *best);
  }
  BackwardReferences2DLocality(width, best);
}

// ---------------------------------------------------------------------------
// Huffman codes (huffman_encode_utils.c)

struct HuffmanTreeCode {
  int num_symbols = 0;
  std::vector<uint8_t> code_lengths;
  std::vector<uint16_t> codes;
};

struct HuffmanTree {
  uint32_t total_count;
  int value;
  int pool_index_left;
  int pool_index_right;
};

struct HuffmanTreeToken {
  uint8_t code;
  uint8_t extra_bits;
};

bool ValuesShouldBeCollapsedToStrideAverage(int a, int b) {
  return std::abs(a - b) < 4;
}

void OptimizeHuffmanForRle(int length, uint8_t* good_for_rle, uint32_t* counts) {
  for (; length >= 0; --length) {
    if (length == 0) return;
    if (counts[length - 1] != 0) break;
  }
  {
    uint32_t symbol = counts[0];
    int stride = 0;
    for (int i = 0; i < length + 1; ++i) {
      if (i == length || counts[i] != symbol) {
        if ((symbol == 0 && stride >= 5) || (symbol != 0 && stride >= 7)) {
          for (int k = 0; k < stride; ++k) good_for_rle[i - k - 1] = 1;
        }
        stride = 1;
        if (i != length) symbol = counts[i];
      } else {
        ++stride;
      }
    }
  }
  {
    uint32_t stride = 0;
    uint32_t limit = counts[0];
    uint32_t sum = 0;
    for (int i = 0; i < length + 1; ++i) {
      if (i == length || good_for_rle[i] || (i != 0 && good_for_rle[i - 1]) ||
          !ValuesShouldBeCollapsedToStrideAverage(int(counts[i]), int(limit))) {
        if (stride >= 4 || (stride >= 3 && sum == 0)) {
          uint32_t count = (sum + stride / 2) / stride;
          if (count < 1) count = 1;
          if (sum == 0) count = 0;
          for (uint32_t k = 0; k < stride; ++k) counts[i - k - 1] = count;
        }
        stride = 0;
        sum = 0;
        if (i < length - 3) {
          limit = (counts[i] + counts[i + 1] + counts[i + 2] + counts[i + 3] + 2) / 4;
        } else if (i < length) {
          limit = counts[i];
        } else {
          limit = 0;
        }
      }
      ++stride;
      if (i != length) {
        sum += counts[i];
        if (stride >= 4) limit = (sum + stride / 2) / stride;
      }
    }
  }
}

bool CompareHuffmanTrees(const HuffmanTree& t1, const HuffmanTree& t2) {
  if (t1.total_count != t2.total_count) return t1.total_count > t2.total_count;
  return t1.value < t2.value;
}

void SetBitDepths(const HuffmanTree* tree, const HuffmanTree* pool,
                  uint8_t* bit_depths, int level) {
  if (tree->pool_index_left >= 0) {
    SetBitDepths(&pool[tree->pool_index_left], pool, bit_depths, level + 1);
    SetBitDepths(&pool[tree->pool_index_right], pool, bit_depths, level + 1);
  } else {
    bit_depths[tree->value] = uint8_t(level);
  }
}

void GenerateOptimalTree(const uint32_t* histogram, int histogram_size,
                         int tree_depth_limit, uint8_t* bit_depths) {
  int tree_size_orig = 0;
  for (int i = 0; i < histogram_size; ++i)
    if (histogram[i] != 0) ++tree_size_orig;
  if (tree_size_orig == 0) return;
  std::vector<HuffmanTree> mem(3 * size_t(tree_size_orig));
  HuffmanTree* tree = mem.data();
  HuffmanTree* tree_pool = tree + tree_size_orig;
  for (uint32_t count_min = 1;; count_min *= 2) {
    int tree_size = tree_size_orig;
    int idx = 0;
    for (int j = 0; j < histogram_size; ++j) {
      if (histogram[j] != 0) {
        const uint32_t count = (histogram[j] < count_min) ? count_min : histogram[j];
        tree[idx].total_count = count;
        tree[idx].value = j;
        tree[idx].pool_index_left = -1;
        tree[idx].pool_index_right = -1;
        ++idx;
      }
    }
    std::sort(tree, tree + tree_size, CompareHuffmanTrees);
    if (tree_size > 1) {
      int tree_pool_size = 0;
      while (tree_size > 1) {
        tree_pool[tree_pool_size++] = tree[tree_size - 1];
        tree_pool[tree_pool_size++] = tree[tree_size - 2];
        const uint32_t count = tree_pool[tree_pool_size - 1].total_count +
                               tree_pool[tree_pool_size - 2].total_count;
        tree_size -= 2;
        int k;
        for (k = 0; k < tree_size; ++k)
          if (tree[k].total_count <= count) break;
        std::memmove(tree + (k + 1), tree + k, (tree_size - k) * sizeof(*tree));
        tree[k].total_count = count;
        tree[k].value = -1;
        tree[k].pool_index_left = tree_pool_size - 1;
        tree[k].pool_index_right = tree_pool_size - 2;
        tree_size = tree_size + 1;
      }
      SetBitDepths(&tree[0], tree_pool, bit_depths, 0);
    } else if (tree_size == 1) {
      bit_depths[tree[0].value] = 1;
    }
    int max_depth = bit_depths[0];
    for (int j = 1; j < histogram_size; ++j)
      if (max_depth < bit_depths[j]) max_depth = bit_depths[j];
    if (max_depth <= tree_depth_limit) break;
  }
}

uint32_t ReverseBits(int num_bits, uint32_t bits) {
  uint32_t retval = 0;
  for (int i = 0; i < num_bits; ++i) {
    retval = (retval << 1) | (bits & 1);
    bits >>= 1;
  }
  return retval;
}

void ConvertBitDepthsToSymbols(HuffmanTreeCode* tree) {
  uint32_t next_code[16];
  int depth_count[16] = {0};
  for (int i = 0; i < tree->num_symbols; ++i) ++depth_count[tree->code_lengths[i]];
  depth_count[0] = 0;
  next_code[0] = 0;
  uint32_t code = 0;
  for (int i = 1; i <= 15; ++i) {
    code = (code + depth_count[i - 1]) << 1;
    next_code[i] = code;
  }
  for (int i = 0; i < tree->num_symbols; ++i) {
    const int len = tree->code_lengths[i];
    tree->codes[i] = uint16_t(ReverseBits(len, next_code[len]++));
  }
}

void CreateHuffmanTree(uint32_t* histogram, int tree_depth_limit,
                       HuffmanTreeCode* code) {
  std::vector<uint8_t> buf_rle(code->num_symbols, 0);
  OptimizeHuffmanForRle(code->num_symbols, buf_rle.data(), histogram);
  code->code_lengths.assign(code->num_symbols, 0);
  code->codes.assign(code->num_symbols, 0);
  GenerateOptimalTree(histogram, code->num_symbols, tree_depth_limit,
                      code->code_lengths.data());
  ConvertBitDepthsToSymbols(code);
}

// The five codes of a histogram (its counts are smoothed in place).
void GetHuffBitLengthsAndCodes(Histogram* h, HuffmanTreeCode codes[5]) {
  for (int k = 0; k < 5; ++k) {
    int length;
    h->Population(k, &length);
    codes[k].num_symbols = length;
    CreateHuffmanTree(h->Population(k), 15, &codes[k]);
  }
}

void CodeRepeatedValues(int repetitions, std::vector<HuffmanTreeToken>* tokens,
                        int value, int prev_value) {
  if (value != prev_value) {
    tokens->push_back({uint8_t(value), 0});
    --repetitions;
  }
  while (repetitions >= 1) {
    if (repetitions < 3) {
      for (int i = 0; i < repetitions; ++i) tokens->push_back({uint8_t(value), 0});
      break;
    } else if (repetitions < 7) {
      tokens->push_back({16, uint8_t(repetitions - 3)});
      break;
    } else {
      tokens->push_back({16, 3});
      repetitions -= 6;
    }
  }
}

void CodeRepeatedZeros(int repetitions, std::vector<HuffmanTreeToken>* tokens) {
  while (repetitions >= 1) {
    if (repetitions < 3) {
      for (int i = 0; i < repetitions; ++i) tokens->push_back({0, 0});
      break;
    } else if (repetitions < 11) {
      tokens->push_back({17, uint8_t(repetitions - 3)});
      break;
    } else if (repetitions < 139) {
      tokens->push_back({18, uint8_t(repetitions - 11)});
      break;
    } else {
      tokens->push_back({18, 0x7f});
      repetitions -= 138;
    }
  }
}

void CreateCompressedHuffmanTree(const HuffmanTreeCode& tree,
                                 std::vector<HuffmanTreeToken>* tokens) {
  tokens->clear();
  int prev_value = 8;
  int i = 0;
  while (i < tree.num_symbols) {
    const int value = tree.code_lengths[i];
    int k = i + 1;
    while (k < tree.num_symbols && tree.code_lengths[k] == value) ++k;
    const int runs = k - i;
    if (value == 0) {
      CodeRepeatedZeros(runs, tokens);
    } else {
      CodeRepeatedValues(runs, tokens, value, prev_value);
      prev_value = value;
    }
    i += runs;
  }
}

void ClearHuffmanTreeIfOnlyOneSymbol(HuffmanTreeCode* code) {
  int count = 0;
  for (int k = 0; k < code->num_symbols; ++k) {
    if (code->code_lengths[k] != 0) {
      ++count;
      if (count > 1) return;
    }
  }
  std::fill(code->code_lengths.begin(), code->code_lengths.end(), 0);
  std::fill(code->codes.begin(), code->codes.end(), 0);
}

void StoreFullHuffmanCode(BitWriter* bw, const HuffmanTreeCode& tree) {
  HuffmanTreeCode huffman_code;
  huffman_code.num_symbols = CODE_LENGTH_CODES;
  bw->Put(0, 1);
  std::vector<HuffmanTreeToken> tokens;
  CreateCompressedHuffmanTree(tree, &tokens);
  const int num_tokens = int(tokens.size());
  {
    uint32_t histogram[CODE_LENGTH_CODES] = {0};
    for (const HuffmanTreeToken& t : tokens) ++histogram[t.code];
    CreateHuffmanTree(histogram, 7, &huffman_code);
  }
  {
    int codes_to_store = CODE_LENGTH_CODES;
    for (; codes_to_store > 4; --codes_to_store)
      if (huffman_code.code_lengths[kCodeLengthOrder[codes_to_store - 1]] != 0)
        break;
    bw->Put(codes_to_store - 4, 4);
    for (int i = 0; i < codes_to_store; ++i)
      bw->Put(huffman_code.code_lengths[kCodeLengthOrder[i]], 3);
  }
  ClearHuffmanTreeIfOnlyOneSymbol(&huffman_code);
  int trailing_zero_bits = 0;
  int trimmed_length = num_tokens;
  int i = num_tokens;
  while (i-- > 0) {
    const int ix = tokens[i].code;
    if (ix == 0 || ix == 17 || ix == 18) {
      --trimmed_length;
      trailing_zero_bits += huffman_code.code_lengths[ix];
      if (ix == 17) {
        trailing_zero_bits += 3;
      } else if (ix == 18) {
        trailing_zero_bits += 7;
      }
    } else {
      break;
    }
  }
  const bool write_trimmed_length = (trimmed_length > 1 && trailing_zero_bits > 12);
  const int length = write_trimmed_length ? trimmed_length : num_tokens;
  bw->Put(write_trimmed_length, 1);
  if (write_trimmed_length) {
    if (trimmed_length == 2) {
      bw->Put(0, 3 + 2);
    } else {
      const int nbits = BitsLog2Floor(uint32_t(trimmed_length - 2));
      const int nbitpairs = nbits / 2 + 1;
      bw->Put(nbitpairs - 1, 3);
      bw->Put(trimmed_length - 2, nbitpairs * 2);
    }
  }
  for (int t = 0; t < length; ++t) {
    const int ix = tokens[t].code;
    bw->Put(huffman_code.codes[ix], huffman_code.code_lengths[ix]);
    if (ix == 16) bw->Put(tokens[t].extra_bits, 2);
    else if (ix == 17) bw->Put(tokens[t].extra_bits, 3);
    else if (ix == 18) bw->Put(tokens[t].extra_bits, 7);
  }
}

void StoreHuffmanCode(BitWriter* bw, const HuffmanTreeCode& code) {
  int count = 0;
  int symbols[2] = {0, 0};
  const int kMaxSymbol = 1 << 8;
  for (int i = 0; i < code.num_symbols && count < 3; ++i) {
    if (code.code_lengths[i] != 0) {
      if (count < 2) symbols[count] = i;
      ++count;
    }
  }
  if (count == 0) {
    bw->Put(0x01, 4);
  } else if (count <= 2 && symbols[0] < kMaxSymbol && symbols[1] < kMaxSymbol) {
    bw->Put(1, 1);
    bw->Put(count - 1, 1);
    if (symbols[0] <= 1) {
      bw->Put(0, 1);
      bw->Put(symbols[0], 1);
    } else {
      bw->Put(1, 1);
      bw->Put(symbols[0], 8);
    }
    if (count == 2) bw->Put(symbols[1], 8);
  } else {
    StoreFullHuffmanCode(bw, code);
  }
}

inline void WriteHuffmanCode(BitWriter* bw, const HuffmanTreeCode& code,
                             int index) {
  bw->Put(code.codes[index], code.code_lengths[index]);
}

void StoreImageToBitMask(BitWriter* bw, int width, int histo_bits,
                         const Refs& refs, const uint32_t* histogram_symbols,
                         const HuffmanTreeCode* huffman_codes) {
  const int histo_xsize = histo_bits ? SubSampleSize(width, histo_bits) : 1;
  const int tile_mask = (histo_bits == 0) ? 0 : -(1 << histo_bits);
  int x = 0, y = 0;
  int tile_x = x & tile_mask, tile_y = y & tile_mask;
  int histogram_ix = (histogram_symbols[0] >> 8) & 0xffff;
  const HuffmanTreeCode* codes = huffman_codes + 5 * histogram_ix;
  for (const PixOrCopy& v : refs) {
    if (tile_x != (x & tile_mask) || tile_y != (y & tile_mask)) {
      tile_x = x & tile_mask;
      tile_y = y & tile_mask;
      histogram_ix = (histogram_symbols[(y >> histo_bits) * histo_xsize +
                                        (x >> histo_bits)] >> 8) & 0xffff;
      codes = huffman_codes + 5 * histogram_ix;
    }
    if (v.mode == 0) {
      static const int order[] = {1, 2, 0, 3};
      for (int k = 0; k < 4; ++k) {
        const int code = (v.argb_or_distance >> (order[k] * 8)) & 0xff;
        WriteHuffmanCode(bw, codes[k], code);
      }
    } else if (v.mode == 1) {
      WriteHuffmanCode(bw, codes[0],
                       NUM_LITERAL_CODES + NUM_LENGTH_CODES + int(v.argb_or_distance));
    } else {
      int code, n_bits, bits;
      PrefixEncode(v.len, &code, &n_bits, &bits);
      WriteHuffmanCode(bw, codes[0], NUM_LITERAL_CODES + code);
      bw->Put(uint32_t(bits), n_bits);
      PrefixEncode(int(v.argb_or_distance), &code, &n_bits, &bits);
      WriteHuffmanCode(bw, codes[4], code);
      bw->Put(uint32_t(bits), n_bits);
    }
    x += v.len;
    while (x >= width) {
      x -= width;
      ++y;
    }
  }
}

// ---------------------------------------------------------------------------
// Image coding (vp8l_enc.c)

// A sub-image (palette, predictor modes, histogram map): one code set.
void EncodeImageNoHuffman(BitWriter* bw, const uint32_t* argb, int width,
                          int height, int quality) {
  HashChain hash_chain;
  HashChainFill(&hash_chain, quality, argb, width, height);
  Refs refs;
  int cache_bits = 0;
  GetBackwardReferences(width, height, argb, quality, kLZ77Standard | kLZ77RLE,
                        0, hash_chain, &refs, &cache_bits);
  Histogram h;
  HistogramCreate(&h, refs, 0);
  HuffmanTreeCode codes[5];
  GetHuffBitLengthsAndCodes(&h, codes);
  bw->Put(0, 1);   // no colour cache
  for (int k = 0; k < 5; ++k) {
    StoreHuffmanCode(bw, codes[k]);
    ClearHuffmanTreeIfOnlyOneSymbol(&codes[k]);
  }
  const uint32_t symbols[1] = {0};
  StoreImageToBitMask(bw, width, 0, refs, symbols, codes);
}

// VP8LOptimizeSampling: coarser tiles for a map whose tiles repeat in
// 2x2 groups.
void OptimizeSampling(uint32_t* image, int full_width, int full_height,
                      int bits, int max_bits, int* best_bits_out) {
  int width = SubSampleSize(full_width, bits);
  int height = SubSampleSize(full_height, bits);
  int best_bits = bits;
  *best_bits_out = bits;
  while (best_bits < max_bits) {
    const int new_square_size = 1 << (best_bits + 1 - bits);
    bool is_good = true;
    const int square_size = 1 << (best_bits - bits);
    for (int y = 0; y + square_size < height; y += new_square_size) {
      if (std::memcmp(&image[y * width], &image[(y + square_size) * width],
                      width * sizeof(*image)) != 0) {
        is_good = false;
        break;
      }
    }
    if (is_good) {
      ++best_bits;
    } else {
      break;
    }
  }
  if (best_bits == bits) return;
  while (best_bits > bits) {
    bool is_good = true;
    const int square_size = 1 << (best_bits - bits);
    for (int y = 0; is_good && y < height; ++y) {
      for (int x = 0; is_good && x < width; x += square_size) {
        for (int i = x + 1; i < std::min(x + square_size, width); ++i) {
          if (image[y * width + i] != image[y * width + x]) {
            is_good = false;
            break;
          }
        }
      }
    }
    if (is_good) break;
    --best_bits;
  }
  if (best_bits == bits) return;
  const int old_width = width;
  const int square_size = 1 << (best_bits - bits);
  width = SubSampleSize(full_width, best_bits);
  height = SubSampleSize(full_height, best_bits);
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x)
      image[y * width + x] = image[square_size * (y * old_width + x)];
  *best_bits_out = best_bits;
}

// EncodeImageInternal at method 4 below quality 75: for each LZ77 variant
// the whole coding, the smallest kept.
void EncodeImageInternal(BitWriter* bw, const uint32_t* argb, int width,
                         int height, int quality, int n_lz77s,
                         int cache_bits_in, int histogram_bits_in) {
  const int histo_xysize = SubSampleSize(width, histogram_bits_in) *
                           SubSampleSize(height, histogram_bits_in);
  HashChain hash_chain;
  HashChainFill(&hash_chain, quality, argb, width, height);
  const int cache_bits_init = (cache_bits_in == 0) ? MAX_COLOR_CACHE_BITS
                                                   : cache_bits_in;
  const BitWriter bw_init = *bw;
  BitWriter bw_best;
  size_t bw_size_best = SIZE_MAX;
  for (int sub = 0; sub < n_lz77s; ++sub) {
    const int lz77 = (sub == 0) ? (kLZ77Standard | kLZ77RLE) : kLZ77Box;
    Refs refs;
    int cache_bits = 0;
    GetBackwardReferences(width, height, argb, quality, lz77, cache_bits_init,
                          hash_chain, &refs, &cache_bits);
    *bw = bw_init;
    std::vector<Histogram> clusters;
    std::vector<uint32_t> histogram_argb;
    GetHistoImageSymbols(width, height, refs, quality, histogram_bits_in,
                         cache_bits, &clusters, &histogram_argb);
    const int histogram_image_size = int(clusters.size());
    std::vector<HuffmanTreeCode> codes(5 * size_t(histogram_image_size));
    for (int i = 0; i < histogram_image_size; ++i)
      GetHuffBitLengthsAndCodes(&clusters[i], &codes[5 * i]);
    if (cache_bits > 0) {
      bw->Put(1, 1);
      bw->Put(cache_bits, 4);
    } else {
      bw->Put(0, 1);
    }
    uint32_t max_symbol = 0;
    for (int i = 0; i < histo_xysize; ++i) {
      if (histogram_argb[i] >= max_symbol) max_symbol = histogram_argb[i] + 1;
      histogram_argb[i] <<= 8;
    }
    const bool write_histogram_image = max_symbol > 1;
    int histogram_bits = histogram_bits_in;
    bw->Put(write_histogram_image, 1);
    if (write_histogram_image) {
      OptimizeSampling(histogram_argb.data(), width, height, histogram_bits_in,
                       MAX_HUFFMAN_BITS, &histogram_bits);
      bw->Put(histogram_bits - 2, 3);
      EncodeImageNoHuffman(bw, histogram_argb.data(),
                           SubSampleSize(width, histogram_bits),
                           SubSampleSize(height, histogram_bits), quality);
    }
    for (int i = 0; i < 5 * int(max_symbol ? max_symbol : 1); ++i) {
      StoreHuffmanCode(bw, codes[i]);
      ClearHuffmanTreeIfOnlyOneSymbol(&codes[i]);
    }
    StoreImageToBitMask(bw, width, histogram_bits, refs, histogram_argb.data(),
                        codes.data());
    if (bw->NumBytes() < bw_size_best) {
      bw_size_best = bw->NumBytes();
      bw_best = *bw;
    }
  }
  *bw = bw_best;
}

// ---------------------------------------------------------------------------
// Transforms and the analysis

uint32_t PaletteComponentDistance(uint32_t v) { return (v <= 128) ? v : (256 - v); }

uint32_t PaletteColorDistance(uint32_t col1, uint32_t col2) {
  const uint32_t diff = SubPixels(col1, col2);
  uint32_t score = PaletteComponentDistance(diff & 0xff);
  score += PaletteComponentDistance((diff >> 8) & 0xff);
  score += PaletteComponentDistance((diff >> 16) & 0xff);
  score *= 9;
  score += PaletteComponentDistance((diff >> 24) & 0xff);
  return score;
}

// Whether the deltas of the palette (the first from 0) change sign in
// some channel: only then is it reordered.
bool PaletteHasNonMonotonousDeltas(const uint32_t* palette, int num_colors) {
  uint32_t predict = 0;
  uint8_t sign_found = 0;
  for (int i = 0; i < num_colors; ++i) {
    const uint32_t diff = SubPixels(palette[i], predict);
    const uint8_t rd = (diff >> 16) & 0xff, gd = (diff >> 8) & 0xff,
                  bd = diff & 0xff;
    if (rd != 0) sign_found |= (rd < 0x80) ? 1 : 2;
    if (gd != 0) sign_found |= (gd < 0x80) ? 8 : 16;
    if (bd != 0) sign_found |= (bd < 0x80) ? 64 : 128;
    predict = palette[i];
  }
  return (sign_found & (sign_found << 1)) != 0;
}

void PaletteSortMinimizeDeltas(const uint32_t* sorted, int num_colors,
                               uint32_t* palette) {
  std::memcpy(palette, sorted, num_colors * sizeof(*palette));
  if (!PaletteHasNonMonotonousDeltas(sorted, num_colors)) return;
  uint32_t predict = 0;
  for (int i = 0; i < num_colors; ++i) {
    int best_ix = i;
    uint32_t best_score = ~0u;
    for (int k = i; k < num_colors; ++k) {
      const uint32_t cur_score = PaletteColorDistance(palette[k], predict);
      if (best_score > cur_score) {
        best_score = cur_score;
        best_ix = k;
      }
    }
    std::swap(palette[best_ix], palette[i]);
    predict = palette[i];
  }
}

inline uint32_t AnalyzeHashPix(uint32_t pix) {
  return uint32_t(((uint64_t(pix) + (pix >> 19)) * 0x39c5fba7ull) & 0xffffffffu) >> 24;
}

EntropyIx AnalyzeEntropy(const uint32_t* argb, int width, int height,
                         int palette_size, int transform_bits) {
  if (palette_size <= 16) return kPalette;
  enum { kHistoAlpha, kHistoAlphaPred, kHistoGreen, kHistoGreenPred, kHistoRed,
         kHistoRedPred, kHistoBlue, kHistoBluePred, kHistoRedSubGreen,
         kHistoRedPredSubGreen, kHistoBlueSubGreen, kHistoBluePredSubGreen,
         kHistoPalette, kHistoTotal };
  std::vector<uint32_t> histo(kHistoTotal * 256, 0);
  auto add = [&](uint32_t p, int a, int r, int g, int b) {
    ++histo[a * 256 + (p >> 24)];
    ++histo[r * 256 + ((p >> 16) & 0xff)];
    ++histo[g * 256 + ((p >> 8) & 0xff)];
    ++histo[b * 256 + (p & 0xff)];
  };
  auto add_sub_green = [&](uint32_t p, int r, int b) {
    const int green = int(p >> 8);
    ++histo[r * 256 + ((int(p >> 16) - green) & 0xff)];
    ++histo[b * 256 + ((int(p) - green) & 0xff)];
  };
  const uint32_t* prev_row = nullptr;
  const uint32_t* curr_row = argb;
  uint32_t pix_prev = argb[0];
  for (int y = 0; y < height; ++y) {
    for (int x = 0; x < width; ++x) {
      const uint32_t pix = curr_row[x];
      const uint32_t pix_diff = SubPixels(pix, pix_prev);
      pix_prev = pix;
      if (pix_diff == 0 || (prev_row != nullptr && pix == prev_row[x])) continue;
      add(pix, kHistoAlpha, kHistoRed, kHistoGreen, kHistoBlue);
      add(pix_diff, kHistoAlphaPred, kHistoRedPred, kHistoGreenPred,
          kHistoBluePred);
      add_sub_green(pix, kHistoRedSubGreen, kHistoBlueSubGreen);
      add_sub_green(pix_diff, kHistoRedPredSubGreen, kHistoBluePredSubGreen);
      ++histo[kHistoPalette * 256 + AnalyzeHashPix(pix)];
    }
    prev_row = curr_row;
    curr_row += width;
  }
  ++histo[kHistoRedPredSubGreen * 256];
  ++histo[kHistoBluePredSubGreen * 256];
  ++histo[kHistoRedPred * 256];
  ++histo[kHistoGreenPred * 256];
  ++histo[kHistoBluePred * 256];
  ++histo[kHistoAlphaPred * 256];
  uint64_t ec[kHistoTotal];
  for (int j = 0; j < kHistoTotal; ++j) ec[j] = BitsEntropy(&histo[j * 256], 256);
  uint64_t entropy[5];
  entropy[kDirect] = ec[kHistoAlpha] + ec[kHistoRed] + ec[kHistoGreen] + ec[kHistoBlue];
  entropy[kSpatial] = ec[kHistoAlphaPred] + ec[kHistoRedPred] + ec[kHistoGreenPred] +
                      ec[kHistoBluePred];
  entropy[kSubGreen] = ec[kHistoAlpha] + ec[kHistoRedSubGreen] + ec[kHistoGreen] +
                       ec[kHistoBlueSubGreen];
  entropy[kSpatialSubGreen] = ec[kHistoAlphaPred] + ec[kHistoRedPredSubGreen] +
                              ec[kHistoGreenPred] + ec[kHistoBluePredSubGreen];
  entropy[kPalette] = ec[kHistoPalette];
  const uint64_t tiles = uint64_t(SubSampleSize(width, transform_bits)) *
                         SubSampleSize(height, transform_bits);
  entropy[kSpatial] += tiles * FastLog2(14);
  entropy[kSpatialSubGreen] += tiles * FastLog2(24);
  entropy[kPalette] += (uint64_t(palette_size) * 8) << LOG_2_PRECISION_BITS;
  int min_ix = kDirect;
  for (int k = kDirect + 1; k <= kPalette; ++k)
    if (entropy[min_ix] > entropy[k]) min_ix = k;
  return EntropyIx(min_ix);
}

// The predictor transform (predictor_enc.c) with exact coding and no
// near-lossless quantisation: per tile the best of the 14 modes.

constexpr int64_t kSpatialPredictorBias = int64_t(15) << LOG_2_PRECISION_BITS;

int64_t PredictionCostBias(const uint32_t* counts, uint64_t weight_0,
                           uint64_t exp_val) {
  const int significant_symbols = 256 >> 4;
  const uint64_t exp_decay_factor = 6;
  uint64_t bits = (weight_0 * counts[0]) << LOG_2_PRECISION_BITS;
  exp_val <<= LOG_2_PRECISION_BITS;
  for (int i = 1; i < significant_symbols; ++i) {
    bits += uint64_t(DivRound(int64_t(exp_val * (counts[i] + counts[256 - i])), 100));
    exp_val = uint64_t(DivRound(int64_t(exp_decay_factor * exp_val), 10));
  }
  return -DivRound(int64_t(bits), 10);
}

uint64_t CombinedShannonEntropy(const uint32_t* X, const uint32_t* Y) {
  uint64_t retval = 0;
  uint32_t sumX = 0, sumXY = 0;
  for (int i = 0; i < 256; ++i) {
    const uint32_t x = X[i];
    if (x != 0) {
      const uint32_t xy = x + Y[i];
      sumX += x;
      retval += FastSLog2(x);
      sumXY += xy;
      retval += FastSLog2(xy);
    } else if (Y[i] != 0) {
      sumXY += Y[i];
      retval += FastSLog2(Y[i]);
    }
  }
  return FastSLog2(sumX) + FastSLog2(sumXY) - retval;
}

int64_t PredictionCostSpatialHistogram(const uint32_t* accumulated,
                                       const uint32_t* tile) {
  int64_t retval = 0;
  for (int i = 0; i < 4; ++i) {
    retval += PredictionCostBias(&tile[i * 256], 1, 94);
    retval += int64_t(CombinedShannonEntropy(&tile[i * 256], &accumulated[i * 256]));
  }
  return retval;
}

inline uint32_t PredictPixel(int mode, const uint32_t* current,
                             const uint32_t* upper, int x, int y) {
  if (x == 0) return y == 0 ? 0xff000000u : upper[0];
  if (y == 0) return current[x - 1];
  return Predict(mode, current[x - 1], upper[x], upper[x + 1], upper[x - 1]);
}

void UpdateHisto(uint32_t* histo, uint32_t argb) {
  ++histo[0 * 256 + (argb >> 24)];
  ++histo[1 * 256 + ((argb >> 16) & 0xff)];
  ++histo[2 * 256 + ((argb >> 8) & 0xff)];
  ++histo[3 * 256 + (argb & 0xff)];
}

// The residual of pixel (x, y) under mode; the row above reads one past
// the end, which is the first pixel of row y (libwebp's wrap).
inline uint32_t Residual(const uint32_t* argb, int width, int mode, int x,
                         int y) {
  const uint32_t* current = argb + size_t(y) * width;
  const uint32_t* upper = y > 0 ? current - width : nullptr;
  return SubPixels(current[x], PredictPixel(mode, current, upper, x, y));
}

int GetBestPredictorForTile(int width, int height, int tile_x, int tile_y,
                            int bits, uint32_t* accumulated,
                            const uint32_t* argb, const uint32_t* modes) {
  const int kNumPredModes = 14;
  const int start_x = tile_x << bits;
  const int start_y = tile_y << bits;
  const int tile_size = 1 << bits;
  const int max_y = std::min(tile_size, height - start_y);
  const int max_x = std::min(tile_size, width - start_x);
  const int tiles_per_row = SubSampleSize(width, bits);
  const int left_mode = (tile_x > 0)
      ? int((modes[tile_y * tiles_per_row + tile_x - 1] >> 8) & 0xff) : 0xff;
  const int above_mode = (tile_y > 0)
      ? int((modes[(tile_y - 1) * tiles_per_row + tile_x] >> 8) & 0xff) : 0xff;
  int64_t best_diff = INT64_MAX;
  int best_mode = 0;
  std::vector<uint32_t> histo(4 * 256), best_histo(4 * 256);
  for (int mode = 0; mode < kNumPredModes; ++mode) {
    std::fill(histo.begin(), histo.end(), 0);
    for (int ry = 0; ry < max_y; ++ry)
      for (int rx = 0; rx < max_x; ++rx)
        UpdateHisto(histo.data(),
                    Residual(argb, width, mode, start_x + rx, start_y + ry));
    int64_t cur_diff = PredictionCostSpatialHistogram(accumulated, histo.data());
    if (mode == left_mode) cur_diff -= kSpatialPredictorBias;
    if (mode == above_mode) cur_diff -= kSpatialPredictorBias;
    if (cur_diff < best_diff) {
      std::swap(histo, best_histo);
      best_diff = cur_diff;
      best_mode = mode;
    }
  }
  for (int i = 0; i < 4 * 256; ++i) accumulated[i] += best_histo[i];
  return best_mode;
}

int ClampBits(int width, int height, int bits, int min_bits, int max_bits,
              int image_size_max) {
  bits = (bits < min_bits) ? min_bits : (bits > max_bits) ? max_bits : bits;
  int image_size = SubSampleSize(width, bits) * SubSampleSize(height, bits);
  while (bits < max_bits && image_size > image_size_max) {
    ++bits;
    image_size = SubSampleSize(width, bits) * SubSampleSize(height, bits);
  }
  while (bits > min_bits && image_size == 1) {
    image_size = SubSampleSize(width, bits - 1) * SubSampleSize(height, bits - 1);
    if (image_size != 1) break;
    --bits;
  }
  return bits;
}

// ApplyPredictFilter: writes the transform, returns the residual image.
std::vector<uint32_t> ApplyPredictFilter(BitWriter* bw, const uint32_t* argb,
                                         int width, int height, int quality,
                                         int transform_bits) {
  const int bits = ClampBits(width, height, transform_bits, MIN_TRANSFORM_BITS,
                             MAX_TRANSFORM_BITS, MAX_PREDICTOR_IMAGE_SIZE);
  const int tiles_per_row = SubSampleSize(width, bits);
  const int tiles_per_col = SubSampleSize(height, bits);
  std::vector<uint32_t> modes(size_t(tiles_per_row) * tiles_per_col, 0);
  std::vector<uint32_t> accumulated(4 * 256, 0);
  for (int ty = 0; ty < tiles_per_col; ++ty)
    for (int tx = 0; tx < tiles_per_row; ++tx) {
      const int pred = GetBestPredictorForTile(width, height, tx, ty, bits,
                                               accumulated.data(), argb,
                                               modes.data());
      modes[ty * tiles_per_row + tx] = 0xff000000u | (uint32_t(pred) << 8);
    }
  std::vector<uint32_t> residuals(size_t(width) * height);
  for (int y = 0; y < height; ++y)
    for (int x = 0; x < width; ++x) {
      const int mode = int((modes[(y >> bits) * tiles_per_row + (x >> bits)] >> 8) & 0xff);
      residuals[size_t(y) * width + x] = Residual(argb, width, mode, x, y);
    }
  int best_bits = bits;
  OptimizeSampling(modes.data(), width, height, bits, MAX_TRANSFORM_BITS,
                   &best_bits);
  bw->Put(1, 1);
  bw->Put(0, 2);    // PREDICTOR_TRANSFORM
  bw->Put(best_bits - MIN_TRANSFORM_BITS, 3);
  EncodeImageNoHuffman(bw, modes.data(), SubSampleSize(width, best_bits),
                       SubSampleSize(height, best_bits), quality);
  return residuals;
}

// VP8LEncodeStream for the green-only picture of EncodeLossless.
std::vector<uint8_t> EncodeLosslessGreen(const uint8_t* alpha, int width,
                                         int height) {
  const int method = 4;
  const int quality = 8 * method;
  const size_t n = size_t(width) * height;
  std::vector<uint32_t> argb(n);
  for (size_t i = 0; i < n; ++i) argb[i] = uint32_t(alpha[i]) << 8;

  // The palette: the colours sorted (GetColorPalette); alpha has 256 or
  // fewer, so the palette is always possible.
  std::vector<uint32_t> sorted;
  {
    bool seen[256] = {false};
    for (size_t i = 0; i < n; ++i) seen[alpha[i]] = true;
    for (int v = 0; v < 256; ++v)
      if (seen[v]) sorted.push_back(uint32_t(v) << 8);
  }
  const int palette_size = int(sorted.size());
  const int histo_bits = ClampBits(width, height, 9 - method, MIN_HUFFMAN_BITS,
                                   MAX_HUFFMAN_BITS, MAX_HUFF_IMAGE_SIZE);
  const int transform_bits = std::min(histo_bits, 5);
  const int n_lz77s = (palette_size <= 16) ? 2 : 1;
  const EntropyIx entropy_ix =
      AnalyzeEntropy(argb.data(), width, height, palette_size, transform_bits);

  BitWriter bw;
  std::vector<uint32_t> image;
  int current_width = width;
  int cache_bits = 0;
  if (entropy_ix == kPalette) {
    std::vector<uint32_t> palette(palette_size);
    PaletteSortMinimizeDeltas(sorted.data(), palette_size, palette.data());
    bw.Put(1, 1);
    bw.Put(3, 2);    // COLOR_INDEXING_TRANSFORM
    bw.Put(palette_size - 1, 8);
    std::vector<uint32_t> delta(palette_size);
    for (int i = palette_size - 1; i >= 1; --i)
      delta[i] = SubPixels(palette[i], palette[i - 1]);
    delta[0] = palette[0];
    EncodeImageNoHuffman(&bw, delta.data(), palette_size, 1, 20);
    int xbits;
    if (palette_size <= 4) {
      xbits = (palette_size <= 2) ? 3 : 2;
    } else {
      xbits = (palette_size <= 16) ? 1 : 0;
    }
    uint8_t index_of[256] = {0};
    for (int i = 0; i < palette_size; ++i) index_of[(palette[i] >> 8) & 0xff] = uint8_t(i);
    current_width = SubSampleSize(width, xbits);
    image.assign(size_t(current_width) * height, 0);
    const int bit_depth = 1 << (3 - xbits);
    const int mask = (1 << xbits) - 1;
    for (int y = 0; y < height; ++y) {
      uint32_t* dst = &image[size_t(y) * current_width];
      uint32_t code = 0xff000000u;
      for (int x = 0; x < width; ++x) {
        const uint32_t idx = index_of[alpha[size_t(y) * width + x]];
        if (xbits > 0) {
          const int xsub = x & mask;
          if (xsub == 0) code = 0xff000000u;
          code |= idx << (8 + bit_depth * xsub);
          dst[x >> xbits] = code;
        } else {
          dst[x] = 0xff000000u | (idx << 8);
        }
      }
    }
    if (palette_size < (1 << MAX_COLOR_CACHE_BITS))
      cache_bits = BitsLog2Floor(uint32_t(palette_size)) + 1;
  } else if (entropy_ix == kSpatial) {
    image = ApplyPredictFilter(&bw, argb.data(), width, height, quality,
                               transform_bits);
  } else if (entropy_ix == kDirect) {
    image = argb;
  } else {
    return {};        // a subtract-green mode: not written
  }
  bw.Put(0, 1);   // no more transforms
  EncodeImageInternal(&bw, image.data(), current_width, height, quality,
                      n_lz77s, cache_bits, histo_bits);
  return bw.Finish();
}

// The encoder-side filters of filters.c.
void FilterPlane(const uint8_t* in, int width, int height, int filter,
                 uint8_t* out) {
  for (int y = 0; y < height; ++y) {
    const uint8_t* row = in + size_t(y) * width;
    const uint8_t* prev = y > 0 ? row - width : nullptr;
    uint8_t* o = out + size_t(y) * width;
    for (int x = 0; x < width; ++x) {
      int pred;
      if (y == 0) {
        pred = x == 0 ? 0 : row[x - 1];
      } else if (x == 0) {
        pred = prev[0];
      } else if (filter == 1) {
        pred = row[x - 1];
      } else if (filter == 2) {
        pred = prev[x];
      } else {
        const int g = row[x - 1] + prev[x] - prev[x - 1];
        pred = (g & ~0xff) == 0 ? g : (g < 0) ? 0 : 255;
      }
      o[x] = uint8_t(row[x] - pred);
    }
  }
}

int EstimateBestFilter(const uint8_t* data, int width, int height) {
  constexpr int SMAX = 16;
  int bins[4][SMAX];
  std::memset(bins, 0, sizeof(bins));
  auto sdiff = [](int a, int b) { return std::abs(a - b) >> 4; };
  for (int j = 2; j < height - 1; j += 2) {
    const uint8_t* p = data + size_t(j) * width;
    int mean = p[0];
    for (int i = 2; i < width - 1; i += 2) {
      const int diff0 = sdiff(p[i], mean);
      const int diff1 = sdiff(p[i], p[i - 1]);
      const int diff2 = sdiff(p[i], p[i - width]);
      const int g = p[i - 1] + p[i - width] - p[i - width - 1];
      const int grad_pred = (g & ~0xff) == 0 ? g : (g < 0) ? 0 : 255;
      const int diff3 = sdiff(p[i], grad_pred);
      bins[0][diff0] = 1;
      bins[1][diff1] = 1;
      bins[2][diff2] = 1;
      bins[3][diff3] = 1;
      mean = (3 * mean + p[i] + 2) >> 2;
    }
  }
  int best_filter = 0;
  int best_score = 0x7fffffff;
  for (int filter = 0; filter < 4; ++filter) {
    int score = 0;
    for (int i = 0; i < SMAX; ++i)
      if (bins[filter][i] > 0) score += i;
    if (score < best_score) {
      best_score = score;
      best_filter = filter;
    }
  }
  return best_filter;
}

// EncodeAlphaInternal for one filter: the header byte and the stream, or
// the raw (filtered) plane where the stream is larger.
std::vector<uint8_t> EncodeAlphaTrial(const uint8_t* alpha, int width,
                                      int height, int filter) {
  const size_t data_size = size_t(width) * height;
  std::vector<uint8_t> filtered;
  const uint8_t* src = alpha;
  if (filter != 0) {
    filtered.resize(data_size);
    FilterPlane(alpha, width, height, filter, filtered.data());
    src = filtered.data();
  }
  std::vector<uint8_t> stream = EncodeLosslessGreen(src, width, height);
  if (stream.empty()) return {};
  int method = 1;
  if (stream.size() > data_size) {
    method = 0;
    stream.assign(src, src + data_size);
  }
  std::vector<uint8_t> out;
  out.reserve(1 + stream.size());
  out.push_back(uint8_t(method | (filter << 2)));
  out.insert(out.end(), stream.begin(), stream.end());
  return out;
}

std::vector<uint8_t> EncodeAlpha(const uint8_t* alpha, int width, int height) {
  bool seen[256] = {false};
  int num_colors = 0;
  for (size_t i = 0; i < size_t(width) * height; ++i) {
    if (!seen[alpha[i]]) {
      seen[alpha[i]] = true;
      ++num_colors;
    }
  }
  uint32_t try_map;
  if (num_colors <= 16) {
    try_map = 1;
  } else {
    try_map = (1u << EstimateBestFilter(alpha, width, height)) | 1u;
  }
  if (try_map == 1) return EncodeAlphaTrial(alpha, width, height, 0);
  std::vector<uint8_t> best;
  for (int filter = 0; try_map; ++filter, try_map >>= 1) {
    if (!(try_map & 1)) continue;
    std::vector<uint8_t> trial = EncodeAlphaTrial(alpha, width, height, filter);
    if (trial.empty()) return {};
    if (best.empty() || trial.size() < best.size()) best.swap(trial);
  }
  return best;
}

int64_t CopyOut(const std::vector<uint8_t>& data, uint8_t* out, int64_t cap) {
  if (data.empty()) return -3;
  const int64_t n = int64_t(data.size());
  if (n > cap) return -n;
  std::memcpy(out, data.data(), data.size());
  return n;
}

}  // namespace

extern "C" {

int64_t tb_webp_alpha_encode(const uint8_t* alpha, int64_t w, int64_t h,
                             uint8_t* out, int64_t cap) {
  if (w < 1 || h < 1 || w > 16383 || h > 16383) return -1;
  return CopyOut(EncodeAlpha(alpha, int(w), int(h)), out, cap);
}

int64_t tb_vp8l_encode_green(const uint8_t* alpha, int64_t w, int64_t h,
                             uint8_t* out, int64_t cap) {
  if (w < 1 || h < 1 || w > 16383 || h > 16383) return -1;
  return CopyOut(EncodeLosslessGreen(alpha, int(w), int(h)), out, cap);
}

}  // extern "C"
