// The tile coder of the port's JPEG 2000 writer (core/image_save.py writes
// the marker segments and the JP2 boxes; loaded by core/codecs.py). Host
// code, compiled with g++ at first use into the port's build directory
// (utils/build.py) and called through ctypes.
//
// It repeats what OpenJPEG 2.5.4 writes for PIL's Image.save at PIL's
// defaults: one tile, the reversible 5/3 wavelet, no component transform,
// 64x64 code-blocks of style 0, precincts of 2^15 (one a resolution), one
// quality layer holding every coding pass, LRCP, no SOP or EPH. The
// codestream is lossless, so the wavelet and tier 1 are those of T.800;
// what is OpenJPEG's own is where T.800 leaves the encoder a choice:
// - the DC level shift (- 128), then per level the vertical lifting of
//   every column, then the horizontal of every row (dwt.c
//   opj_dwt_encode_procedure);
// - tier 1 (t1.c opj_t1_encode_cblk): every bit-plane from the highest
//   non-zero one, the cleanup pass first; the MQ coder (mqc.c) starts with
//   A = 0x8000, C = 0, CT = 12 and a fake byte 0 before the buffer, and
//   only the last pass is terminated, by opj_mqc_flush (SETBITS, two
//   BYTEOUTs, the last byte dropped where it is 0xFF), so a code-block is
//   one codeword segment of all its passes;
// - tier 2 (t2.c opj_t2_encode_packet): a packet a resolution and
//   component in LRCP order; the non-empty bit, then per band (empty bands
//   skipped) the inclusion tag tree at threshold 1 (a code-block with no
//   pass stays out), the zero bit-planes tag tree (against the band's
//   Mb: QCD's exponent 8 + gain, plus 2 guard bits, less 1), the number
//   of passes, the Lblock increment as a comma code and the length;
//   bio.c's bit writer stuffs a 0 bit after each 0xFF byte and flushes
//   with one more byte after a final 0xFF. OpenJPEG sets the
//   non-empty bit whether or not a code-block is included.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

#include "j2k_mq.inc"

// mqc.c's encoder. buf[0] is the fake byte before the code-block's data.
struct MqEnc {
  std::vector<uint8_t> buf;
  size_t bp = 0;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t idx[19], mps[19];

  void init() {
    buf.assign(64, 0);
    bp = 0;
    a = 0x8000;
    c = 0;
    ct = 12;
    std::memset(idx, 0, sizeof idx);
    std::memset(mps, 0, sizeof mps);
    idx[kCtxUni] = 46;
    idx[kCtxAgg] = 3;
    idx[0] = 4;
  }
  void put(uint8_t v) {
    if (++bp >= buf.size()) buf.resize(buf.size() * 2);
    buf[bp] = v;
  }
  void byteout() {
    if (buf[bp] == 0xFF) {
      put(uint8_t(c >> 20));
      c &= 0xFFFFF;
      ct = 7;
    } else if ((c & 0x8000000) == 0) {
      put(uint8_t(c >> 19));
      c &= 0x7FFFF;
      ct = 8;
    } else {
      ++buf[bp];
      if (buf[bp] == 0xFF) {
        c &= 0x7FFFFFF;
        put(uint8_t(c >> 20));
        c &= 0xFFFFF;
        ct = 7;
      } else {
        put(uint8_t(c >> 19));
        c &= 0x7FFFF;
        ct = 8;
      }
    }
  }
  void renorm() {
    do {
      a <<= 1;
      c <<= 1;
      if (--ct == 0) byteout();
    } while ((a & 0x8000) == 0);
  }
  void encode(int cx, int d) {
    const QeState& s = kQe[idx[cx]];
    a -= s.qe;
    if (mps[cx] == d) {
      if ((a & 0x8000) == 0) {
        if (a < s.qe) a = s.qe;
        else c += s.qe;
        idx[cx] = s.nmps;
        renorm();
      } else {
        c += s.qe;
      }
    } else {
      if (a < s.qe) c += s.qe;
      else a = s.qe;
      if (s.sw) mps[cx] ^= 1;
      idx[cx] = s.nlps;
      renorm();
    }
  }
  // opj_mqc_flush; returns the number of bytes (opj_mqc_numbytes).
  size_t flush() {
    uint32_t tempc = c + a;
    c |= 0xFFFF;
    if (c >= tempc) c -= 0x8000;
    c <<= ct;
    byteout();
    c <<= ct;
    byteout();
    if (buf[bp] != 0xFF) ++bp;
    return bp - 1;
  }
};

// Tier 1 of one code-block: the decoder's T1 with each decision coded.
struct T1Enc {
  int w = 0, h = 0, stride = 0;
  std::vector<uint8_t> sig, visited, refined, neg;   // (h + 2) x (w + 2)
  std::vector<uint32_t> mag;                          // h x w
  MqEnc mq;
  int orient = 0;

  void reset(int w_, int h_) {
    w = w_;
    h = h_;
    stride = w + 2;
    size_t n = size_t(h + 2) * stride;
    sig.assign(n, 0);
    visited.assign(n, 0);
    refined.assign(n, 0);
    neg.assign(n, 0);
    mag.assign(size_t(w) * h, 0);
  }
  int at(int x, int y) const { return (y + 1) * stride + x + 1; }

  int zc_ctx(int i) const {
    int hh = sig[i - 1] + sig[i + 1];
    int vv = sig[i - stride] + sig[i + stride];
    int dd = sig[i - stride - 1] + sig[i - stride + 1] +
             sig[i + stride - 1] + sig[i + stride + 1];
    if (orient == 3) {
      int hv = hh + vv;
      if (dd == 0) return hv == 0 ? 0 : hv == 1 ? 1 : 2;
      if (dd == 1) return hv == 0 ? 3 : hv == 1 ? 4 : 5;
      if (dd == 2) return hv == 0 ? 6 : 7;
      return 8;
    }
    if (orient == 1) std::swap(hh, vv);
    if (hh == 0) {
      if (vv == 0) return dd == 0 ? 0 : dd == 1 ? 1 : 2;
      return vv == 1 ? 3 : 4;
    }
    if (hh == 1) {
      if (vv == 0) return dd == 0 ? 5 : 6;
      return 7;
    }
    return 8;
  }
  int contrib(int j) const { return sig[j] ? (neg[j] ? -1 : 1) : 0; }
  void encode_sign(int i) {
    int hc = std::min(1, std::max(-1, contrib(i - 1) + contrib(i + 1)));
    int vc = std::min(1, std::max(-1, contrib(i - stride) +
                                          contrib(i + stride)));
    int xorbit = 0;
    if (hc < 0) {
      hc = -hc;
      vc = -vc;
      xorbit = 1;
    } else if (hc == 0 && vc < 0) {
      vc = -vc;
      xorbit = 1;
    }
    int ctx = hc == 1 ? kCtxSc + (vc == 1 ? 4 : vc == 0 ? 3 : 2)
                      : kCtxSc + (vc == 1 ? 1 : 0);
    mq.encode(ctx, neg[i] ^ xorbit);
    sig[i] = 1;
  }
  bool any_sig_neighbour(int i) const {
    return sig[i - 1] | sig[i + 1] | sig[i - stride] | sig[i - stride - 1] |
           sig[i - stride + 1] | sig[i + stride] | sig[i + stride - 1] |
           sig[i + stride + 1];
  }
  int bit(int x, int y, int bpno) const {
    return (mag[size_t(y) * w + x] >> bpno) & 1;
  }

  void sigpass(int bpno) {
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          int i = at(x, y);
          if (sig[i] || !any_sig_neighbour(i)) continue;
          int v = bit(x, y, bpno);
          mq.encode(zc_ctx(i), v);
          if (v) encode_sign(i);
          visited[i] = 1;
        }
  }
  void refpass(int bpno) {
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          int i = at(x, y);
          if (!sig[i] || visited[i]) continue;
          int ctx = refined[i] ? kCtxMag + 2
                               : (any_sig_neighbour(i) ? kCtxMag + 1 : kCtxMag);
          mq.encode(ctx, bit(x, y, bpno));
          refined[i] = 1;
        }
  }
  void clnpass(int bpno) {
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x) {
        int y0 = k;
        if (k + 4 <= h) {
          bool run = true;
          for (int y = k; y < k + 4 && run; ++y) {
            int i = at(x, y);
            run = !sig[i] && !visited[i] && !any_sig_neighbour(i);
          }
          if (run) {
            int r = 0;
            while (r < 4 && !bit(x, k + r, bpno)) ++r;
            if (r == 4) {
              mq.encode(kCtxAgg, 0);
              continue;
            }
            mq.encode(kCtxAgg, 1);
            mq.encode(kCtxUni, r >> 1);
            mq.encode(kCtxUni, r & 1);
            encode_sign(at(x, k + r));
            y0 = k + r + 1;
          }
        }
        for (int y = y0; y < std::min(k + 4, h); ++y) {
          int i = at(x, y);
          if (sig[i] || visited[i]) continue;
          int v = bit(x, y, bpno);
          mq.encode(zc_ctx(i), v);
          if (v) encode_sign(i);
        }
        for (int y = k; y < std::min(k + 4, h); ++y) visited[at(x, y)] = 0;
      }
  }
};

int floorlog2(uint32_t v) {
  int l = -1;
  while (v) {
    v >>= 1;
    ++l;
  }
  return l;
}

// The forward 5/3 lifting on n samples spaced by `step` (dwt.c
// opj_dwt_encode_1 for an even start): the lows to the front, the highs
// after them.
void fdwt53(int32_t* x, int n, int64_t step, std::vector<int32_t>& tmp) {
  if (n < 2) return;
  int sn = (n + 1) / 2, dn = n / 2;
  tmp.resize(n);
  for (int i = 0; i < n; ++i) tmp[i] = x[int64_t(i) * step];
  auto s = [&](int i) { return tmp[2 * std::min(std::max(i, 0), sn - 1)]; };
  for (int i = 0; i < dn; ++i)
    tmp[2 * i + 1] -= (s(i) + s(i + 1)) >> 1;
  auto d = [&](int i) { return tmp[2 * std::min(std::max(i, 0), dn - 1) + 1]; };
  for (int i = 0; i < sn; ++i)
    tmp[2 * i] += (d(i - 1) + d(i) + 2) >> 2;
  for (int i = 0; i < sn; ++i) x[int64_t(i) * step] = tmp[2 * i];
  for (int i = 0; i < dn; ++i) x[int64_t(sn + i) * step] = tmp[2 * i + 1];
}

struct TagTree {
  struct Node {
    int parent, value, low;
    bool known;
  };
  std::vector<Node> nodes;

  void build(int w, int h) {
    nodes.clear();
    std::vector<int> lw, lh, off;
    int n, total = 0;
    do {
      lw.push_back(w);
      lh.push_back(h);
      off.push_back(total);
      n = w * h;
      total += n;
      w = (w + 1) / 2;
      h = (h + 1) / 2;
    } while (n > 1);
    nodes.assign(total, Node{-1, 999, 0, false});
    for (size_t l = 0; l + 1 < lw.size(); ++l)
      for (int y = 0; y < lh[l]; ++y)
        for (int x = 0; x < lw[l]; ++x)
          nodes[off[l] + y * lw[l] + x].parent =
              off[l + 1] + (y / 2) * lw[l + 1] + x / 2;
  }
  void setvalue(int leaf, int v) {
    for (int n = leaf; n >= 0 && nodes[n].value > v; n = nodes[n].parent)
      nodes[n].value = v;
  }
};

struct BioEnc {
  std::vector<uint8_t>* out;
  uint32_t buf = 0;
  int ct = 8;
  void byteout() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    out->push_back(uint8_t(buf >> 8));
  }
  void putbit(uint32_t b) {
    if (ct == 0) byteout();
    --ct;
    buf |= b << ct;
  }
  void write(uint32_t v, int n) {
    for (int i = n - 1; i >= 0; --i) putbit((v >> i) & 1);
  }
  void flush() {
    byteout();
    if (ct == 7) byteout();
  }
};

void tgt_encode(BioEnc& bio, TagTree& t, int leaf, int threshold) {
  int stk[64], sp = 0, node = leaf;
  while (t.nodes[node].parent >= 0) {
    stk[sp++] = node;
    node = t.nodes[node].parent;
  }
  int low = 0;
  for (;;) {
    TagTree::Node& nd = t.nodes[node];
    if (low > nd.low) nd.low = low;
    else low = nd.low;
    while (low < threshold) {
      if (low >= nd.value) {
        if (!nd.known) {
          bio.write(1, 1);
          nd.known = true;
        }
        break;
      }
      bio.write(0, 1);
      ++low;
    }
    nd.low = low;
    if (sp == 0) break;
    node = stk[--sp];
  }
}

void put_numpasses(BioEnc& bio, int n) {
  if (n == 1) bio.write(0, 1);
  else if (n == 2) bio.write(2, 2);
  else if (n <= 5) bio.write(0xC | (n - 3), 4);
  else if (n <= 36) bio.write(0x1E0 | (n - 6), 9);
  else bio.write(0xFF80 | (n - 37), 16);
}

struct Cblk {
  int numbps = 0, passes = 0;
  std::vector<uint8_t> data;
};

struct Band {
  int x0, y0, w, h, orient, mb;      // in the component's wavelet plane
  int cw = 0, ch = 0;
  std::vector<Cblk> cblks;
};

}  // namespace

// Codes the packets of one tile of an (h, w, nc) uint8 image: every
// component DC-shifted, transformed over numres - 1 levels and coded as
// above. Writes the packets (the tile-part's body after SOD) into `out`
// and returns its length, or -1 where it holds fewer than `cap` bytes.
extern "C" int64_t tb_j2k_encode_tile(const uint8_t* img, int64_t h,
                                      int64_t w, int64_t nc, int64_t numres,
                                      uint8_t* out, int64_t cap) {
  const int levels = int(numres) - 1;
  std::vector<std::vector<Band>> res_bands(numres * nc);
  std::vector<int32_t> plane(size_t(h) * w), tmp;
  T1Enc t1;
  for (int64_t c = 0; c < nc; ++c) {
    for (int64_t i = 0; i < h * w; ++i)
      plane[i] = int32_t(img[i * nc + c]) - 128;
    int64_t rw = w, rh = h;
    for (int l = 0; l < levels; ++l) {
      for (int64_t x = 0; x < rw; ++x) fdwt53(&plane[x], int(rh), w, tmp);
      for (int64_t y = 0; y < rh; ++y) fdwt53(&plane[y * w], int(rw), 1, tmp);
      rw = (rw + 1) / 2;
      rh = (rh + 1) / 2;
    }
    // Bands of each resolution: rw x rh the LL of the coarsest level.
    for (int r = 0; r <= levels; ++r) {
      auto& bands = res_bands[r * nc + c];
      int shift = levels - r;
      int cw_ = int((w + (int64_t(1) << shift) - 1) >> shift);
      int chh = int((h + (int64_t(1) << shift) - 1) >> shift);
      if (r == 0) {
        bands.push_back(Band{0, 0, cw_, chh, 0, 8 + 2 - 1});
      } else {
        int lw_ = (cw_ + 1) / 2, lh_ = (chh + 1) / 2;
        bands.push_back(Band{lw_, 0, cw_ - lw_, lh_, 1, 9 + 2 - 1});
        bands.push_back(Band{0, lh_, lw_, chh - lh_, 2, 9 + 2 - 1});
        bands.push_back(Band{lw_, lh_, cw_ - lw_, chh - lh_, 3, 10 + 2 - 1});
      }
      for (auto& b : bands) {
        if (b.w <= 0 || b.h <= 0) continue;
        b.cw = (b.w + 63) / 64;
        b.ch = (b.h + 63) / 64;
        b.cblks.resize(size_t(b.cw) * b.ch);
        for (int by = 0; by < b.ch; ++by)
          for (int bx = 0; bx < b.cw; ++bx) {
            Cblk& cb = b.cblks[size_t(by) * b.cw + bx];
            int x0 = bx * 64, y0 = by * 64;
            int cw = std::min(64, b.w - x0), chh2 = std::min(64, b.h - y0);
            t1.reset(cw, chh2);
            t1.orient = b.orient;
            uint32_t mx = 0;
            for (int y = 0; y < chh2; ++y)
              for (int x = 0; x < cw; ++x) {
                int32_t v = plane[size_t(b.y0 + y0 + y) * w + b.x0 + x0 + x];
                uint32_t m = uint32_t(v < 0 ? -v : v);
                t1.mag[size_t(y) * cw + x] = m;
                t1.neg[t1.at(x, y)] = v < 0;
                mx = std::max(mx, m);
              }
            cb.numbps = mx ? floorlog2(mx) + 1 : 0;
            if (!cb.numbps) continue;
            t1.mq.init();
            for (int bp = cb.numbps - 1; bp >= 0; --bp) {
              if (bp != cb.numbps - 1) {
                t1.sigpass(bp);
                t1.refpass(bp);
              }
              t1.clnpass(bp);
            }
            cb.passes = 3 * cb.numbps - 2;
            size_t n = t1.mq.flush();
            cb.data.assign(t1.mq.buf.begin() + 1, t1.mq.buf.begin() + 1 + n);
          }
      }
    }
  }
  // Tier 2: one layer, LRCP.
  std::vector<uint8_t> body;
  for (int r = 0; r <= levels; ++r)
    for (int64_t c = 0; c < nc; ++c) {
      auto& bands = res_bands[r * nc + c];
      std::vector<uint8_t> head;
      BioEnc bio{&head};
      bio.write(1, 1);
      for (auto& b : bands) {
        if (b.cblks.empty()) continue;
        TagTree incl, imsb;
        incl.build(b.cw, b.ch);
        imsb.build(b.cw, b.ch);
        for (size_t k = 0; k < b.cblks.size(); ++k) {
          imsb.setvalue(int(k), b.mb - b.cblks[k].numbps);
          if (b.cblks[k].passes) incl.setvalue(int(k), 0);
        }
        for (size_t k = 0; k < b.cblks.size(); ++k) {
          Cblk& cb = b.cblks[k];
          tgt_encode(bio, incl, int(k), 1);
          if (!cb.passes) continue;
          tgt_encode(bio, imsb, int(k), 999);
          put_numpasses(bio, cb.passes);
          int len = int(cb.data.size());
          int nump_bits = floorlog2(uint32_t(cb.passes));
          int inc = std::max(0, floorlog2(uint32_t(len)) + 1 - (3 + nump_bits));
          for (int i = 0; i < inc; ++i) bio.write(1, 1);
          bio.write(0, 1);
          bio.write(uint32_t(len), 3 + inc + nump_bits);
        }
      }
      bio.flush();
      body.insert(body.end(), head.begin(), head.end());
      for (auto& b : bands)
        for (auto& cb : b.cblks)
          body.insert(body.end(), cb.data.begin(), cb.data.end());
    }
  if (int64_t(body.size()) > cap) return -1;
  std::memcpy(out, body.data(), body.size());
  return int64_t(body.size());
}
