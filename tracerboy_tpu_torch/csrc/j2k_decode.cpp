// The byte- and bit-serial work of the port's JPEG 2000 reader
// (core/jpeg2000.py): one tile of a codestream from its packets to the
// samples of each component. Host code, compiled with g++ at first use into
// the port's build directory (utils/build.py, with -ffp-contract=off so that
// no multiply-add is fused) and called through ctypes; the JP2 boxes and the
// codestream's marker segments are parsed in Python, which passes each tile's
// coding parameters in an int64 block (layout in tb_j2k_decode_tile) and
// the bodies of its tile-parts, concatenated.
//
// The reader must give the pixels PIL gives, and PIL reads JPEG 2000 through
// OpenJPEG (2.5), tile by tile (opj_read_tile_header, opj_decode_tile_data),
// all layers, no reduction. Each step follows OpenJPEG where ITU-T T.800
// leaves a choice or OpenJPEG departs from it:
// - tier 2: packets in the order of OpenJPEG's packet iterator (pi.c): for
//   the position-driven orders the reference grid is walked in steps of the
//   smallest precinct, a precinct visited at the first position of
//   B.12.1.3-5's test; with POC markers every progression starts at layer
//   0 and a packet already read is skipped. Precincts and code-blocks are
//   laid out as tcd.c lays them out: a precinct is clipped to its band and
//   holds every code-block its clipped extent touches, so an empty precinct
//   away from the code-block grid holds one empty code-block whose
//   inclusion is coded all the same. Empty bands carry no bits. Bits past
//   the end of a packet header read as 0; a code-block segment longer than
//   what is left of the tile is an error (OpenJPEG's strict mode). SOP
//   and EPH markers are skipped where present and ignored where absent;
//   packet headers come from PPM or PPT data where the codestream has it.
// - tier 1: the MQ decoder with two 0xFF bytes appended to each
//   segment's data; every code-block style but HT (bypass: raw sig and
//   ref passes from the fifth bit-plane, a raw bit after an 0xFF kept to
//   7 bits; contexts reset after each MQ pass; a segment a pass; samples
//   of a stripe's last row blind to the next stripe; four uniform
//   decisions after each cleanup pass, not checked; predictable
//   termination not checked); coefficients kept at twice their magnitude with
//   the half of the last decoded bit-plane added (1.5 * 2^p on
//   significance, +-2^(p-1) on refinement), then halved toward zero for
//   the 5/3 wavelet or multiplied by 0.5f * step for the 9/7; the step is
//   (1 + mant / 2048) * 2^(prec - expn) in double, rounded to float, with
//   no band gain (OpenJPEG's "two_invK" compensation). An ROI shift s adds
//   s bit-planes, then scales every magnitude >= 2^s down by 2^s.
// - the inverse 5/3 in integers; a single odd sample is halved toward
//   zero (C division), a single even one kept.
// - the inverse 9/7 as float32 lifting, rows then columns at each level:
//   low samples times K = 1.230174105f, high ones times 2/K =
//   1.625732422f, then the four steps x[i] += (l + r) * c with OpenJPEG's
//   c = -0.443506852f, -0.882911075f, 0.052980118f, 1.586134342f (T.800's
//   -delta, -gamma, -beta, -alpha; the sum first, no fused multiply-add), and
//   x[i] += l * (2c) where the right neighbour is missing. A line of one
//   sample is left as it is (neither scaled nor halved).
// - the RCT on the integer samples and the ICT in float32 (y + 1.402f v,
//   y - 0.34413f u - 0.71414f v, y + 1.772f u), chosen by component 0's
//   wavelet and applied to the bits of components 0-2 whatever their own
//   wavelet; a tile with fewer than three components skips it.
// - the DC level shift with a clamp to the component's range, 9/7
//   samples first rounded to nearest even by lrintf (above INT_MAX the
//   maximum, below INT_MIN the minimum).
//
// Each entry point returns 0 on success and a negative code on error
// (ERRORS in core/jpeg2000.py names them).

#include <algorithm>
#include <cmath>
#include <climits>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

enum Err {
  kBadParams = -1,
  kBadProgression = -2,
  kSegmentTooLong = -3,
  kBadBitNumber = -4,
  kTooManyBitplanes = -5,
  kBadPrecinct = -6,
  kMctSizes = -7,
  kZeroBitplanes = -8,
};

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }
int64_t ceil_div_pow2(int64_t a, int b) {
  return (a + (int64_t(1) << b) - 1) >> b;   // arithmetic: ceil for a < 0
}
int64_t floor_div_pow2(int64_t a, int b) { return a >> b; }

// ---------------------------------------------------------------------------
// MQ decoder (T.800 C.3, OpenJPEG's mqc.c)

#include "j2k_mq.inc"

struct Mq {
  const uint8_t* bp = nullptr;
  uint32_t a = 0, c = 0;
  int ct = 0;
  uint8_t idx[19], mps[19];

  void reset_states() {
    std::memset(idx, 0, sizeof idx);
    std::memset(mps, 0, sizeof mps);
    idx[kCtxUni] = 46;
    idx[kCtxAgg] = 3;
    idx[0] = 4;
  }
  void bytein() {
    if (bp[0] == 0xFF) {
      if (bp[1] > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += uint32_t(bp[0]) << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += uint32_t(bp[0]) << 8;
      ct = 8;
    }
  }
  // `data` holds len bytes followed by 0xFF 0xFF.
  void init(const uint8_t* data, int64_t len) {
    bp = data;
    c = len == 0 ? 0xFFu << 16 : uint32_t(data[0]) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  int decode(int cx) {
    const QeState& s = kQe[idx[cx]];
    int d;
    a -= s.qe;
    if ((c >> 16) < s.qe) {
      if (a < s.qe) {
        d = mps[cx];
        idx[cx] = s.nmps;
      } else {
        d = 1 - mps[cx];
        if (s.sw) mps[cx] ^= 1;
        idx[cx] = s.nlps;
      }
      a = s.qe;
      renorm();
    } else {
      c -= uint32_t(s.qe) << 16;
      if ((a & 0x8000) == 0) {
        if (a < s.qe) {
          d = 1 - mps[cx];
          if (s.sw) mps[cx] ^= 1;
          idx[cx] = s.nlps;
        } else {
          d = mps[cx];
          idx[cx] = s.nmps;
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
};

// ---------------------------------------------------------------------------
// Tier 1 (T.800 annex D), one code-block.

struct T1 {
  int w = 0, h = 0, stride = 0;
  std::vector<uint8_t> sig, visited, refined, neg;   // (h + 2) x (w + 2)
  std::vector<int32_t> data;                          // h x w
  Mq mq;
  int orient = 0;
  bool vsc = false;   // vertically causal: a stripe does not see the next
  bool raw = false;   // this segment's passes are raw (bypass mode)
  // The raw bit reader (opj_mqc_raw_decode).
  const uint8_t* rbp = nullptr;
  uint32_t rc = 0;
  int rct = 0;

  void reset(int w_, int h_) {
    w = w_;
    h = h_;
    stride = w + 2;
    size_t n = size_t(h + 2) * stride;
    sig.assign(n, 0);
    visited.assign(n, 0);
    refined.assign(n, 0);
    neg.assign(n, 0);
    data.assign(size_t(w) * h, 0);
  }
  int at(int x, int y) const { return (y + 1) * stride + x + 1; }
  // Significance of the row below sample row y (hidden across a stripe's
  // lower edge in vertically causal mode).
  int below(int j, int y) const {
    return vsc && (y & 3) == 3 ? 0 : sig[j];
  }

  int zc_ctx(int i, int y) const {
    int s = i + stride;
    int hh = sig[i - 1] + sig[i + 1];
    int vv = sig[i - stride] + below(s, y);
    int dd = sig[i - stride - 1] + sig[i - stride + 1] + below(s - 1, y) +
             below(s + 1, y);
    if (orient == 3) {
      int hv = hh + vv;
      if (dd == 0) return hv == 0 ? 0 : hv == 1 ? 1 : 2;
      if (dd == 1) return hv == 0 ? 3 : hv == 1 ? 4 : 5;
      if (dd == 2) return hv == 0 ? 6 : 7;
      return 8;
    }
    if (orient == 1) std::swap(hh, vv);   // HL: vertical neighbours lead
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
  // Sign context and the bit XORed with the decision (table D.3).
  void sc_ctx(int i, int y, int* ctx, int* xorbit) const {
    int s = i + stride;
    int hc = std::min(1, std::max(-1, contrib(i - 1) + contrib(i + 1)));
    int vc = std::min(1, std::max(-1, contrib(i - stride) +
                                          (below(s, y) ? contrib(s) : 0)));
    if (hc < 0) {
      hc = -hc;
      vc = -vc;
      *xorbit = 1;
    } else if (hc == 0 && vc < 0) {
      vc = -vc;
      *xorbit = 1;
    } else {
      *xorbit = 0;
    }
    // (hc, vc) now in (1,1) (1,0) (1,-1) (0,1) (0,0)
    if (hc == 1) *ctx = kCtxSc + (vc == 1 ? 4 : vc == 0 ? 3 : 2);
    else *ctx = kCtxSc + (vc == 1 ? 1 : 0);
  }
  bool any_sig_neighbour(int i, int y) const {
    int s = i + stride;
    return sig[i - 1] | sig[i + 1] | sig[i - stride] | sig[i - stride - 1] |
           sig[i - stride + 1] | below(s, y) | below(s - 1, y) |
           below(s + 1, y);
  }
  void set_sig(int x, int y, int i, int v, int32_t oneplushalf) {
    data[size_t(y) * w + x] = v ? -oneplushalf : oneplushalf;
    neg[i] = uint8_t(v);
    sig[i] = 1;
  }
  void decode_sign(int x, int y, int i, int32_t oneplushalf) {
    int ctx, xorbit;
    sc_ctx(i, y, &ctx, &xorbit);
    set_sig(x, y, i, mq.decode(ctx) ^ xorbit, oneplushalf);
  }
  void raw_init(const uint8_t* p) {
    rbp = p;
    rc = 0;
    rct = 0;
  }
  int raw_bit() {
    if (rct == 0) {
      if (rc == 0xFF) {
        if (rbp[0] > 0x8F) {
          rc = 0xFF;
          rct = 8;
        } else {
          rc = *rbp++;
          rct = 7;
        }
      } else {
        rc = *rbp++;
        rct = 8;
      }
    }
    --rct;
    return (rc >> rct) & 1;
  }

  void sigpass(int bpno) {
    int32_t one = int32_t(1) << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          int i = at(x, y);
          if (sig[i] || visited[i] || !any_sig_neighbour(i, y)) continue;
          if (raw) {
            if (raw_bit()) set_sig(x, y, i, raw_bit(), oneplushalf);
          } else if (mq.decode(zc_ctx(i, y))) {
            decode_sign(x, y, i, oneplushalf);
          }
          visited[i] = 1;
        }
  }
  void refpass(int bpno) {
    int32_t poshalf = (int32_t(1) << bpno) >> 1;
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x)
        for (int y = k; y < std::min(k + 4, h); ++y) {
          int i = at(x, y);
          if (!sig[i] || visited[i]) continue;
          int v;
          if (raw) {
            v = raw_bit();
          } else {
            int ctx = refined[i] ? kCtxMag + 2
                                 : (any_sig_neighbour(i, y) ? kCtxMag + 1
                                                            : kCtxMag);
            v = mq.decode(ctx);
          }
          int32_t& d = data[size_t(y) * w + x];
          d += (v ^ (d < 0)) ? poshalf : -poshalf;
          refined[i] = 1;
        }
  }
  void clnpass(int bpno, bool segsym) {
    int32_t one = int32_t(1) << bpno, oneplushalf = one | (one >> 1);
    for (int k = 0; k < h; k += 4)
      for (int x = 0; x < w; ++x) {
        int y0 = k;
        if (k + 4 <= h) {
          bool run = true;
          for (int y = k; y < k + 4 && run; ++y) {
            int i = at(x, y);
            run = !sig[i] && !visited[i] && !any_sig_neighbour(i, y);
          }
          if (run) {
            if (!mq.decode(kCtxAgg)) {
              for (int y = k; y < k + 4; ++y) visited[at(x, y)] = 0;
              continue;
            }
            int r = mq.decode(kCtxUni) << 1;
            r |= mq.decode(kCtxUni);
            decode_sign(x, k + r, at(x, k + r), oneplushalf);
            y0 = k + r + 1;
          }
        }
        for (int y = y0; y < std::min(k + 4, h); ++y) {
          int i = at(x, y);
          if (sig[i] || visited[i]) continue;
          if (mq.decode(zc_ctx(i, y))) decode_sign(x, y, i, oneplushalf);
        }
        for (int y = k; y < std::min(k + 4, h); ++y) visited[at(x, y)] = 0;
      }
    if (segsym)
      for (int n = 0; n < 4; ++n) mq.decode(kCtxUni);
  }
};

// ---------------------------------------------------------------------------
// Tier 2 structures (OpenJPEG's tcd.c layout)

struct TagTree {
  struct Node {
    int parent;
    int value, low;
  };
  std::vector<Node> nodes;

  void build(int w, int h) {
    nodes.clear();
    if (w <= 0 || h <= 0) return;
    std::vector<int> lw, lh, off;
    int n;
    int total = 0;
    do {
      lw.push_back(w);
      lh.push_back(h);
      off.push_back(total);
      n = w * h;
      total += n;
      w = (w + 1) / 2;
      h = (h + 1) / 2;
    } while (n > 1);
    nodes.assign(total, Node{-1, 999, 0});
    for (size_t l = 0; l + 1 < lw.size(); ++l)
      for (int y = 0; y < lh[l]; ++y)
        for (int x = 0; x < lw[l]; ++x)
          nodes[off[l] + y * lw[l] + x].parent =
              off[l + 1] + (y / 2) * lw[l + 1] + x / 2;
  }
  void reset() {
    for (auto& nd : nodes) {
      nd.value = 999;
      nd.low = 0;
    }
  }
};

struct Bio {
  const uint8_t* start;
  const uint8_t* bp;
  const uint8_t* end;
  uint32_t buf = 0;
  int ct = 0;
  Bio(const uint8_t* p, int64_t len) : start(p), bp(p), end(p + len) {}
  void bytein() {
    buf = (buf << 8) & 0xFFFF;
    ct = buf == 0xFF00 ? 7 : 8;
    if (bp < end) buf |= *bp++;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(int n) {
    uint32_t v = 0;
    for (int i = n - 1; i >= 0; --i) v |= bit() << i;
    return v;
  }
  void inalign() {
    if ((buf & 0xFF) == 0xFF) bytein();
    ct = 0;
  }
  int64_t numbytes() const { return bp - start; }
};

int tgt_decode(Bio& bio, TagTree& t, int leaf, int threshold) {
  int stk[64];
  int sp = 0;
  int node = leaf;
  while (t.nodes[node].parent >= 0) {
    stk[sp++] = node;
    node = t.nodes[node].parent;
  }
  int low = 0;
  for (;;) {
    TagTree::Node& nd = t.nodes[node];
    if (low > nd.low) nd.low = low;
    else low = nd.low;
    while (low < threshold && low < nd.value) {
      if (bio.read(1)) nd.value = low;
      else ++low;
    }
    nd.low = low;
    if (sp == 0) break;
    node = stk[--sp];
  }
  return t.nodes[node].value < threshold ? 1 : 0;
}

struct Seg {
  int64_t len = 0;
  int numpasses = 0, maxpasses = 0, numnewpasses = 0;
  int64_t newlen = 0;
};

struct Cblk {
  int64_t x0, y0, x1, y1;
  int numbps = 0, numlenbits = 0, numnewpasses = 0;
  std::vector<Seg> segs;
  int numsegs = 0;
  std::vector<uint8_t> data;
};

struct Prec {
  int64_t x0, y0, x1, y1;
  int cw = 0, ch = 0;
  TagTree incl, imsb;
  std::vector<Cblk> cblks;
};

struct Band {
  int bandno = 0;
  int64_t x0, y0, x1, y1;
  int numbps = 0;
  float stepsize = 0;
  std::vector<Prec> precs;
  bool empty() const { return x0 == x1 || y0 == y1; }
};

struct Res {
  int64_t x0, y0, x1, y1;
  int pdx, pdy;
  int64_t pw, ph;
  int numbands;
  Band bands[3];
};

struct Comp {
  int64_t dx, dy, prec, sgnd;
  int numres, cblkw, cblkh, cblksty, qmfbid, qntsty, numgbits, roishift;
  int64_t x0, y0, x1, y1;
  std::vector<Res> res;
  std::vector<uint32_t> data;   // int32 or float32 bits, as OpenJPEG's tile
};

struct Poc {
  int64_t resno0, compno0, layno1, resno1, compno1, prg;
};

struct Packet {
  int layno, resno, compno, precno;
};

bool init_seg(Cblk& cb, int index, int cblksty, bool first) {
  if (int(cb.segs.size()) <= index) cb.segs.resize(index + 1);
  Seg& s = cb.segs[index];
  s = Seg();
  if (cblksty & 0x04) {
    s.maxpasses = 1;
  } else if (cblksty & 0x01) {
    s.maxpasses = first ? 10
                        : ((cb.segs[index - 1].maxpasses == 1 ||
                            cb.segs[index - 1].maxpasses == 10) ? 2 : 1);
  } else {
    s.maxpasses = 109;
  }
  return true;
}

int floorlog2(uint32_t a) {
  int l = 0;
  while (a > 1) {
    a >>= 1;
    ++l;
  }
  return l;
}

uint32_t getnumpasses(Bio& bio) {
  if (!bio.read(1)) return 1;
  if (!bio.read(1)) return 2;
  uint32_t n = bio.read(2);
  if (n != 3) return 3 + n;
  n = bio.read(5);
  if (n != 31) return 6 + n;
  return 37 + bio.read(7);
}

// ---------------------------------------------------------------------------
// The tile

struct Tile {
  int64_t tx0, ty0, tx1, ty1;
  int numcomps, prg, numlayers, mct, csty;
  std::vector<Poc> pocs;
  std::vector<Comp> comps;

  bool parse(const int64_t* p, int64_t np);
  void layout();
  bool packet_order(std::vector<Packet>& out);
};

bool Tile::parse(const int64_t* p, int64_t np) {
  int64_t k = 0;
  auto take = [&](int64_t& v) {
    if (k >= np) return false;
    v = p[k++];
    return true;
  };
  int64_t v;
  if (!take(v)) return false;
  numcomps = int(v);
  if (numcomps < 1 || numcomps > 16384) return false;
  if (!take(tx0) || !take(ty0) || !take(tx1) || !take(ty1)) return false;
  if (!take(v)) return false;
  prg = int(v);
  if (!take(v)) return false;
  numlayers = int(v);
  if (!take(v)) return false;
  mct = int(v);
  if (!take(v)) return false;
  csty = int(v);
  if (!take(v)) return false;
  int npocs = int(v);
  if (npocs < 0 || npocs > 32) return false;
  pocs.resize(npocs);
  for (auto& q : pocs)
    if (!take(q.resno0) || !take(q.compno0) || !take(q.layno1) ||
        !take(q.resno1) || !take(q.compno1) || !take(q.prg))
      return false;
  comps.resize(numcomps);
  for (auto& c : comps) {
    int64_t f[12];
    for (auto& x : f)
      if (!take(x)) return false;
    c.dx = f[0];
    c.dy = f[1];
    c.prec = f[2];
    c.sgnd = f[3];
    c.numres = int(f[4]);
    c.cblkw = int(f[5]);
    c.cblkh = int(f[6]);
    c.cblksty = int(f[7]);
    c.qmfbid = int(f[8]);
    c.qntsty = int(f[9]);
    c.numgbits = int(f[10]);
    c.roishift = int(f[11]);
    if (c.dx < 1 || c.dy < 1 || c.prec < 1 || c.prec > 31 || c.numres < 1 ||
        c.numres > 33)
      return false;
    c.res.resize(c.numres);
    for (auto& r : c.res) {
      int64_t a, b;
      if (!take(a) || !take(b)) return false;
      r.pdx = int(a);
      r.pdy = int(b);
    }
    int nbands = 3 * (c.numres - 1) + 1;
    // (expn, mant) of each band, in the order of the QCD: LL, then HL, LH,
    // HH of each resolution.
    std::vector<int64_t> steps(2 * nbands);
    for (auto& s : steps)
      if (!take(s)) return false;
    for (int r = 0; r < c.numres; ++r) {
      Res& rr = c.res[r];
      rr.numbands = r == 0 ? 1 : 3;
      for (int b = 0; b < rr.numbands; ++b) {
        int idx = r == 0 ? 0 : 3 * (r - 1) + b + 1;
        int64_t expn = steps[2 * idx], mant = steps[2 * idx + 1];
        Band& band = rr.bands[b];
        band.bandno = r == 0 ? 0 : b + 1;
        band.stepsize = float((1.0 + double(mant) / 2048.0) *
                              std::pow(2.0, double(int(c.prec - expn))));
        band.numbps = int(expn) + c.numgbits - 1;
      }
    }
  }
  return k == np;
}

void Tile::layout() {
  for (auto& c : comps) {
    c.x0 = ceil_div(tx0, c.dx);
    c.y0 = ceil_div(ty0, c.dy);
    c.x1 = ceil_div(tx1, c.dx);
    c.y1 = ceil_div(ty1, c.dy);
    c.data.assign(size_t(c.x1 - c.x0) * size_t(c.y1 - c.y0), 0);
    for (int r = 0; r < c.numres; ++r) {
      Res& res = c.res[r];
      int level = c.numres - 1 - r;
      res.x0 = ceil_div_pow2(c.x0, level);
      res.y0 = ceil_div_pow2(c.y0, level);
      res.x1 = ceil_div_pow2(c.x1, level);
      res.y1 = ceil_div_pow2(c.y1, level);
      int pdx = res.pdx, pdy = res.pdy;
      int64_t tlx = floor_div_pow2(res.x0, pdx) << pdx;
      int64_t tly = floor_div_pow2(res.y0, pdy) << pdy;
      int64_t brx = ceil_div_pow2(res.x1, pdx) << pdx;
      int64_t bry = ceil_div_pow2(res.y1, pdy) << pdy;
      res.pw = res.x0 == res.x1 ? 0 : (brx - tlx) >> pdx;
      res.ph = res.y0 == res.y1 ? 0 : (bry - tly) >> pdy;
      int64_t cbgx, cbgy;
      int cbgw, cbgh;
      if (r == 0) {
        cbgx = tlx;
        cbgy = tly;
        cbgw = pdx;
        cbgh = pdy;
      } else {
        cbgx = ceil_div_pow2(tlx, 1);
        cbgy = ceil_div_pow2(tly, 1);
        cbgw = pdx - 1;
        cbgh = pdy - 1;
      }
      int cbw = std::min(c.cblkw, cbgw), cbh = std::min(c.cblkh, cbgh);
      for (int b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.bandno == 0) {
          band.x0 = ceil_div_pow2(c.x0, level);
          band.y0 = ceil_div_pow2(c.y0, level);
          band.x1 = ceil_div_pow2(c.x1, level);
          band.y1 = ceil_div_pow2(c.y1, level);
        } else {
          int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
          band.x0 = ceil_div_pow2(c.x0 - (xob << level), level + 1);
          band.y0 = ceil_div_pow2(c.y0 - (yob << level), level + 1);
          band.x1 = ceil_div_pow2(c.x1 - (xob << level), level + 1);
          band.y1 = ceil_div_pow2(c.y1 - (yob << level), level + 1);
        }
        band.precs.clear();
        if (band.empty()) continue;
        band.precs.resize(size_t(res.pw * res.ph));
        for (int64_t pn = 0; pn < res.pw * res.ph; ++pn) {
          Prec& pr = band.precs[pn];
          int64_t sx = cbgx + (pn % res.pw) * (int64_t(1) << cbgw);
          int64_t sy = cbgy + (pn / res.pw) * (int64_t(1) << cbgh);
          pr.x0 = std::max(sx, band.x0);
          pr.y0 = std::max(sy, band.y0);
          pr.x1 = std::min(sx + (int64_t(1) << cbgw), band.x1);
          pr.y1 = std::min(sy + (int64_t(1) << cbgh), band.y1);
          int64_t tcx = floor_div_pow2(pr.x0, cbw) << cbw;
          int64_t tcy = floor_div_pow2(pr.y0, cbh) << cbh;
          int64_t bcx = ceil_div_pow2(pr.x1, cbw) << cbw;
          int64_t bcy = ceil_div_pow2(pr.y1, cbh) << cbh;
          pr.cw = int(std::max<int64_t>(0, (bcx - tcx) >> cbw));
          pr.ch = int(std::max<int64_t>(0, (bcy - tcy) >> cbh));
          pr.incl.build(pr.cw, pr.ch);
          pr.imsb.build(pr.cw, pr.ch);
          pr.cblks.resize(size_t(pr.cw) * pr.ch);
          for (int cb = 0; cb < pr.cw * pr.ch; ++cb) {
            Cblk& blk = pr.cblks[cb];
            int64_t bx = tcx + (cb % pr.cw) * (int64_t(1) << cbw);
            int64_t by = tcy + (cb / pr.cw) * (int64_t(1) << cbh);
            blk.x0 = std::max(bx, pr.x0);
            blk.y0 = std::max(by, pr.y0);
            blk.x1 = std::min(bx + (int64_t(1) << cbw), pr.x1);
            blk.y1 = std::min(by + (int64_t(1) << cbh), pr.y1);
          }
        }
      }
    }
  }
}

// OpenJPEG's packet iterator (opj_pi_next_lrcp ... _cprl) for a whole tile.
bool Tile::packet_order(std::vector<Packet>& out) {
  int64_t max_res = 0, max_prec = 0;
  for (auto& c : comps) {
    max_res = std::max<int64_t>(max_res, c.numres);
    for (auto& r : c.res) max_prec = std::max(max_prec, r.pw * r.ph);
  }
  int64_t step_c = max_prec, step_r = numcomps * step_c,
          step_l = max_res * step_r;
  std::vector<uint8_t> include(size_t(numlayers) * step_l, 0);
  std::vector<Poc> order = pocs;
  if (order.empty())
    order.push_back(Poc{0, 0, numlayers, max_res, numcomps, prg});
  auto emit = [&](int l, int r, int c, int64_t p) {
    int64_t index = l * step_l + r * step_r + c * step_c + p;
    if (index < 0 || index >= int64_t(include.size())) return false;
    if (!include[index]) {
      include[index] = 1;
      out.push_back(Packet{l, r, c, int(p)});
    }
    return true;
  };
  // Test of B.12.1.3 at position (x, y) for component c, resolution r;
  // the precinct's index or -1.
  auto position = [&](const Comp& comp, int r, int64_t x, int64_t y) -> int64_t {
    const Res& res = comp.res[r];
    int levelno = comp.numres - 1 - r;
    if (levelno >= 32) return -1;
    int64_t cdx = comp.dx << levelno, cdy = comp.dy << levelno;
    int64_t trx0 = ceil_div(tx0, cdx), try0 = ceil_div(ty0, cdy);
    int64_t trx1 = ceil_div(tx1, cdx), try1 = ceil_div(ty1, cdy);
    int rpx = res.pdx + levelno, rpy = res.pdy + levelno;
    if (rpx >= 31 || rpy >= 31) return -1;
    if (!((y % (comp.dy << rpy)) == 0 ||
          (y == ty0 && ((try0 << levelno) % (int64_t(1) << rpy)))))
      return -1;
    if (!((x % (comp.dx << rpx)) == 0 ||
          (x == tx0 && ((trx0 << levelno) % (int64_t(1) << rpx)))))
      return -1;
    if (res.pw == 0 || res.ph == 0) return -1;
    if (trx0 == trx1 || try0 == try1) return -1;
    int64_t prci = floor_div_pow2(ceil_div(x, cdx), res.pdx) -
                   floor_div_pow2(trx0, res.pdx);
    int64_t prcj = floor_div_pow2(ceil_div(y, cdy), res.pdy) -
                   floor_div_pow2(try0, res.pdy);
    return prci + prcj * res.pw;
  };
  auto steps = [&](int c0, int c1, int64_t& dx, int64_t& dy) {
    dx = dy = 0;
    for (int c = c0; c < c1; ++c) {
      const Comp& comp = comps[c];
      for (int r = 0; r < comp.numres; ++r) {
        int sx = comp.res[r].pdx + comp.numres - 1 - r;
        int sy = comp.res[r].pdy + comp.numres - 1 - r;
        if (sx < 32 && comp.dx <= int64_t(UINT_MAX >> sx)) {
          int64_t v = comp.dx << sx;
          dx = dx ? std::min(dx, v) : v;
        }
        if (sy < 32 && comp.dy <= int64_t(UINT_MAX >> sy)) {
          int64_t v = comp.dy << sy;
          dy = dy ? std::min(dy, v) : v;
        }
      }
    }
    return dx != 0 && dy != 0;
  };
  // One progression; false where OpenJPEG's opj_pi_next gives up on it
  // (its packets are then not read, which is no error).
  auto run = [&](const Poc& q) -> bool {
    int r0 = int(q.resno0), r1 = int(q.resno1), c0 = int(q.compno0),
        c1 = int(q.compno1);
    int l1 = int(std::min<int64_t>(q.layno1, numlayers));
    if (c0 >= numcomps || c1 > numcomps) return false;
    switch (q.prg) {
      case 0:   // LRCP
        for (int l = 0; l < l1; ++l)
          for (int r = r0; r < r1; ++r)
            for (int c = c0; c < c1; ++c) {
              if (r >= comps[c].numres) continue;
              const Res& res = comps[c].res[r];
              for (int64_t p = 0; p < res.pw * res.ph; ++p)
                if (!emit(l, r, c, p)) return false;
            }
        return true;
      case 1:   // RLCP
        for (int r = r0; r < r1; ++r)
          for (int l = 0; l < l1; ++l)
            for (int c = c0; c < c1; ++c) {
              if (r >= comps[c].numres) continue;
              const Res& res = comps[c].res[r];
              for (int64_t p = 0; p < res.pw * res.ph; ++p)
                if (!emit(l, r, c, p)) return false;
            }
        return true;
      case 2: {   // RPCL
        int64_t dx, dy;
        if (!steps(0, numcomps, dx, dy)) return false;
        for (int r = r0; r < r1; ++r)
          for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
              for (int c = c0; c < c1; ++c) {
                if (r >= comps[c].numres) continue;
                int64_t p = position(comps[c], r, x, y);
                if (p < 0) continue;
                for (int l = 0; l < l1; ++l)
                  if (!emit(l, r, c, p)) return false;
              }
        return true;
      }
      case 3: {   // PCRL
        int64_t dx, dy;
        if (!steps(0, numcomps, dx, dy)) return false;
        for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
          for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
            for (int c = c0; c < c1; ++c)
              for (int r = r0; r < std::min(r1, comps[c].numres); ++r) {
                int64_t p = position(comps[c], r, x, y);
                if (p < 0) continue;
                for (int l = 0; l < l1; ++l)
                  if (!emit(l, r, c, p)) return false;
              }
        return true;
      }
      case 4:   // CPRL
        for (int c = c0; c < c1; ++c) {
          int64_t dx, dy;
          if (!steps(c, c + 1, dx, dy)) return false;
          for (int64_t y = ty0; y < ty1; y += dy - (y % dy))
            for (int64_t x = tx0; x < tx1; x += dx - (x % dx))
              for (int r = r0; r < std::min(r1, comps[c].numres); ++r) {
                int64_t p = position(comps[c], r, x, y);
                if (p < 0) continue;
                for (int l = 0; l < l1; ++l)
                  if (!emit(l, r, c, p)) return false;
              }
        }
        return true;
      default:
        return false;
    }
  };
  for (const Poc& q : order) {
    if (q.prg < 0) return false;   // a COD's unknown order: an error
    run(q);
  }
  return true;
}

// One packet: header from `hdr` (the body stream itself unless PPM/PPT),
// then its code-block segments from `body`. Returns 0 or an error.
int read_packet(Tile& t, const Packet& pk, const uint8_t* body,
                int64_t body_len, int64_t& body_pos, const uint8_t* hdr,
                int64_t hdr_len, int64_t& hdr_pos, bool separate_headers,
                int64_t* record) {
  Comp& comp = t.comps[pk.compno];
  Res& res = comp.res[pk.resno];
  if (pk.layno == 0) {
    for (int b = 0; b < res.numbands; ++b) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      if (pk.precno >= int64_t(band.precs.size())) return kBadPrecinct;
      Prec& pr = band.precs[pk.precno];
      pr.incl.reset();
      pr.imsb.reset();
      for (auto& cb : pr.cblks) cb.numsegs = 0;
    }
  }
  if (record) record[0] = body_pos;
  if (t.csty & 0x02) {   // SOP
    if (body_len - body_pos >= 6 && body[body_pos] == 0xFF &&
        body[body_pos + 1] == 0x91)
      body_pos += 6;
  }
  const uint8_t* hbase = separate_headers ? hdr : body;
  int64_t hlen = separate_headers ? hdr_len : body_len;
  int64_t& hpos = separate_headers ? hdr_pos : body_pos;
  if (record) record[1] = hpos;
  Bio bio(hbase + hpos, hlen - hpos);
  bool present = bio.read(1) != 0;
  if (present) {
    for (int b = 0; b < res.numbands; ++b) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Prec& pr = band.precs[pk.precno];
      for (int cbn = 0; cbn < pr.cw * pr.ch; ++cbn) {
        Cblk& cb = pr.cblks[cbn];
        uint32_t included;
        if (!cb.numsegs) included = tgt_decode(bio, pr.incl, cbn, pk.layno + 1);
        else included = bio.read(1);
        if (!included) {
          cb.numnewpasses = 0;
          continue;
        }
        if (!cb.numsegs) {
          int i = 0;
          while (!tgt_decode(bio, pr.imsb, cbn, i)) {
            ++i;
            if (i > 128) return kZeroBitplanes;
          }
          cb.numbps = band.numbps + 1 - i;
          cb.numlenbits = 3;
        }
        cb.numnewpasses = int(getnumpasses(bio));
        int incr = 0;
        while (bio.read(1)) ++incr;
        cb.numlenbits += incr;
        int segno = 0;
        if (!cb.numsegs) {
          init_seg(cb, 0, comp.cblksty, true);
        } else {
          segno = cb.numsegs - 1;
          if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) {
            ++segno;
            init_seg(cb, segno, comp.cblksty, false);
          }
        }
        int n = cb.numnewpasses;
        do {
          Seg& s = cb.segs[segno];
          s.numnewpasses = std::min(s.maxpasses - s.numpasses, n);
          int bits = cb.numlenbits + floorlog2(uint32_t(s.numnewpasses));
          if (bits > 32) return kBadBitNumber;
          s.newlen = bio.read(bits);
          n -= s.numnewpasses;
          if (n > 0) {
            ++segno;
            init_seg(cb, segno, comp.cblksty, false);
          }
        } while (n > 0);
      }
    }
  }
  bio.inalign();
  hpos += bio.numbytes();
  if (t.csty & 0x04) {   // EPH
    if (hlen - hpos >= 2 && hbase[hpos] == 0xFF && hbase[hpos + 1] == 0x92)
      hpos += 2;
  }
  if (record) record[2] = hpos;
  if (!present) {
    if (record) record[3] = body_pos;
    return 0;
  }
  for (int b = 0; b < res.numbands; ++b) {
    Band& band = res.bands[b];
    if (band.empty()) continue;
    Prec& pr = band.precs[pk.precno];
    for (auto& cb : pr.cblks) {
      if (!cb.numnewpasses) continue;
      int segi;
      if (!cb.numsegs) {
        segi = 0;
        cb.numsegs = 1;
      } else {
        segi = cb.numsegs - 1;
        if (cb.segs[segi].numpasses == cb.segs[segi].maxpasses) {
          ++segi;
          ++cb.numsegs;
        }
      }
      do {
        Seg& s = cb.segs[segi];
        if (s.newlen > body_len - body_pos) return kSegmentTooLong;
        cb.data.insert(cb.data.end(), body + body_pos,
                       body + body_pos + s.newlen);
        body_pos += s.newlen;
        s.len += s.newlen;
        s.numpasses += s.numnewpasses;
        cb.numnewpasses -= s.numnewpasses;
        if (cb.numnewpasses > 0) {
          ++segi;
          ++cb.numsegs;
        }
      } while (cb.numnewpasses > 0);
    }
  }
  if (record) record[3] = body_pos;
  return 0;
}

int decode_cblk(T1& t1, Cblk& cb, const Comp& comp, const Band& band) {
  int w = int(cb.x1 - cb.x0), h = int(cb.y1 - cb.y0);
  if (w <= 0 || h <= 0) return 0;
  t1.reset(w, h);
  t1.orient = band.bandno;
  t1.vsc = comp.cblksty & 0x08;
  int bpno_plus_one = comp.roishift + cb.numbps;
  if (bpno_plus_one >= 31) return kTooManyBitplanes;
  int passtype = 2;
  t1.mq.reset_states();
  int64_t offset = 0;
  for (int s = 0; s < cb.numsegs; ++s) {
    const Seg& seg = cb.segs[s];
    // The segment's data with OpenJPEG's 0xFF 0xFF after it (the bytes it
    // overwrites for the call).
    std::vector<uint8_t> segbuf(cb.data.begin() + offset,
                                cb.data.begin() + offset + seg.len);
    segbuf.push_back(0xFF);
    segbuf.push_back(0xFF);
    t1.raw = (comp.cblksty & 0x01) && passtype < 2 &&
             bpno_plus_one <= cb.numbps - 4;
    if (t1.raw) t1.raw_init(segbuf.data());
    else t1.mq.init(segbuf.data(), seg.len);
    offset += seg.len;
    for (int pass = 0; pass < seg.numpasses && bpno_plus_one >= 1; ++pass) {
      if (passtype == 0) t1.sigpass(bpno_plus_one);
      else if (passtype == 1) t1.refpass(bpno_plus_one);
      else t1.clnpass(bpno_plus_one, comp.cblksty & 0x20);
      if ((comp.cblksty & 0x02) && !t1.raw) t1.mq.reset_states();
      if (++passtype == 3) {
        passtype = 0;
        --bpno_plus_one;
      }
    }
  }
  if (comp.roishift) {
    if (comp.roishift >= 31) {
      std::fill(t1.data.begin(), t1.data.end(), 0);
    } else {
      int32_t thresh = int32_t(1) << comp.roishift;
      for (auto& v : t1.data) {
        int32_t mag = std::abs(v);
        if (mag >= thresh) {
          mag >>= comp.roishift;
          v = v < 0 ? -mag : mag;
        }
      }
    }
  }
  return 0;
}

// Coefficients of every code-block into the component's tile array.
int tier1(Tile& t) {
  T1 t1;
  for (auto& c : t.comps) {
    int64_t w = c.x1 - c.x0;
    for (int r = 0; r < c.numres; ++r) {
      Res& res = c.res[r];
      for (int b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        float step = 0.5f * band.stepsize;
        for (auto& pr : band.precs)
          for (auto& cb : pr.cblks) {
            if (cb.numsegs == 0) continue;   // never included: zeros
            int err = decode_cblk(t1, cb, c, band);
            if (err) return err;
            int64_t bw = cb.x1 - cb.x0, bh = cb.y1 - cb.y0;
            if (bw <= 0 || bh <= 0) continue;
            int64_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
            if (band.bandno & 1) x += c.res[r - 1].x1 - c.res[r - 1].x0;
            if (band.bandno & 2) y += c.res[r - 1].y1 - c.res[r - 1].y0;
            for (int64_t j = 0; j < bh; ++j)
              for (int64_t i = 0; i < bw; ++i) {
                int32_t v = t1.data[size_t(j * bw + i)];
                uint32_t& dst = c.data[size_t((y + j) * w + x + i)];
                if (c.qmfbid == 1) {
                  int32_t q = v / 2;
                  std::memcpy(&dst, &q, 4);
                } else {
                  float f = float(v) * step;
                  std::memcpy(&dst, &f, 4);
                }
              }
          }
      }
    }
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Inverse wavelets (OpenJPEG's dwt.c, whole-tile)

const float kK = 1.230174105f;
const float kTwoInvK = 1.625732422f;
const float kAlpha = 1.586134342f, kBeta = 0.052980118f,
            kGamma = -0.882911075f, kDelta = -0.443506852f;

// One inverse lifting step on `lanes` interleaved lines of len samples
// (x[k * lanes + j] is sample k of line j): every sample of parity `par`
// updated from its neighbours, mirrored about the first and last sample.
// OpenJPEG's loops (opj_idwt53_h_cas0/1, opj_v8dwt_decode_step2) give the
// same sums: their boundary term l * (2c) is (l + l) * c in float32.
template <typename T, typename F>
void lift(T* x, int len, int lanes, int par, F update) {
  for (int k = par; k < len; k += 2) {
    const T* l = x + size_t(k > 0 ? k - 1 : 1) * lanes;
    const T* r = x + size_t(k + 1 < len ? k + 1 : len - 2) * lanes;
    T* m = x + size_t(k) * lanes;
    for (int j = 0; j < lanes; ++j) m[j] = update(m[j], l[j], r[j]);
  }
}

// The inverse 5/3 of interleaved lines (low samples at parity cas); a line
// of one sample: kept if even, halved toward zero if odd.
void idwt53_lines(int32_t* x, int len, int lanes, int cas) {
  if (len == 1) {
    if (cas)
      for (int j = 0; j < lanes; ++j) x[j] /= 2;
    return;
  }
  lift(x, len, lanes, cas, [](int32_t m, int32_t l, int32_t r) {
    return m - ((l + r + 2) >> 2);
  });
  lift(x, len, lanes, 1 - cas, [](int32_t m, int32_t l, int32_t r) {
    return m + ((l + r) >> 1);
  });
}

// The inverse 9/7 of interleaved lines (opj_v8dwt_decode); a line of one
// sample is left as it is.
void idwt97_lines(float* x, int len, int lanes, int cas) {
  if (len == 1) return;
  for (int k = 0; k < len; ++k) {
    float f = ((k + cas) & 1) ? kTwoInvK : kK;
    float* m = x + size_t(k) * lanes;
    for (int j = 0; j < lanes; ++j) m[j] *= f;
  }
  const float cs[4] = {kDelta, kGamma, kBeta, kAlpha};
  for (int s = 0; s < 4; ++s) {
    float c = cs[s];
    lift(x, len, lanes, (s & 1) ? 1 - cas : cas,
         [c](float m, float l, float r) { return m + ((l + r) * c); });
  }
}

void idwt_lines(int32_t* x, int len, int lanes, int cas) {
  idwt53_lines(x, len, lanes, cas);
}
void idwt_lines(float* x, int len, int lanes, int cas) {
  idwt97_lines(x, len, lanes, cas);
}

// One level's rows or columns: gather `lanes` lines of the resolution
// (sn low samples then dn high ones, `step` apart in c.data, lines
// `pitch` apart) interleaved, transform, write back.
template <typename T>
void idwt_pass(Comp& c, int64_t first, int64_t lines, int64_t sn, int64_t dn,
               int cas, int64_t step, int64_t pitch) {
  const int kLanes = 32;
  int64_t len = sn + dn;
  if (len == 0) return;
  std::vector<T> buf(size_t(len) * kLanes);
  for (int64_t j0 = 0; j0 < lines; j0 += kLanes) {
    int lanes = int(std::min<int64_t>(kLanes, lines - j0));
    for (int64_t k = 0; k < len; ++k) {
      int64_t src = ((k + cas) & 1) ? sn + (k - (1 - cas)) / 2 : (k - cas) / 2;
      for (int j = 0; j < lanes; ++j)
        std::memcpy(&buf[size_t(k) * lanes + j],
                    &c.data[size_t(first + (j0 + j) * pitch + src * step)], 4);
    }
    idwt_lines(buf.data(), int(len), lanes, cas);
    for (int64_t k = 0; k < len; ++k)
      for (int j = 0; j < lanes; ++j)
        std::memcpy(&c.data[size_t(first + (j0 + j) * pitch + k * step)],
                    &buf[size_t(k) * lanes + j], 4);
  }
}

// OpenJPEG's whole-tile inverse transform: at each level, the rows of the
// resolution, then its columns.
void idwt(Comp& c) {
  int64_t w = c.x1 - c.x0;
  for (int r = 1; r < c.numres; ++r) {
    const Res& lo = c.res[r - 1];
    const Res& res = c.res[r];
    int64_t rw = res.x1 - res.x0, rh = res.y1 - res.y0;
    int64_t sn_h = lo.x1 - lo.x0, sn_v = lo.y1 - lo.y0;
    int cas_h = int(res.x0 & 1), cas_v = int(res.y0 & 1);
    if (c.qmfbid == 1) {
      idwt_pass<int32_t>(c, 0, rh, sn_h, rw - sn_h, cas_h, 1, w);
      idwt_pass<int32_t>(c, 0, rw, sn_v, rh - sn_v, cas_v, w, 1);
    } else {
      idwt_pass<float>(c, 0, rh, sn_h, rw - sn_h, cas_h, 1, w);
      idwt_pass<float>(c, 0, rw, sn_v, rh - sn_v, cas_v, w, 1);
    }
  }
}

int mct_decode(Tile& t) {
  if (!t.mct || t.numcomps < 3) return 0;
  size_t n = t.comps[0].data.size();
  for (int c = 1; c < 3; ++c)
    if (t.comps[c].data.size() != n ||
        t.comps[c].numres != t.comps[0].numres)
      return kMctSizes;
  uint32_t* c0 = t.comps[0].data.data();
  uint32_t* c1 = t.comps[1].data.data();
  uint32_t* c2 = t.comps[2].data.data();
  if (t.comps[0].qmfbid == 1) {
    for (size_t i = 0; i < n; ++i) {
      int32_t y, u, v;
      std::memcpy(&y, &c0[i], 4);
      std::memcpy(&u, &c1[i], 4);
      std::memcpy(&v, &c2[i], 4);
      int32_t g = y - ((u + v) >> 2);
      int32_t r = v + g, b = u + g;
      std::memcpy(&c0[i], &r, 4);
      std::memcpy(&c1[i], &g, 4);
      std::memcpy(&c2[i], &b, 4);
    }
  } else {
    for (size_t i = 0; i < n; ++i) {
      float y, u, v;
      std::memcpy(&y, &c0[i], 4);
      std::memcpy(&u, &c1[i], 4);
      std::memcpy(&v, &c2[i], 4);
      float r = y + (v * 1.402f);
      float g = y - (u * 0.34413f) - (v * 0.71414f);
      float b = y + (u * 1.772f);
      std::memcpy(&c0[i], &r, 4);
      std::memcpy(&c1[i], &g, 4);
      std::memcpy(&c2[i], &b, 4);
    }
  }
  return 0;
}

void dc_shift(Comp& c) {
  int64_t lo, hi, shift;
  if (c.sgnd) {
    lo = -(int64_t(1) << (c.prec - 1));
    hi = (int64_t(1) << (c.prec - 1)) - 1;
    shift = 0;
  } else {
    lo = 0;
    hi = (int64_t(1) << c.prec) - 1;
    shift = int64_t(1) << (c.prec - 1);
  }
  for (auto& word : c.data) {
    int64_t v;
    if (c.qmfbid == 1) {
      int32_t s;
      std::memcpy(&s, &word, 4);
      v = std::min(hi, std::max(lo, int64_t(s) + shift));
    } else {
      float f;
      std::memcpy(&f, &word, 4);
      if (f > float(INT_MAX)) v = hi;
      else if (f < float(INT_MIN)) v = lo;
      else v = std::min(hi, std::max(lo, int64_t(lrintf(f)) + shift));
    }
    int32_t out = int32_t(v);
    std::memcpy(&word, &out, 4);
  }
}

}  // namespace

extern "C" {

// Decode one tile. params (int64): numcomps, tx0, ty0, tx1, ty1 (the tile
// on the reference grid, clipped to the image), prg, numlayers, mct, csty
// (the COD's Scod), npocs, then npocs x (resno0, compno0, layno1, resno1,
// compno1, prg); then for each component: dx, dy, prec, sgnd, numres,
// cblkw, cblkh (exponents), cblksty, qmfbid, qntsty, numgbits, roishift,
// numres x (PPx, PPy), (3 (numres - 1) + 1) x (expn, mant). body: the
// tile-parts' data after SOD, concatenated. hdr/hdr_len: the packet
// headers when they are in PPM or PPT markers (hdr_len < 0: in the body).
// out: each component's tile samples after the DC shift, int32, component
// after component. info[0]: header bytes consumed from hdr; info[1]: body
// bytes consumed. packets/max_packets: where not null, each packet's body
// offset before its SOP, its header's start and end (after EPH) in the
// header stream, and its body's end, as 4 int64, plus (layer, resolution,
// component, precinct); with decode 0 tier 1 and the wavelets are skipped.
int64_t tb_j2k_decode_tile(const int64_t* params, int64_t nparams,
                           const uint8_t* body, int64_t body_len,
                           const uint8_t* hdr, int64_t hdr_len, int32_t* out,
                           int64_t* info, int64_t* packets,
                           int64_t max_packets, int64_t decode) {
  Tile t;
  if (!t.parse(params, nparams)) return kBadParams;
  for (auto& c : t.comps) {
    for (auto& r : c.res)
      if (r.pdx < 0 || r.pdx > 15 || r.pdy < 0 || r.pdy > 15)
        return kBadParams;
    if (c.cblkw < 2 || c.cblkh < 2 || c.cblkw > 10 || c.cblkh > 10)
      return kBadParams;
  }
  t.layout();
  std::vector<Packet> order;
  if (!t.packet_order(order)) return kBadProgression;
  bool separate = hdr_len >= 0;
  int64_t body_pos = 0, hdr_pos = 0;
  int64_t n_rec = 0;
  for (const Packet& pk : order) {
    int64_t rec[4];
    int err = read_packet(t, pk, body, body_len, body_pos, hdr,
                          separate ? hdr_len : 0, hdr_pos, separate, rec);
    if (err) return err;
    if (packets && n_rec < max_packets) {
      int64_t* p = packets + 8 * n_rec;
      for (int i = 0; i < 4; ++i) p[i] = rec[i];
      p[4] = pk.layno;
      p[5] = pk.resno;
      p[6] = pk.compno;
      p[7] = pk.precno;
    }
    ++n_rec;
  }
  info[0] = hdr_pos;
  info[1] = body_pos;
  info[2] = n_rec;
  if (!decode) return 0;
  int err = tier1(t);
  if (err) return err;
  for (auto& c : t.comps) idwt(c);
  err = mct_decode(t);
  if (err) return err;
  for (auto& c : t.comps) {
    dc_shift(c);
    std::memcpy(out, c.data.data(), c.data.size() * 4);
    out += c.data.size();
  }
  return 0;
}

}  // extern "C"
