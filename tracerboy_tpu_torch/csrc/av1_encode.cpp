// The AV1 writer of the port's AVIF writer (core/avif_save.py): one intra
// frame written from its decision record (av1_syntax.inc) as libaom 3.12's
// av1_pack_bitstream writes it for libavif 1.3, byte for byte; and
// libavif's RGB-to-YUV as Pillow's encoder runs it. Host code, compiled
// with g++ at first use into the port's build directory
// (core/codecs.av1_encode_library) and called through ctypes.
//
// The record holds what a frame decided: headers, tile layout, partition,
// modes, palettes and colour maps, intra block copy vectors, transform
// sizes and types, quantized levels, CDEF strengths, delta q and delta LF
// values, loop restoration units. What only the bitstream decides, this
// file derives as libaom does: every symbol's context (from its own copy
// of the frame's per-mi state, never from the record), the palette
// caches' flags and delta widths (delta_encode_palette_colors), the V
// palette's choice between delta and raw coding by libaom's rate rule,
// the end of block from the levels, the OBU size fields (the fewest
// LEB128 bytes), context_update_tile_id (the first largest tile) and
// tile_size_bytes (remux_tiles' choose_size_bytes of the largest tile).
//
// The OBUs are libaom's for a still frame as libavif keeps them: a
// temporal delimiter, the sequence header and one OBU_FRAME (the frame
// header, then every tile in one tile group), each with its size field.
// The entropy coder is libaom's od_ec encoder (entenc.c): od_ec_encode_q15
// and od_ec_encode_bool_q15 with the carry kept in 16-bit precarry words,
// the CDF adaptation of the symbol decoder (av1_syntax.inc), and
// od_ec_enc_done's flush, which writes the fewest bits that decode the
// same whatever follows, then a 1 bit.
//
// Departures from libaom: none in the bytes of a frame libaom wrote. A
// frame identifier (frame_id_numbers_present_flag) is written with the
// width the port's decoder reads.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

#include "av1_tables.inc"
#include "av1_syntax.inc"

// ---------------------------------------------------------------------------
// Bit writer for headers (aom_write_bit_buffer).

struct BitWriter {
  std::vector<uint8_t> d;
  size_t pos = 0;  // in bits
  void f(int k, uint32_t v) {
    for (int i = k - 1; i >= 0; i--, pos++) {
      if ((pos >> 3) >= d.size()) d.push_back(0);
      if ((v >> i) & 1) d[pos >> 3] |= (uint8_t)(0x80 >> (pos & 7));
    }
  }
  void su(int k, int v) { f(k, (uint32_t)v & ((1u << k) - 1)); }
  void uvlc(uint32_t v) {
    uint64_t x = (uint64_t)v + 1;
    int lz = 63 - __builtin_clzll(x);
    f(lz, 0);
    f(1, 1);
    f(lz, (uint32_t)(x - ((uint64_t)1 << lz)));
  }
  void ns(uint32_t n, uint32_t v) {  // wb_write_uniform
    int w = floor_log2(n) + 1;
    uint32_t m = (1u << w) - n;
    if (v < m) {
      f(w - 1, v);
    } else {
      f(w - 1, (v + m) >> 1);
      f(1, (v + m) & 1);
    }
  }
  void byte_align() {
    while (pos & 7) f(1, 0);
  }
  void trailing() {
    f(1, 1);
    byte_align();
  }
};

void put_leb128(std::vector<uint8_t>& out, size_t v) {
  do {
    uint8_t b = v & 0x7f;
    v >>= 7;
    out.push_back(b | (v ? 0x80 : 0));
  } while (v);
}

// ---------------------------------------------------------------------------
// The symbol encoder (libaom's entenc.c).

struct SymbolEncoder {
  std::vector<uint16_t> precarry;
  uint64_t low = 0;
  uint32_t rng = 0x8000;
  int cnt = -9;
  bool no_update = false;

  void normalize(uint64_t l, uint32_t r) {
    int d = 15 - floor_log2(r);
    int c = cnt, s = c + d;
    if (s >= 0) {
      c += 16;
      uint64_t m = ((uint64_t)1 << c) - 1;
      if (s >= 8) {
        precarry.push_back((uint16_t)(l >> c));
        l &= m;
        c -= 8;
        m >>= 8;
      }
      precarry.push_back((uint16_t)(l >> c));
      s = c + d - 24;
      l &= m;
    }
    low = l << d;
    rng = r << d;
    cnt = s;
  }
  // od_ec_encode_q15: fl and fh are inverse CDF values (32768 - cdf).
  void encode_q15(uint32_t fl, uint32_t fh, int s, int nsyms) {
    uint64_t l = low;
    uint32_t r = rng;
    int n = nsyms - 1;
    if (fl < 32768) {
      uint32_t u = ((r >> 8) * (fl >> 6) >> 1) + 4 * (n - (s - 1));
      uint32_t v = ((r >> 8) * (fh >> 6) >> 1) + 4 * (n - s);
      l += r - u;
      r = u - v;
    } else {
      r -= ((r >> 8) * (fh >> 6) >> 1) + 4 * (n - s);
    }
    normalize(l, r);
  }
  // aom_write_symbol on the decoder's CDF layout, with its adaptation.
  void symbol(int s, uint16_t* cdf, int n) {
    if (s < 0 || s >= n) corrupt("record: a symbol out of its range");
    encode_q15(s > 0 ? 32768 - cdf[s - 1] : 32768, 32768 - cdf[s], s, n);
    if (!no_update) {
      int rate = 3 + (cdf[n] > 15) + (cdf[n] > 31) + imin(floor_log2(n), 2);
      uint32_t tmp = 0;
      for (int i = 0; i < n - 1; i++) {
        tmp = (i == s) ? (1u << 15) : tmp;
        if (tmp < cdf[i])
          cdf[i] -= (uint16_t)((cdf[i] - tmp) >> rate);
        else
          cdf[i] += (uint16_t)((tmp - cdf[i]) >> rate);
      }
      cdf[n] += (cdf[n] < 32);
    }
  }
  // A symbol of a CDF that does not adapt (aom_write_cdf).
  void fixed(int s, uint16_t* cdf, int n) {
    bool saved = no_update;
    no_update = true;
    symbol(s, cdf, n);
    no_update = saved;
  }
  void boolean(int b) {  // aom_write_bit: od_ec_encode_bool_q15 at 16384
    uint64_t l = low;
    uint32_t r = rng;
    uint32_t v = ((r >> 8) * (16384 >> 6) >> 1) + 4;
    if (b) l += r - v;
    normalize(l, b ? v : r - v);
  }
  void literal(int v, int n) {
    for (int i = n - 1; i >= 0; i--) boolean((v >> i) & 1);
  }
  void ns(int n, int v) {  // write_uniform, aom_write_primitive_quniform
    if (n <= 1) return;
    int w = floor_log2(n) + 1, m = (1 << w) - n;
    if (v < m) {
      literal(v, w - 1);
    } else {
      literal(m + ((v - m) >> 1), w - 1);
      literal((v - m) & 1, 1);
    }
  }
  // od_ec_enc_done, then the carry propagation.
  std::vector<uint8_t> done() {
    uint64_t m = 0x3fff, e = ((low + m) & ~m) | (m + 1);
    int c = cnt, s = 10 + c;
    std::vector<uint16_t> buf = precarry;
    if (s > 0) {
      uint64_t n = ((uint64_t)1 << (c + 16)) - 1;
      do {
        buf.push_back((uint16_t)(e >> (c + 16)));
        e &= n;
        s -= 8;
        c -= 8;
        n >>= 8;
      } while (s > 0);
    }
    std::vector<uint8_t> out(buf.size());
    uint32_t carry = 0;
    for (size_t i = buf.size(); i-- > 0;) {
      carry += buf[i];
      out[i] = (uint8_t)carry;
      carry >>= 8;
    }
    return out;
  }
};

// ---------------------------------------------------------------------------
// The record, read in order.

struct RecordReader {
  const int32_t* r;
  size_t n, pos = 0;
  int tag() const { return pos + 1 < n ? r[pos] : 0; }
  const int32_t* take(int tag, size_t* len, size_t min_len = 0) {
    if (pos + 2 > n || r[pos] != tag) corrupt("record: an entry out of place");
    size_t l = (size_t)(uint32_t)r[pos + 1];
    if (l > n - pos - 2 || l < min_len) corrupt("record: an entry's length");
    const int32_t* v = r + pos + 2;
    pos += 2 + l;
    *len = l;
    return v;
  }
};

int find(const uint8_t* table, int n, int v) {
  for (int i = 0; i < n; i++)
    if (table[i] == v) return i;
  corrupt("record: a transform type outside its set");
}

// ---------------------------------------------------------------------------
// The writer.

struct Encoder : FrameState {
  FrameHeader fh;
  GrainParams grain;
  RecordReader in;

  // Tile state beyond FrameState's.
  SymbolEncoder se;
  int delta_lf[4] = {0}, read_deltas = 0;
  int ref_lr_wiener[3][2][3], ref_sgr_xqd[3][2];

  // Block state beyond FrameState's: the block's kRecBlock entry.
  const int32_t* blk = nullptr;
  size_t blk_len = 0;
  int skip = 0, y_mode = 0, use_filter_intra = 0, filter_intra_mode = 0;
  int use_intrabc = 0, mv[2] = {0, 0};
  int pal_size_y = 0, pal_size_uv = 0;
  uint16_t pal_y[8], pal_u[8], pal_v[8];
  int tx_size = 0;
  uint8_t leaf_tx[32][32];  // an intra block copy's var-tx leaves

  // --- Headers ----------------------------------------------------------

  void read_headers() {
    size_t n;
    const int32_t* v = in.take(kRecSeq, &n, sizeof(SeqHeader) / 4);
    memcpy((void*)&seq, v, sizeof(SeqHeader));
    v = in.take(kRecFrame, &n, (sizeof(FrameHeader) + sizeof(GrainParams)) / 4);
    memcpy((void*)&fh, v, sizeof(FrameHeader));
    memcpy((void*)&grain, v + sizeof(FrameHeader) / 4, sizeof(GrainParams));
    if (seq.bit_depth != 8) unsupported("high bit depth");
    if (fh.tile_cols < 1 || fh.tile_cols > 64 || fh.tile_rows < 1 ||
        fh.tile_rows > 64)
      corrupt("record: tiles");
    mi_cols = 2 * ((fh.frame_w + 7) >> 3);
    mi_rows = 2 * ((fh.frame_h + 7) >> 3);
    num_planes = seq.mono ? 1 : 3;
    base_q_idx = fh.base_q_idx;
    allow_intrabc = fh.allow_intrabc;
    allow_sct = fh.allow_sct;
    seg_enabled = fh.seg_enabled;
    delta_q_present = fh.delta_q_present;
    delta_q_res = fh.delta_q_res;
    delta_lf_present = fh.delta_lf_present;
    delta_lf_res = fh.delta_lf_res;
    delta_lf_multi = fh.delta_lf_multi;
    cdef_bits = fh.cdef_bits;
    tx_mode_select = fh.tx_mode_select;
    reduced_tx_set = fh.reduced_tx_set;
    memcpy(feature_enabled, fh.feature_enabled, sizeof(feature_enabled));
    memcpy(feature_data, fh.feature_data, sizeof(feature_data));
    for (int i = 0; i < 8; i++)
      for (int j = 0; j < 8; j++)
        if (seg_enabled && feature_enabled[i][j]) {
          last_active_seg_id = i;
          if (j >= 5) seg_id_pre_skip = 1;
        }
    coded_lossless = 1;
    for (int sid = 0; sid < 8; sid++) {
      lossless_array[sid] = get_qindex(1, sid) == 0 && fh.dq_ydc == 0 &&
                            fh.dq_uac == 0 && fh.dq_udc == 0 &&
                            fh.dq_vac == 0 && fh.dq_vdc == 0;
      if (!lossless_array[sid]) coded_lossless = 0;
    }
    bool filters = !coded_lossless && !allow_intrabc;
    for (int p = 0; p < 3; p++) {
      lr_type[p] = filters && seq.enable_restoration ? fh.lr_type[p] : 0;
      lr_size[p] = fh.lr_size[p];
    }
  }

  void sequence_header(BitWriter& b) {
    const SeqHeader& s = seq;
    b.f(3, s.profile);
    b.f(1, s.still);
    b.f(1, s.reduced);
    if (s.reduced) {
      b.f(5, s.op_level[0]);
    } else {
      b.f(1, s.timing_info);
      if (s.timing_info) {
        b.f(32, (uint32_t)s.num_units_in_display_tick);
        b.f(32, (uint32_t)s.time_scale);
        b.f(1, s.equal_picture_interval);
        if (s.equal_picture_interval)
          b.uvlc((uint32_t)s.num_ticks_per_picture - 1);
        b.f(1, s.decoder_model_info);
        if (s.decoder_model_info) {
          b.f(5, s.buffer_delay_len - 1);
          b.f(32, (uint32_t)s.num_units_in_decoding_tick);
          b.f(5, s.buffer_removal_time_len - 1);
          b.f(5, s.frame_presentation_time_len - 1);
        }
      }
      b.f(1, s.idd_present);
      b.f(5, s.op_cnt - 1);
      for (int i = 0; i < s.op_cnt; i++) {
        b.f(12, s.op_idc[i]);
        b.f(5, s.op_level[i]);
        if (s.op_level[i] > 7) b.f(1, s.op_tier[i]);
        if (s.decoder_model_info) {
          b.f(1, s.decoder_model_present[i]);
          if (s.decoder_model_present[i]) {
            b.f(s.buffer_delay_len, s.op_decoder_delay[i]);
            b.f(s.buffer_delay_len, s.op_encoder_delay[i]);
            b.f(1, s.op_low_delay[i]);
          }
        }
        if (s.idd_present) {
          b.f(1, s.op_idd_present[i]);
          if (s.op_idd_present[i]) b.f(4, s.op_idd[i]);
        }
      }
    }
    b.f(4, s.frame_width_bits - 1);
    b.f(4, s.frame_height_bits - 1);
    b.f(s.frame_width_bits, s.max_w - 1);
    b.f(s.frame_height_bits, s.max_h - 1);
    if (!s.reduced) b.f(1, s.frame_id_numbers);
    if (s.frame_id_numbers) {
      b.f(4, s.delta_frame_id_len - 2);
      b.f(3, s.add_frame_id_len - 1);
    }
    b.f(1, s.sb128);
    b.f(1, s.enable_filter_intra);
    b.f(1, s.enable_intra_edge);
    if (!s.reduced) {
      b.f(1, s.enable_interintra);
      b.f(1, s.enable_masked);
      b.f(1, s.enable_warped);
      b.f(1, s.enable_dual_filter);
      b.f(1, s.enable_order_hint);
      if (s.enable_order_hint) {
        b.f(1, s.enable_jnt_comp);
        b.f(1, s.enable_ref_frame_mvs);
      }
      b.f(1, s.force_screen_content == 2);
      if (s.force_screen_content != 2) b.f(1, s.force_screen_content);
      if (s.force_screen_content > 0) {
        b.f(1, s.force_integer_mv == 2);
        if (s.force_integer_mv != 2) b.f(1, s.force_integer_mv);
      }
      if (s.enable_order_hint) b.f(3, s.order_hint_bits - 1);
    }
    b.f(1, s.enable_superres);
    b.f(1, s.enable_cdef);
    b.f(1, s.enable_restoration);
    // color_config
    b.f(1, s.bit_depth > 8);
    if (s.profile == 2 && s.bit_depth > 8) b.f(1, s.bit_depth == 12);
    if (s.profile != 1) b.f(1, s.mono);
    b.f(1, s.color_description);
    if (s.color_description) {
      b.f(8, s.cp);
      b.f(8, s.tc);
      b.f(8, s.mc);
    }
    if (s.mono) {
      b.f(1, s.full_range);
    } else {
      if (!(s.cp == 1 && s.tc == 13 && s.mc == 0)) {
        b.f(1, s.full_range);
        if (s.profile == 2 && s.bit_depth == 12) {
          b.f(1, s.ssx);
          if (s.ssx) b.f(1, s.ssy);
        }
        if (s.ssx && s.ssy) b.f(2, s.csp);
      }
      b.f(1, s.separate_uv_delta_q);
    }
    b.f(1, s.film_grain_present);
    b.trailing();
  }

  static void delta_q(BitWriter& b, int v) {
    b.f(1, v != 0);
    if (v) b.su(7, v);
  }

  void tile_info(BitWriter& b, int largest_tile, int tile_size_bytes) {
    int sb_cols = seq.sb128 ? (mi_cols + 31) >> 5 : (mi_cols + 15) >> 4;
    int sb_rows = seq.sb128 ? (mi_rows + 31) >> 5 : (mi_rows + 15) >> 4;
    int sb_shift = seq.sb128 ? 5 : 4, sb_size = sb_shift + 2;
    int max_tile_w_sb = 4096 >> sb_size;
    int max_tile_area_sb = (4096 * 2304) >> (2 * sb_size);
    auto tile_log2 = [](int blk, int target) {
      int k = 0;
      while ((blk << k) < target) k++;
      return k;
    };
    int min_log2_cols = tile_log2(max_tile_w_sb, sb_cols);
    int max_log2_cols = tile_log2(1, imin(sb_cols, 64));
    int max_log2_rows = tile_log2(1, imin(sb_rows, 64));
    int min_log2_tiles =
        imax(min_log2_cols, tile_log2(max_tile_area_sb, sb_rows * sb_cols));
    b.f(1, fh.uniform_tiles);
    auto sbs = [&](const int* starts, int i) {  // tile i's size in sbs
      return (starts[i + 1] - starts[i] + (1 << sb_shift) - 1) >> sb_shift;
    };
    if (fh.uniform_tiles) {
      for (int k = min_log2_cols; k < fh.tile_cols_log2; k++) b.f(1, 1);
      if (fh.tile_cols_log2 < max_log2_cols) b.f(1, 0);
      int min_log2_rows = imax(min_log2_tiles - fh.tile_cols_log2, 0);
      for (int k = min_log2_rows; k < fh.tile_rows_log2; k++) b.f(1, 1);
      if (fh.tile_rows_log2 < max_log2_rows) b.f(1, 0);
    } else {
      int widest = 0, st = 0;
      for (int i = 0; i < fh.tile_cols; i++) {
        int sz = sbs(fh.mi_col_starts, i);
        b.ns(imin(sb_cols - st, max_tile_w_sb), sz - 1);
        widest = imax(widest, sz);
        st += sz;
      }
      if (min_log2_tiles > 0)
        max_tile_area_sb = (sb_rows * sb_cols) >> (min_log2_tiles + 1);
      else
        max_tile_area_sb = sb_rows * sb_cols;
      int max_th = imax(max_tile_area_sb / widest, 1);
      st = 0;
      for (int i = 0; i < fh.tile_rows; i++) {
        int sz = sbs(fh.mi_row_starts, i);
        b.ns(imin(sb_rows - st, max_th), sz - 1);
        st += sz;
      }
    }
    if (fh.tile_cols_log2 > 0 || fh.tile_rows_log2 > 0) {
      b.f(fh.tile_rows_log2 + fh.tile_cols_log2, largest_tile);
      b.f(2, tile_size_bytes - 1);
    }
  }

  void frame_header(BitWriter& b, int largest_tile, int tile_size_bytes) {
    const SeqHeader& s = seq;
    if (!s.reduced) {
      b.f(1, 0);  // show_existing_frame
      b.f(2, 0);  // KEY_FRAME
      b.f(1, 1);  // show_frame
      if (s.decoder_model_info && !s.equal_picture_interval)
        b.f(s.frame_presentation_time_len, fh.frame_presentation_time);
    }
    b.f(1, fh.disable_cdf_update);
    if (s.force_screen_content == 2) b.f(1, allow_sct);
    if (allow_sct && s.force_integer_mv == 2) b.f(1, fh.force_integer_mv);
    if (s.frame_id_numbers)
      b.f(s.add_frame_id_len + s.delta_frame_id_len + 1, fh.frame_id);
    if (!s.reduced) b.f(1, fh.size_override);
    b.f(s.order_hint_bits, fh.order_hint);
    if (s.decoder_model_info) {
      b.f(1, fh.buffer_removal_present);
      if (fh.buffer_removal_present)
        for (int op = 0; op < s.op_cnt; op++)
          if (s.decoder_model_present[op]) {
            int idc = s.op_idc[op];
            if (idc == 0 || ((idc & 1) && ((idc >> 8) & 1)))
              b.f(s.buffer_removal_time_len, fh.buffer_removal[op]);
          }
    }
    if (fh.size_override) {
      b.f(s.frame_width_bits, fh.frame_w - 1);
      b.f(s.frame_height_bits, fh.frame_h - 1);
    }
    if (s.enable_superres) b.f(1, 0);
    b.f(1, fh.render_diff);
    if (fh.render_diff) {
      b.f(16, fh.render_w);
      b.f(16, fh.render_h);
    }
    if (allow_sct) b.f(1, allow_intrabc);
    if (!s.reduced && !fh.disable_cdf_update)
      b.f(1, fh.disable_frame_end_update_cdf);
    tile_info(b, largest_tile, tile_size_bytes);
    // quantization_params
    b.f(8, base_q_idx);
    delta_q(b, fh.dq_ydc);
    if (num_planes > 1) {
      int diff_uv = fh.dq_udc != fh.dq_vdc || fh.dq_uac != fh.dq_vac;
      if (s.separate_uv_delta_q) b.f(1, diff_uv);
      delta_q(b, fh.dq_udc);
      delta_q(b, fh.dq_uac);
      if (diff_uv) {
        if (!s.separate_uv_delta_q) corrupt("record: V deltas");
        delta_q(b, fh.dq_vdc);
        delta_q(b, fh.dq_vac);
      }
    }
    b.f(1, fh.using_qm);
    if (fh.using_qm) {
      b.f(4, fh.qm_y);
      b.f(4, fh.qm_u);
      if (s.separate_uv_delta_q) b.f(4, fh.qm_v);
    }
    // segmentation_params
    b.f(1, seg_enabled);
    if (seg_enabled)
      for (int i = 0; i < 8; i++)
        for (int j = 0; j < 8; j++) {
          b.f(1, feature_enabled[i][j]);
          if (!feature_enabled[i][j]) continue;
          if (kSegFeatureSigned[j])
            b.su(1 + kSegFeatureBits[j], feature_data[i][j]);
          else
            b.f(kSegFeatureBits[j], feature_data[i][j]);
        }
    // delta_q_params, delta_lf_params
    if (base_q_idx > 0) b.f(1, delta_q_present);
    if (delta_q_present) {
      b.f(2, delta_q_res);
      if (!allow_intrabc) b.f(1, delta_lf_present);
      if (delta_lf_present) {
        b.f(2, delta_lf_res);
        b.f(1, delta_lf_multi);
      }
    }
    bool filters = !coded_lossless && !allow_intrabc;
    if (filters) {  // loop_filter_params
      b.f(6, fh.lf_level[0]);
      b.f(6, fh.lf_level[1]);
      if (num_planes > 1 && (fh.lf_level[0] || fh.lf_level[1])) {
        b.f(6, fh.lf_level[2]);
        b.f(6, fh.lf_level[3]);
      }
      b.f(3, fh.lf_sharpness);
      b.f(1, fh.lf_delta_enabled);
      if (fh.lf_delta_enabled) {
        b.f(1, fh.lf_delta_update);
        if (fh.lf_delta_update) {
          static const int kRefDeltas[8] = {1, 0, 0, 0, -1, 0, -1, -1};
          for (int i = 0; i < 8; i++) {
            int changed = fh.lf_ref_deltas[i] != kRefDeltas[i];
            b.f(1, changed);
            if (changed) b.su(7, fh.lf_ref_deltas[i]);
          }
          for (int i = 0; i < 2; i++) {
            b.f(1, fh.lf_mode_deltas[i] != 0);
            if (fh.lf_mode_deltas[i]) b.su(7, fh.lf_mode_deltas[i]);
          }
        }
      }
    }
    if (filters && s.enable_cdef) {  // cdef_params
      b.f(2, fh.cdef_damping - 3);
      b.f(2, cdef_bits);
      for (int i = 0; i < (1 << cdef_bits); i++) {
        b.f(4, fh.cdef_y_pri[i]);
        b.f(2, fh.cdef_y_sec[i] == 4 ? 3 : fh.cdef_y_sec[i]);
        if (num_planes > 1) {
          b.f(4, fh.cdef_uv_pri[i]);
          b.f(2, fh.cdef_uv_sec[i] == 4 ? 3 : fh.cdef_uv_sec[i]);
        }
      }
    }
    if (filters && s.enable_restoration) {  // lr_params
      static const int kCode[4] = {0, 2, 3, 1};  // Remap_Lr_Type's inverse
      bool uses_lr = false, chroma_lr = false;
      for (int i = 0; i < num_planes; i++) {
        b.f(2, kCode[lr_type[i]]);
        if (lr_type[i]) {
          uses_lr = true;
          chroma_lr |= i > 0;
        }
      }
      if (uses_lr) {
        if (!s.sb128) b.f(1, lr_size[0] > 64);
        if (lr_size[0] > 64) b.f(1, lr_size[0] > 128);
        if (s.ssx && s.ssy && chroma_lr) b.f(1, lr_size[1] != lr_size[0]);
      }
    }
    if (!coded_lossless) b.f(1, tx_mode_select);
    b.f(1, reduced_tx_set);
    if (s.film_grain_present) film_grain_params(b);
  }

  void film_grain_params(BitWriter& b) {
    const GrainParams& g = grain;
    b.f(1, g.apply);
    if (!g.apply) return;
    b.f(16, g.seed);
    auto points = [&](const int (*pts)[2], int n) {
      b.f(4, n);
      for (int i = 0; i < n; i++) {
        b.f(8, pts[i][0]);
        b.f(8, pts[i][1]);
      }
    };
    points(g.y_pts, g.num_y);
    if (!seq.mono) b.f(1, g.from_luma);
    if (!seq.mono && !g.from_luma &&
        !(seq.ssx && seq.ssy && g.num_y == 0)) {
      points(g.cb_pts, g.num_cb);
      points(g.cr_pts, g.num_cr);
    }
    b.f(2, g.scaling_shift - 8);
    b.f(2, g.lag);
    int num_pos_luma = 2 * g.lag * (g.lag + 1);
    int num_pos_chroma = num_pos_luma + (g.num_y > 0);
    if (g.num_y)
      for (int i = 0; i < num_pos_luma; i++) b.f(8, g.ar_y[i] + 128);
    if (g.from_luma || g.num_cb)
      for (int i = 0; i < num_pos_chroma; i++) b.f(8, g.ar_cb[i] + 128);
    if (g.from_luma || g.num_cr)
      for (int i = 0; i < num_pos_chroma; i++) b.f(8, g.ar_cr[i] + 128);
    b.f(2, g.ar_shift - 6);
    b.f(2, g.scale_shift);
    if (g.num_cb) {
      b.f(8, g.cb_mult + 128);
      b.f(8, g.cb_luma_mult + 128);
      b.f(9, g.cb_offset + 256);
    }
    if (g.num_cr) {
      b.f(8, g.cr_mult + 128);
      b.f(8, g.cr_luma_mult + 128);
      b.f(9, g.cr_offset + 256);
    }
    b.f(1, g.overlap);
    b.f(1, g.clip);
  }

  // --- The temporal unit ------------------------------------------------

  std::vector<uint8_t> write() {
    read_headers();
    alloc_frame();
    int num_tiles = fh.tile_cols * fh.tile_rows;
    std::vector<std::vector<uint8_t>> tiles(num_tiles);
    for (int t = 0; t < num_tiles; t++) {
      size_t n;
      const int32_t* v = in.take(kRecTile, &n, 1);
      if (v[0] != t) corrupt("record: a tile out of place");
      tiles[t] = write_tile(t);
    }
    if (in.pos != in.n) corrupt("record: entries past the last tile");
    // write_tiles_in_tg_obus: context_update_tile_id is the first of the
    // largest tiles, remux_tiles' tile_size_bytes the fewest bytes that
    // hold the largest tile's size.
    size_t largest = 0;
    int largest_tile = 0;
    for (int t = 0; t < num_tiles; t++)
      if (tiles[t].size() > largest) {
        largest = tiles[t].size();
        largest_tile = t;
      }
    int tsb = largest >> 24 ? 4 : largest >> 16 ? 3 : largest >> 8 ? 2 : 1;
    std::vector<uint8_t> out = {0x12, 0x00};  // OBU_TEMPORAL_DELIMITER
    BitWriter sh;
    sequence_header(sh);
    out.push_back(0x0a);  // OBU_SEQUENCE_HEADER, obu_has_size_field
    put_leb128(out, sh.d.size());
    out.insert(out.end(), sh.d.begin(), sh.d.end());
    BitWriter fb;
    frame_header(fb, largest_tile, tsb);
    fb.byte_align();
    if (num_tiles > 1) {  // tile_start_and_end_present_flag
      fb.f(1, 0);
      fb.byte_align();
    }
    std::vector<uint8_t> payload = fb.d;
    for (int t = 0; t < num_tiles; t++) {
      if (t < num_tiles - 1) {
        size_t sz = tiles[t].size() - 1;
        for (int i = 0; i < tsb; i++)
          payload.push_back((uint8_t)(sz >> (8 * i)));
      }
      payload.insert(payload.end(), tiles[t].begin(), tiles[t].end());
    }
    out.push_back(0x32);  // OBU_FRAME, obu_has_size_field
    put_leb128(out, payload.size());
    out.insert(out.end(), payload.begin(), payload.end());
    return out;
  }

  void alloc_frame() {
    alloc_state();
    for (int p = 0; p < num_planes; p++) {
      int sx = p ? seq.ssx : 0, sy = p ? seq.ssy : 0;
      if (lr_type[p] == RESTORE_NONE) continue;
      if (lr_size[p] < 32) corrupt("record: restoration unit size");
      lr_unit_rows[p] = count_units(lr_size[p], (fh.frame_h + sy) >> sy);
      lr_unit_cols[p] = count_units(lr_size[p], (fh.frame_w + sx) >> sx);
    }
  }

  // --- Tiles and blocks -------------------------------------------------

  std::vector<uint8_t> write_tile(int t) {
    int tr = t / fh.tile_cols, tc = t % fh.tile_cols;
    mi_row_start = fh.mi_row_starts[tr];
    mi_row_end = fh.mi_row_starts[tr + 1];
    mi_col_start = fh.mi_col_starts[tc];
    mi_col_end = fh.mi_col_starts[tc + 1];
    if (mi_row_start < 0 || mi_row_end > mi_rows || mi_col_start < 0 ||
        mi_col_end > mi_cols || mi_row_start >= mi_row_end ||
        mi_col_start >= mi_col_end)
      corrupt("record: a tile's extent");
    current_q = base_q_idx;
    cdf.init(base_q_idx);
    se = SymbolEncoder();
    se.no_update = fh.disable_cdf_update;
    for (int p = 0; p < 3; p++) {
      std::fill(above_level[p].begin(), above_level[p].end(), 0);
      std::fill(above_dc[p].begin(), above_dc[p].end(), 0);
    }
    for (int i = 0; i < 4; i++) delta_lf[i] = 0;
    for (int p = 0; p < num_planes; p++)
      for (int pass = 0; pass < 2; pass++) {
        ref_sgr_xqd[p][pass] = Sgrproj_Xqd_Mid[pass];
        for (int i = 0; i < 3; i++)
          ref_lr_wiener[p][pass][i] = Wiener_Taps_Mid[i];
      }
    int sb_size = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    int sb4 = kNum4x4W[sb_size];
    for (int r = mi_row_start; r < mi_row_end; r += sb4) {
      for (int p = 0; p < 3; p++) {
        std::fill(left_level[p].begin(), left_level[p].end(), 0);
        std::fill(left_dc[p].begin(), left_dc[p].end(), 0);
      }
      for (int c = mi_col_start; c < mi_col_end; c += sb4) {
        read_deltas = delta_q_present;
        clear_cdef(r, c);
        write_lr(r, c, sb_size);
        write_partition(r, c, sb_size);
      }
    }
    return se.done();
  }

  void write_lr(int r, int c, int bsize) {
    if (allow_intrabc) return;
    for (int p = 0; p < num_planes; p++) {
      if (lr_type[p] == RESTORE_NONE) continue;
      int row0, row1, col0, col1;
      lr_units_of(p, r, c, bsize, &row0, &row1, &col0, &col1);
      for (int ur = row0; ur < row1; ur++)
        for (int uc = col0; uc < col1; uc++) write_lr_unit(p, ur, uc);
    }
  }

  // loop_restoration_write_sb_coeffs: the unit's type, then its Wiener
  // taps or self-guided set and projections against the running
  // references (aom_write_primitive_refsubexpfin).
  void write_lr_unit(int p, int ur, int uc) {
    size_t n;
    const int32_t* e = in.take(kRecLr, &n, 4);
    if (e[0] != p || e[1] != ur || e[2] != uc)
      corrupt("record: a restoration unit out of place");
    int t = e[3];
    if (t < 0 || t > RESTORE_SGRPROJ) corrupt("record: a restoration type");
    if (lr_type[p] == RESTORE_WIENER) {
      if (t == RESTORE_SGRPROJ) corrupt("record: a restoration type");
      se.symbol(t == RESTORE_WIENER, cdf.use_wiener, 2);
    } else if (lr_type[p] == RESTORE_SGRPROJ) {
      if (t == RESTORE_WIENER) corrupt("record: a restoration type");
      se.symbol(t == RESTORE_SGRPROJ, cdf.use_sgrproj, 2);
    } else {
      se.symbol(t, cdf.restoration_type, 3);
    }
    if (t == RESTORE_WIENER) {
      if (n < 10) corrupt("record: Wiener taps");
      for (int pass = 0; pass < 2; pass++)
        for (int j = p ? 1 : 0; j < 3; j++) {
          int v = e[4 + 3 * pass + j];
          signed_subexp_with_ref(Wiener_Taps_Min[j], Wiener_Taps_Max[j] + 1,
                                 Wiener_Taps_K[j], ref_lr_wiener[p][pass][j],
                                 v);
          ref_lr_wiener[p][pass][j] = v;
        }
    } else if (t == RESTORE_SGRPROJ) {
      if (n < 7) corrupt("record: a self-guided unit");
      int set = e[4];
      if (set < 0 || set > 15) corrupt("record: a self-guided set");
      se.literal(set, 4);
      for (int i = 0; i < 2; i++) {
        int v = e[5 + i];
        if (Sgr_Params[set][i * 2])
          signed_subexp_with_ref(Sgrproj_Xqd_Min[i], Sgrproj_Xqd_Max[i] + 1,
                                 4, ref_sgr_xqd[p][i], v);
        ref_sgr_xqd[p][i] = v;
      }
    }
  }

  static int recenter_nonneg(int r, int v) {
    if (v > (r << 1)) return v;
    if (v >= r) return (v - r) << 1;
    return ((r - v) << 1) - 1;
  }

  void signed_subexp_with_ref(int low, int high, int k, int r, int v) {
    int mx = high - low, ref = r - low, x = v - low;
    if (x < 0 || x >= mx) corrupt("record: a restoration coefficient");
    int vv = (ref << 1) <= mx ? recenter_nonneg(ref, x)
                              : recenter_nonneg(mx - 1 - ref, mx - 1 - x);
    int i = 0, mk = 0;
    while (true) {
      int b2 = i ? k + i - 1 : k, a = 1 << b2;
      if (mx <= mk + 3 * a) {
        se.ns(mx - mk, vv - mk);
        return;
      }
      int more = vv >= mk + a;
      se.literal(more, 1);
      if (!more) {
        se.literal(vv - mk, b2);
        return;
      }
      i++;
      mk += a;
    }
  }

  // write_partition: at the frame's edges a split or not, on the CDF the
  // partitions it stands for add up to.
  void write_partition(int r, int c, int bsize) {
    if (r >= mi_rows || c >= mi_cols) return;
    int num4 = kNum4x4W[bsize], half = num4 >> 1, quarter = half >> 1;
    int has_rows = (r + half) < mi_rows, has_cols = (c + half) < mi_cols;
    int partition = PARTITION_NONE;
    if (bsize >= BLOCK_8X8) {
      size_t len;
      const int32_t* e = in.take(kRecPart, &len, 4);
      if (e[0] != r || e[1] != c || e[2] != bsize)
        corrupt("record: a partition out of place");
      partition = e[3];
      if (partition < 0 || partition > PARTITION_VERT_4)
        corrupt("record: a partition");
      int n;
      uint16_t* pc = partition_cdf(r, c, bsize, &n);
      if (has_rows && has_cols) {
        se.symbol(partition, pc, n);
      } else if (has_cols || has_rows) {
        if (partition != PARTITION_SPLIT &&
            partition != (has_cols ? PARTITION_HORZ : PARTITION_VERT))
          corrupt("record: a partition at the frame's edge");
        uint16_t bc[3];
        edge_split_cdf(pc, bsize, has_cols, bc);
        se.fixed(partition == PARTITION_SPLIT, bc, 2);
      } else if (partition != PARTITION_SPLIT) {
        corrupt("record: a partition at the frame's corner");
      }
    }
    int sub = partition_subsize(partition, bsize);
    int split = partition_subsize(PARTITION_SPLIT, bsize);
    if (sub == BLOCK_INVALID) corrupt("record: a partition");
    switch (partition) {
      case PARTITION_NONE: write_block(r, c, sub); break;
      case PARTITION_HORZ:
        write_block(r, c, sub);
        if (has_rows) write_block(r + half, c, sub);
        break;
      case PARTITION_VERT:
        write_block(r, c, sub);
        if (has_cols) write_block(r, c + half, sub);
        break;
      case PARTITION_SPLIT:
        write_partition(r, c, sub);
        write_partition(r, c + half, sub);
        write_partition(r + half, c, sub);
        write_partition(r + half, c + half, sub);
        break;
      case PARTITION_HORZ_A:
        write_block(r, c, split);
        write_block(r, c + half, split);
        write_block(r + half, c, sub);
        break;
      case PARTITION_HORZ_B:
        write_block(r, c, sub);
        write_block(r + half, c, split);
        write_block(r + half, c + half, split);
        break;
      case PARTITION_VERT_A:
        write_block(r, c, split);
        write_block(r + half, c, split);
        write_block(r, c + half, sub);
        break;
      case PARTITION_VERT_B:
        write_block(r, c, sub);
        write_block(r, c + half, split);
        write_block(r + half, c + half, split);
        break;
      case PARTITION_HORZ_4:
        for (int i = 0; i < 4; i++)
          if (i < 3 || r + quarter * 3 < mi_rows)
            write_block(r + quarter * i, c, sub);
        break;
      case PARTITION_VERT_4:
        for (int i = 0; i < 4; i++)
          if (i < 3 || c + quarter * 3 < mi_cols)
            write_block(r, c + quarter * i, sub);
        break;
    }
  }

  // write_modes_b: the mode info, the colour maps, the transform size,
  // then the coefficients.
  void write_block(int r, int c, int bsize) {
    blk = in.take(kRecBlock, &blk_len, kBFixed + 1);
    if (blk[kBRow] != r || blk[kBCol] != c || blk[kBSize] != bsize)
      corrupt("record: a block out of place");
    start_block(r, c, bsize);
    int bw4 = kNum4x4W[bsize], bh4 = kNum4x4H[bsize];
    if (has_chroma &&
        subsampled_size(bsize, seq.ssx, seq.ssy) == BLOCK_INVALID)
      corrupt("record: a block size for the subsampling");
    intra_frame_mode_info();
    palette_tokens();
    write_block_tx_size();
    if (skip) reset_block_context(bw4, bh4);
    store_block(y_mode, skip, mv[0], mv[1], pal_size_y, pal_size_uv, pal_y,
                pal_u);
    residual();
  }

  // write_mb_modes_kf.
  void intra_frame_mode_info() {
    skip = 0;
    if (seg_id_pre_skip) intra_segment_id();
    write_skip();
    if (!seg_id_pre_skip) intra_segment_id();
    write_cdef();
    write_delta_qindex();
    write_delta_lf();
    read_deltas = 0;
    use_intrabc = blk[kBIntrabc] != 0;
    if (use_intrabc && !allow_intrabc) corrupt("record: intra block copy");
    if (allow_intrabc) se.symbol(use_intrabc, cdf.intrabc, 2);
    is_inter = use_intrabc;
    mv[0] = mv[1] = 0;
    pal_size_y = pal_size_uv = 0;
    memset(pal_y, 0, sizeof(pal_y));
    memset(pal_u, 0, sizeof(pal_u));
    memset(pal_v, 0, sizeof(pal_v));
    use_filter_intra = 0;
    if (use_intrabc) {
      y_mode = uv_mode = DC_PRED;
      write_dv();
      return;
    }
    y_mode = blk[kBYMode];
    se.symbol(y_mode, y_mode_cdf(), 13);
    if (mi_size >= BLOCK_8X8 && y_mode >= V_PRED && y_mode <= D67_PRED)
      se.symbol(blk[kBAngleY] + 3, cdf.angle_delta[y_mode - V_PRED], 7);
    uv_mode = DC_PRED;
    if (has_chroma) {
      uv_mode = blk[kBUvMode];
      if (cfl_allowed())
        se.symbol(uv_mode, cdf.uv_cfl[y_mode], 14);
      else
        se.symbol(uv_mode, cdf.uv_nocfl[y_mode], 13);
      if (uv_mode == UV_CFL_PRED) write_cfl_alphas();
      if (mi_size >= BLOCK_8X8 && uv_mode >= V_PRED && uv_mode <= D67_PRED)
        se.symbol(blk[kBAngleUv] + 3, cdf.angle_delta[uv_mode - V_PRED], 7);
    }
    if (mi_size >= BLOCK_8X8 && 4 * kNum4x4W[mi_size] <= 64 &&
        4 * kNum4x4H[mi_size] <= 64 && allow_sct)
      palette_mode_info();
    else if (blk[kBPalY] || blk[kBPalUv])
      corrupt("record: a palette where none is allowed");
    if (seq.enable_filter_intra && y_mode == DC_PRED && pal_size_y == 0 &&
        imax(4 * kNum4x4W[mi_size], 4 * kNum4x4H[mi_size]) <= 32) {
      use_filter_intra = blk[kBFilterIntra] != 0;
      se.symbol(use_filter_intra, cdf.filter_intra[mi_size], 2);
      if (use_filter_intra) {
        filter_intra_mode = blk[kBFilterMode];
        se.symbol(filter_intra_mode, cdf.filter_intra_mode, 5);
      }
    }
  }

  // write_intra_segment_id, with av1_neg_interleave.
  void intra_segment_id() {
    if (seg_enabled) write_segment_id();
    else segment_id = 0;
    lossless = lossless_array[segment_id];
  }

  void write_segment_id() {
    int ctx, pred = segment_pred(&ctx);
    if (skip) {
      segment_id = pred;
      return;
    }
    segment_id = blk[kBSegment];
    int mx = last_active_seg_id + 1;
    if (segment_id < 0 || segment_id >= mx) corrupt("record: a segment");
    se.symbol(neg_interleave(segment_id, pred, mx), cdf.segment_id[ctx], 8);
  }

  static int neg_interleave(int x, int ref, int max) {
    int diff = x - ref;
    if (!ref) return x;
    if (ref >= max - 1) return -x + max - 1;
    if (2 * ref < max) {
      if (abs(diff) <= ref) return diff > 0 ? (diff << 1) - 1 : (-diff) << 1;
      return x;
    }
    if (abs(diff) < max - ref) return diff > 0 ? (diff << 1) - 1 : (-diff) << 1;
    return (max - x) - 1;
  }

  void write_skip() {
    if (seg_id_pre_skip && seg_feature_active(6)) {
      skip = 1;
      return;
    }
    skip = blk[kBSkip] != 0;
    se.symbol(skip, cdf.skip[skip_ctx()], 2);
  }

  // write_cdef: the strength of a 64x64 unit at its first block that is
  // not skipped.
  void write_cdef() {
    if (skip || coded_lossless || !seq.enable_cdef || allow_intrabc) return;
    int r = mi_row & ~15, c = mi_col & ~15;
    if (cdef_at(r, c) == -1) {
      int v = blk[kBCdef];
      if (v < 0 || v >= (1 << cdef_bits)) corrupt("record: a CDEF index");
      se.literal(v, cdef_bits);
      int w4 = kNum4x4W[mi_size], h4 = kNum4x4H[mi_size];
      for (int y = r; y < r + h4; y += 16)
        for (int x = c; x < c + w4; x += 16) cdef_at(y, x) = (int8_t)v;
    }
  }

  // write_delta_qindex and write_delta_lflevel: the reduced delta's
  // magnitude (DELTA_Q_SMALL and up in rem_bits), then its sign.
  void write_delta(uint16_t* c, int v) {
    int a = abs(v);
    se.symbol(imin(a, 3), c, 4);
    if (a >= 3) {
      int rem_bits = floor_log2((uint32_t)(a - 1));
      se.literal(rem_bits - 1, 3);
      se.literal(a - (1 << rem_bits) - 1, rem_bits);
    }
    if (a) se.literal(v < 0, 1);
  }

  void write_delta_qindex() {
    int sb = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_size == sb && skip) return;
    if (read_deltas) {
      int d = blk[kBQindex] - current_q;
      if (d % (1 << delta_q_res)) corrupt("record: a delta q");
      int red = d / (1 << delta_q_res);
      write_delta(cdf.delta_q, red);
      current_q = clip3(1, 255, current_q + (red << delta_q_res));
    }
  }

  void write_delta_lf() {
    int sb = seq.sb128 ? BLOCK_128X128 : BLOCK_64X64;
    if (mi_size == sb && skip) return;
    if (read_deltas && delta_lf_present) {
      int cnt = 1;
      if (delta_lf_multi) cnt = num_planes > 1 ? 4 : 2;
      for (int i = 0; i < cnt; i++) {
        uint16_t* c = delta_lf_multi ? cdf.delta_lf_multi[i] : cdf.delta_lf;
        int d = blk[kBDeltaLf + i] - delta_lf[i];
        if (d % (1 << delta_lf_res)) corrupt("record: a delta LF");
        int red = d / (1 << delta_lf_res);
        write_delta(c, red);
        delta_lf[i] = clip3(-63, 63, delta_lf[i] + red * (1 << delta_lf_res));
      }
    }
  }

  void write_cfl_alphas() {
    int au = blk[kBCflU], av = blk[kBCflV];
    int su = au == 0 ? 0 : au < 0 ? 1 : 2, sv = av == 0 ? 0 : av < 0 ? 1 : 2;
    if (!su && !sv) corrupt("record: CfL alphas both 0");
    se.symbol(su * 3 + sv - 1, cdf.cfl_sign, 8);
    if (su) se.symbol(abs(au) - 1, cdf.cfl_alpha[(su - 1) * 3 + sv], 16);
    if (sv) se.symbol(abs(av) - 1, cdf.cfl_alpha[(sv - 1) * 3 + su], 16);
  }

  // write_intrabc_info: av1_encode_dv of the vector against the stack's
  // reference (or the default one).
  void write_dv() {
    int pred[2];
    dv_ref(pred);
    mv[0] = blk[kBMv];
    mv[1] = blk[kBMv + 1];
    if ((mv[0] & 7) || (mv[1] & 7)) corrupt("record: a vector not whole");
    int diff[2] = {mv[0] - pred[0], mv[1] - pred[1]};
    int joint = (diff[0] != 0) * 2 + (diff[1] != 0);
    se.symbol(joint, cdf.mv_joint, 4);
    for (int comp = 0; comp < 2; comp++) {
      int v = diff[comp];
      if (!v) continue;
      int mag = abs(v), z = mag - 1;
      int cls = z >= 2 * 4096 ? 10 : (z >> 3) ? floor_log2((uint32_t)(z >> 3))
                                                : 0;
      int offset = z - (cls ? 2 << (cls + 2) : 0), d = offset >> 3;
      if (cls > 10 || (offset & 7) != 7) corrupt("record: a vector");
      se.symbol(v < 0, cdf.mv_sign[comp], 2);
      se.symbol(cls, cdf.mv_class[comp], 11);
      if (cls == 0) {
        se.symbol(d, cdf.mv_class0[comp], 2);
      } else {
        for (int i = 0; i < cls; i++)
          se.symbol((d >> i) & 1, cdf.mv_bits[comp][i], 2);
      }
    }
  }

  // --- Palette ----------------------------------------------------------

  // av1_index_color_cache's flags, then delta_encode_palette_colors of the
  // colours the cache does not hold.
  void write_palette_colors(int plane, const uint16_t* colors, int n,
                            int min_val) {
    uint16_t cache[16];
    int cn = get_palette_cache(plane, cache), found = 0;
    bool in_cache[8] = {false};
    for (int i = 0; i < cn && found < n; i++) {
      int hit = 0;
      for (int j = 0; j < n; j++)
        if (colors[j] == cache[i]) {
          in_cache[j] = true;
          hit = 1;
          break;
        }
      se.literal(hit, 1);
      found += hit;
    }
    int out[8], num = 0;
    for (int j = 0; j < n; j++)
      if (!in_cache[j]) out[num++] = colors[j];
    if (num <= 0) return;
    se.literal(out[0], 8);
    if (num == 1) return;
    int max_delta = 0, deltas[8];
    for (int i = 1; i < num; i++) {
      deltas[i - 1] = out[i] - out[i - 1];
      if (deltas[i - 1] < min_val) corrupt("record: palette colours");
      max_delta = imax(max_delta, deltas[i - 1]);
    }
    int bits = imax(ceil_log2(max_delta + 1 - min_val), 5);
    int range = 256 - out[0] - min_val;
    se.literal(bits - 5, 2);
    for (int i = 0; i < num - 1; i++) {
      se.literal(deltas[i] - min_val, bits);
      range -= deltas[i];
      bits = imin(bits, ceil_log2(range));
    }
  }

  void palette_mode_info() {
    int bsize_ctx = kMiWLog2[mi_size] + kMiHLog2[mi_size] - 2;
    int ny = blk[kBPalY], nuv = blk[kBPalUv];
    if (ny && y_mode != DC_PRED) corrupt("record: a palette");
    if (y_mode == DC_PRED) {
      se.symbol(ny > 0, cdf.pal_y_mode[bsize_ctx][palette_mode_ctx()], 2);
      if (ny) {
        pal_size_y = ny;
        se.symbol(ny - 2, cdf.pal_y_size[bsize_ctx], 7);
        for (int k = 0; k < ny; k++) pal_y[k] = (uint16_t)blk[kBPalColors + k];
        write_palette_colors(0, pal_y, ny, 1);
      }
    }
    if (nuv && (!has_chroma || uv_mode != DC_PRED))
      corrupt("record: a palette");
    if (has_chroma && uv_mode == DC_PRED) {
      int ctx = pal_size_y > 0;
      se.symbol(nuv > 0, cdf.pal_uv_mode[ctx], 2);
      if (nuv) {
        pal_size_uv = nuv;
        se.symbol(nuv - 2, cdf.pal_uv_size[bsize_ctx], 7);
        for (int k = 0; k < nuv; k++) {
          pal_u[k] = (uint16_t)blk[kBPalColors + 8 + k];
          pal_v[k] = (uint16_t)blk[kBPalColors + 16 + k];
        }
        write_palette_colors(1, pal_u, nuv, 0);
        // The V colours: deltas (av1_get_palette_delta_bits_v) where
        // libaom's rate rule finds them cheaper than raw values.
        int max_d = 0, zero_count = 0;
        for (int i = 1; i < nuv; i++) {
          int v = abs(pal_v[i] - pal_v[i - 1]), d = imin(v, 256 - v);
          max_d = imax(max_d, d);
          zero_count += d == 0;
        }
        int bits_v = imax(ceil_log2(max_d + 1), 4);
        int rate_delta = 2 + 8 + (bits_v + 1) * (nuv - 1) - zero_count;
        if (rate_delta < 8 * nuv) {
          se.literal(1, 1);
          se.literal(bits_v - 4, 2);
          se.literal(pal_v[0], 8);
          for (int i = 1; i < nuv; i++) {
            if (pal_v[i] == pal_v[i - 1]) {
              se.literal(0, bits_v);
              continue;
            }
            int delta = abs(pal_v[i] - pal_v[i - 1]);
            int sign = pal_v[i] < pal_v[i - 1];
            if (delta <= 256 - delta) {
              se.literal(delta, bits_v);
              se.literal(sign, 1);
            } else {
              se.literal(256 - delta, bits_v);
              se.literal(!sign, 1);
            }
          }
        } else {
          se.literal(0, 1);
          for (int i = 0; i < nuv; i++) se.literal(pal_v[i], 8);
        }
      }
    }
  }

  // av1_write_color_map: the first index, then the rest in wavefront
  // order, each as its rank among its neighbours' colours.
  void write_color_map(int plane, int n, int onw, int onh) {
    size_t len;
    const int32_t* e = in.take(kRecMap, &len, 3);
    if (e[0] != plane || e[1] != onw || e[2] != onh ||
        len != 3 + (size_t)onw * onh)
      corrupt("record: a colour map out of place");
    const int32_t* map = e + 3;
    for (int i = 0; i < onw * onh; i++)
      if (map[i] < 0 || map[i] >= n) corrupt("record: a colour index");
    se.ns(n, map[0]);
    int order[8];
    for (int i = 1; i < onh + onw - 1; i++)
      for (int j = imin(i, onw - 1); j >= imax(0, i - onh + 1); j--) {
        int ctx = color_context(map, onw, i - j, j, n, order);
        if (ctx == 255) corrupt("record: a palette colour context");
        int v = map[(i - j) * onw + j], s = 0;
        while (order[s] != v) s++;
        se.symbol(s, cdf.pal_color[plane][n - 2][ctx], n);
      }
  }

  void palette_tokens() {
    int bh = 4 * kNum4x4H[mi_size], bw = 4 * kNum4x4W[mi_size];
    int onh = imin(bh, (mi_rows - mi_row) * 4);
    int onw = imin(bw, (mi_cols - mi_col) * 4);
    if (pal_size_y) write_color_map(0, pal_size_y, onw, onh);
    if (pal_size_uv) {
      bh >>= seq.ssy;
      bw >>= seq.ssx;
      onh >>= seq.ssy;
      onw >>= seq.ssx;
      if (bw < 4) onw += 2;
      if (bh < 4) onh += 2;
      write_color_map(1, pal_size_uv, onw, onh);
    }
  }

  // --- Transform sizes --------------------------------------------------

  void write_block_tx_size() {
    int bw4 = kNum4x4W[mi_size], bh4 = kNum4x4H[mi_size];
    tx_size = blk[kBTxSize];
    if (tx_size < 0 || tx_size >= TX_SIZES_ALL)
      corrupt("record: a transform size");
    if (tx_mode_select && mi_size > BLOCK_4X4 && is_inter && !skip &&
        !lossless) {
      // write_tx_size_vartx: a split wherever the leaf is smaller.
      int nl = blk[kBFixed];
      if (nl < 1 || blk_len != kBFixed + 1 + 3 * (size_t)nl)
        corrupt("record: var-tx leaves");
      memset(leaf_tx, 255, sizeof(leaf_tx));
      for (int k = 0; k < nl; k++) {
        const int32_t* l = blk + kBFixed + 1 + 3 * k;
        int lr = l[0] - mi_row, lc = l[1] - mi_col, t = l[2];
        if (lr < 0 || lc < 0 || lr >= bh4 || lc >= bw4 || t < 0 ||
            t >= TX_SIZES_ALL)
          corrupt("record: a var-tx leaf");
        for (int i = 0; i < (kTxH[t] >> 2) && lr + i < 32; i++)
          for (int j = 0; j < (kTxW[t] >> 2) && lc + j < 32; j++)
            leaf_tx[lr + i][lc + j] = (uint8_t)t;
      }
      int max_tx = max_tx_rect(mi_size);
      int tw4 = kTxW[max_tx] >> 2, th4 = kTxH[max_tx] >> 2;
      for (int r = mi_row; r < mi_row + bh4; r += th4)
        for (int c = mi_col; c < mi_col + bw4; c += tw4)
          write_var_tx_size(r, c, max_tx, 0);
      return;
    }
    write_tx_size(!skip || !is_inter);
    for (int r = mi_row; r < imin(mi_rows, mi_row + bh4); r++)
      for (int c = mi_col; c < imin(mi_cols, mi_col + bw4); c++)
        tx_sizes[mi_index(r, c)] = (uint8_t)tx_size;
  }

  void write_var_tx_size(int row, int col, int txsz, int depth) {
    if (row >= mi_rows || col >= mi_cols) return;
    int split = 0;
    if (txsz != TX_4X4 && depth < 2) {
      split = leaf_tx[row - mi_row][col - mi_col] != txsz;
      se.symbol(split, cdf.txfm_split[var_tx_ctx(row, col, txsz)], 2);
    } else if (leaf_tx[row - mi_row][col - mi_col] != txsz) {
      corrupt("record: a var-tx leaf");
    }
    int w4 = kTxW[txsz] >> 2, h4 = kTxH[txsz] >> 2;
    if (split) {
      int sub = kSplitTx[txsz];
      int sw = kTxW[sub] >> 2, sh = kTxH[sub] >> 2;
      for (int i = 0; i < h4; i += sh)
        for (int j = 0; j < w4; j += sw)
          write_var_tx_size(row + i, col + j, sub, depth + 1);
      return;
    }
    for (int i = 0; i < h4 && row + i < mi_rows; i++)
      for (int j = 0; j < w4 && col + j < mi_cols; j++)
        tx_sizes[mi_index(row + i, col + j)] = (uint8_t)txsz;
    tx_size = txsz;
  }

  // write_selected_tx_size: the depth from the largest size.
  void write_tx_size(int allow_select) {
    if (lossless) {
      if (tx_size != TX_4X4) corrupt("record: a lossless transform size");
      return;
    }
    int max_rect = max_tx_rect(mi_size);
    if (mi_size > BLOCK_4X4 && allow_select && tx_mode_select) {
      int max_depth = kMaxTxDepth[mi_size], depth = 0, t = max_rect;
      while (t != tx_size && depth < imin(max_depth, 2)) {
        t = kSplitTx[t];
        depth++;
      }
      if (t != tx_size) corrupt("record: a transform size");
      int n;
      uint16_t* c = tx_depth_cdf(max_rect, &n);
      se.symbol(depth, c, n);
    } else if (tx_size != max_rect) {
      corrupt("record: a transform size");
    }
  }

  // --- Residual ---------------------------------------------------------

  void residual() {
    residual_blocks(tx_size, [&](int p, int bx, int by, int txsz, int x,
                                 int y) {
      transform_block(p, bx, by, txsz, x, y);
    });
  }

  void transform_block(int plane, int base_x, int base_y, int txsz, int x,
                       int y) {
    int start_x = base_x + 4 * x, start_y = base_y + 4 * y;
    int sx = plane ? seq.ssx : 0, sy = plane ? seq.ssy : 0;
    int max_x = (mi_cols * 4) >> sx, max_y = (mi_rows * 4) >> sy;
    if (start_x >= max_x || start_y >= max_y) return;
    if (!skip) write_coeffs(plane, start_x, start_y, txsz);
  }

  // --- Coefficients (av1_write_coeffs_txb) -------------------------------

  // av1_write_tx_type: the luma type in the block's transform set.
  void write_tx_type(int x4, int y4, int txsz, int t) {
    if (t < 0 || t > H_FLIPADST) corrupt("record: a transform type");
    int set = get_tx_set(txsz);
    int q = seg_enabled ? get_qindex(1, segment_id) : base_q_idx;
    int sqr = kTxSqr[txsz];
    if (set > 0 && q > 0 && is_inter) {
      if (set == 1)
        se.symbol(find(kTxInterInv1, 16, t), cdf.inter_set1[sqr], 16);
      else if (set == 2)
        se.symbol(find(kTxInterInv2, 12, t), cdf.inter_set2, 12);
      else if (t == DCT_DCT || t == IDTX)
        se.symbol(t == DCT_DCT, cdf.inter_set3[sqr], 2);
      else
        corrupt("record: a transform type outside its set");
    } else if (set > 0 && q > 0) {
      int dir = use_filter_intra ? kFilterIntraModeToDir[filter_intra_mode]
                                 : y_mode;
      if (set == 1) se.symbol(find(kTxInv1, 7, t), cdf.tx_set1[sqr][dir], 7);
      else se.symbol(find(kTxInv2, 5, t), cdf.tx_set2[sqr][dir], 5);
    } else if (t != DCT_DCT) {
      corrupt("record: a transform type where none is coded");
    }
    set_tx_type(x4, y4, txsz, t);
  }

  void write_coeffs(int plane, int sx0, int sy0, int txsz) {
    size_t len;
    const int32_t* e = in.take(kRecTxb, &len, 6);
    if (e[0] != plane || e[1] != sx0 || e[2] != sy0 || e[3] != txsz)
      corrupt("record: a transform block out of place");
    int n = e[5];
    const int32_t* lv = e + 6;
    int seg_eob = (txsz == TX_16X64 || txsz == TX_64X16)
                      ? 512
                      : imin(1024, kTxW[txsz] * kTxH[txsz]);
    if (n < 0 || n > seg_eob || len != 6 + (size_t)n)
      corrupt("record: a transform block's levels");
    int eob = n;
    while (eob > 0 && lv[eob - 1] == 0) eob--;
    int x4 = sx0 >> 2, y4 = sy0 >> 2;
    int ctx_sz = (kTxSqr[txsz] + kTxSqrUp[txsz] + 1) >> 1;
    int ptype = plane > 0;
    int cul = 0, dc_cat = 0;
    se.symbol(eob == 0,
              cdf.txb_skip[ctx_sz][txb_skip_ctx(plane, x4, y4, txsz)], 2);
    if (eob == 0) {
      if (plane == 0) set_tx_type(x4, y4, txsz, DCT_DCT);
    } else {
      if (plane == 0) write_tx_type(x4, y4, txsz, e[4]);
      plane_tx_type = compute_tx_type(plane, txsz, x4, y4);
      int cls = tx_class(plane_tx_type);
      const uint16_t* scan = get_scan(txsz);
      // av1_get_eob_pos_token: the class, then its extra bits.
      int eob_pt = eob <= 2 ? eob : floor_log2((uint32_t)(eob - 1)) + 2;
      int neob;
      uint16_t* eob_cdf = eob_pt_cdf(txsz, ptype, cls, &neob);
      se.symbol(eob_pt - 1, eob_cdf, neob);
      if (eob_pt >= 3) {
        int extra = eob - ((1 << (eob_pt - 2)) + 1);
        se.symbol((extra >> (eob_pt - 3)) & 1,
                  cdf.eob_extra[ctx_sz][ptype][eob_pt - 3], 2);
        for (int i = 1; i < eob_pt - 2; i++)
          se.literal((extra >> (eob_pt - 3 - i)) & 1, 1);
      }
      int adj = kAdjustedTx[txsz];
      int bwl = kTxWLog2[adj], txh = kTxH[adj];
      // The levels in reverse scan order, each context from the levels
      // coded before it (as the decoder has them then: at most 15).
      memset(quant, 0, sizeof(int32_t) * seg_eob);
      for (int c = eob - 1; c >= 0; c--) {
        int pos = scan[c], level = abs(lv[c]);
        if (c == eob - 1) {
          int cx = coeff_base_eob_ctx(c, bwl, txh);
          se.symbol(imin(level, 3) - 1, cdf.base_eob[ctx_sz][ptype][cx], 3);
        } else {
          int cx = coeff_base_ctx(txsz, bwl, txh, pos, cls);
          se.symbol(imin(level, 3), cdf.base[ctx_sz][ptype][cx], 4);
        }
        if (level > 2) {
          int bctx = coeff_br_ctx(bwl, txh, pos, cls);
          for (int idx = 0; idx < 12; idx += 3) {
            int k = imin(level - 3 - idx, 3);
            se.symbol(k, cdf.br[imin(ctx_sz, 3)][ptype][bctx], 4);
            if (k < 3) break;
          }
        }
        quant[pos] = imin(level, 15);
      }
      // The signs and Golomb remainders in scan order.
      for (int c = 0; c < eob; c++) {
        int pos = scan[c], level = abs(lv[c]), sign = lv[c] < 0;
        if (level) {
          if (c == 0)
            se.symbol(sign, cdf.dc_sign[ptype][dc_sign_ctx(plane, x4, y4,
                                                           txsz)], 2);
          else
            se.literal(sign, 1);
          if (level > 14) {  // write_golomb(level - 15)
            uint32_t x = (uint32_t)level - 14;
            int length = floor_log2(x) + 1;
            for (int i = 0; i < length - 1; i++) se.literal(0, 1);
            for (int i = length - 1; i >= 0; i--) se.literal((x >> i) & 1, 1);
          }
        }
        if (pos == 0 && level > 0) dc_cat = sign ? 1 : 2;
        cul += level & 0xfffff;
      }
      cul = imin(63, cul);
    }
    set_coeff_context(plane, x4, y4, txsz, cul, dc_cat);
  }
};

}  // namespace

extern "C" {

// One AV1 temporal unit written from its decision record (rec, n int32s;
// the layout in av1_syntax.inc): libaom's OBUs for a still frame. out gets
// the bytes (cap of them); returns their count (more than cap: nothing
// useful was written, call again with that much room), or kCorrupt /
// kUnsupported with the reason in msg (msg_cap bytes).
int64_t tb_av1_write(const int32_t* rec, int64_t n, uint8_t* out,
                     int64_t cap, char* msg, int64_t msg_cap) {
  Encoder* enc = new Encoder();
  enc->in.r = rec;
  enc->in.n = (size_t)n;
  int64_t rc;
  try {
    std::vector<uint8_t> bytes = enc->write();
    rc = (int64_t)bytes.size();
    if (rc <= cap) memcpy(out, bytes.data(), bytes.size());
  } catch (const Error& e) {
    rc = e.code;
    if (msg && msg_cap > 0) {
      strncpy(msg, e.what, (size_t)msg_cap - 1);
      msg[msg_cap - 1] = 0;
    }
  }
  delete enc;
  return rc;
}

}  // extern "C"
