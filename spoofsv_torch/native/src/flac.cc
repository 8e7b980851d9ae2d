// Native FLAC codec (decoder + encoder) for the staging pipeline.
//
// The reference stages the anti-spoofing corpus as 16 kHz FLAC via
// libsndfile (generate_test_utterances.py:246-255) and reads ASVspoof2019-LA
// dev FLACs. This image has no FLAC tooling (no soundfile/ffmpeg/sox), so
// libspoofkit carries its own codec:
//   * decoder: full subset used in practice — CONSTANT / VERBATIM / FIXED /
//     LPC subframes, rice residuals (both coding methods + escapes), wasted
//     bits, left/right/mid-side stereo decorrelation, UTF-8 frame numbers;
//   * encoder: fixed-predictor order-2 + rice (single partition) with a
//     verbatim fallback, fixed 4096-sample blocks, valid CRC-8/16.
// CRCs are generated on encode; decode does not verify them (robustness over
// strictness, same stance as libsndfile's default).

#include "common.h"

namespace spoofkit {

// ---------------------------------------------------------------------------
// Bit I/O (MSB-first)
// ---------------------------------------------------------------------------

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte = 0;
  int bit = 0;  // bits consumed of current byte
  bool overrun = false;

  uint64_t bits(int n) {
    uint64_t v = 0;
    for (int i = 0; i < n; ++i) {
      if (byte >= size) { overrun = true; return v << (n - i); }
      v = (v << 1) | ((data[byte] >> (7 - bit)) & 1);
      if (++bit == 8) { bit = 0; ++byte; }
    }
    return v;
  }

  int64_t sbits(int n) {
    uint64_t v = bits(n);
    if (n > 0 && (v >> (n - 1)) & 1) return (int64_t)(v | (~0ULL << n));
    return (int64_t)v;
  }

  uint32_t unary() {  // count of 0 bits before the terminating 1
    uint32_t q = 0;
    while (!overrun && bits(1) == 0) ++q;
    return q;
  }

  void align() { if (bit) { bit = 0; ++byte; } }
};

struct BitWriter {
  std::vector<uint8_t> out;
  uint8_t cur = 0;
  int nbits = 0;

  void bits(uint64_t v, int n) {
    for (int i = n - 1; i >= 0; --i) {
      cur = (uint8_t)((cur << 1) | ((v >> i) & 1));
      if (++nbits == 8) { out.push_back(cur); cur = 0; nbits = 0; }
    }
  }

  void align() { if (nbits) bits(0, 8 - nbits); }
};

// ---------------------------------------------------------------------------
// CRCs (frame header CRC-8 poly 0x07; frame CRC-16 poly 0x8005, init 0)
// ---------------------------------------------------------------------------

static uint8_t crc8(const uint8_t* d, size_t n) {
  uint8_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= d[i];
    for (int b = 0; b < 8; ++b) c = (uint8_t)((c & 0x80) ? (c << 1) ^ 0x07 : c << 1);
  }
  return c;
}

static uint16_t crc16(const uint8_t* d, size_t n) {
  uint16_t c = 0;
  for (size_t i = 0; i < n; ++i) {
    c ^= (uint16_t)d[i] << 8;
    for (int b = 0; b < 8; ++b)
      c = (uint16_t)((c & 0x8000) ? (c << 1) ^ 0x8005 : c << 1);
  }
  return c;
}

// ---------------------------------------------------------------------------
// Decoder
// ---------------------------------------------------------------------------

struct FlacInfo {
  int sample_rate = 0, channels = 0, bits = 0;
  int64_t total_samples = 0;   // per channel
  size_t audio_offset = 0;     // first frame byte offset
};

static bool flac_parse_header(const uint8_t* d, size_t n, FlacInfo* info) {
  if (n < 42 || std::memcmp(d, "fLaC", 4) != 0) return false;
  size_t p = 4;
  bool last = false;
  while (!last) {
    if (p + 4 > n) return false;
    last = d[p] & 0x80;
    int type = d[p] & 0x7F;
    size_t len = ((size_t)d[p + 1] << 16) | ((size_t)d[p + 2] << 8) | d[p + 3];
    p += 4;
    if (p + len > n) return false;
    if (type == 0) {  // STREAMINFO
      const uint8_t* s = d + p;
      info->sample_rate = ((int)s[10] << 12) | ((int)s[11] << 4) | (s[12] >> 4);
      info->channels = ((s[12] >> 1) & 0x7) + 1;
      info->bits = (((s[12] & 1) << 4) | (s[13] >> 4)) + 1;
      info->total_samples = ((int64_t)(s[13] & 0x0F) << 32) |
                            ((int64_t)s[14] << 24) | ((int64_t)s[15] << 16) |
                            ((int64_t)s[16] << 8) | s[17];
    }
    p += len;
  }
  info->audio_offset = p;
  return info->sample_rate > 0 && info->channels > 0;
}

static bool decode_subframe(BitReader* br, int blocksize, int bps,
                            std::vector<int64_t>* out) {
  if (br->bits(1) != 0) return false;      // zero pad bit
  int type = (int)br->bits(6);
  int wasted = 0;
  if (br->bits(1)) wasted = (int)br->unary() + 1;
  bps -= wasted;
  out->assign(blocksize, 0);

  auto residual = [&](int order) -> std::vector<int64_t> {
    std::vector<int64_t> r(blocksize - order);
    int method = (int)br->bits(2);
    int pbits = method == 0 ? 4 : 5;
    int escape = method == 0 ? 0xF : 0x1F;
    int porder = (int)br->bits(4);
    int npart = 1 << porder;
    size_t idx = 0;
    for (int part = 0; part < npart; ++part) {
      int count = (blocksize >> porder) - (part == 0 ? order : 0);
      int param = (int)br->bits(pbits);
      if (param == escape) {
        int raw = (int)br->bits(5);
        for (int i = 0; i < count; ++i) r[idx++] = br->sbits(raw);
      } else {
        for (int i = 0; i < count; ++i) {
          uint64_t q = br->unary();
          uint64_t lo = br->bits(param);
          uint64_t zz = (q << param) | lo;
          r[idx++] = (int64_t)(zz >> 1) ^ -(int64_t)(zz & 1);
        }
      }
    }
    return r;
  };

  if (type == 0) {                                   // CONSTANT
    int64_t v = br->sbits(bps);
    for (int i = 0; i < blocksize; ++i) (*out)[i] = v;
  } else if (type == 1) {                            // VERBATIM
    for (int i = 0; i < blocksize; ++i) (*out)[i] = br->sbits(bps);
  } else if (type >= 8 && type <= 12) {              // FIXED order 0-4
    int order = type - 8;
    for (int i = 0; i < order; ++i) (*out)[i] = br->sbits(bps);
    std::vector<int64_t> r = residual(order);
    for (int i = order; i < blocksize; ++i) {
      int64_t p = 0;
      int64_t* x = out->data();
      switch (order) {
        case 0: p = 0; break;
        case 1: p = x[i - 1]; break;
        case 2: p = 2 * x[i - 1] - x[i - 2]; break;
        case 3: p = 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3]; break;
        case 4: p = 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4]; break;
      }
      (*out)[i] = r[i - order] + p;
    }
  } else if (type >= 32) {                           // LPC, order = low5+1
    int order = (type & 0x1F) + 1;
    for (int i = 0; i < order; ++i) (*out)[i] = br->sbits(bps);
    int prec = (int)br->bits(4) + 1;
    int shift = (int)br->sbits(5);
    std::vector<int64_t> coef(order);
    for (int i = 0; i < order; ++i) coef[i] = br->sbits(prec);
    std::vector<int64_t> r = residual(order);
    for (int i = order; i < blocksize; ++i) {
      int64_t acc = 0;
      for (int j = 0; j < order; ++j) acc += coef[j] * (*out)[i - 1 - j];
      (*out)[i] = r[i - order] + (acc >> shift);
    }
  } else {
    return false;
  }
  if (wasted)
    for (int i = 0; i < blocksize; ++i) (*out)[i] <<= wasted;
  return !br->overrun;
}

// Decode an entire file buffer → interleaved int32 samples.
// Returns samples-per-channel, or -1 on error.
int64_t flac_decode_buffer(const uint8_t* d, size_t n, FlacInfo* info,
                           std::vector<int32_t>* pcm) {
  if (!flac_parse_header(d, n, info)) return -1;
  BitReader br{d, n};
  br.byte = info->audio_offset;
  pcm->clear();
  if (info->total_samples > 0)
    pcm->reserve((size_t)info->total_samples * info->channels);
  int64_t done = 0;
  static const int kRates[] = {0,     88200, 176400, 192000, 8000, 16000,
                               22050, 24000, 32000,  44100,  48000, 96000};
  while (br.byte + 2 < n && !br.overrun) {
    if ((uint32_t)br.bits(14) != 0x3FFE) return -1;  // sync
    br.bits(1);                                      // reserved
    br.bits(1);                                      // blocking strategy
    int bs_code = (int)br.bits(4);
    int sr_code = (int)br.bits(4);
    int ch_asgn = (int)br.bits(4);
    int ss_code = (int)br.bits(3);
    br.bits(1);                                      // reserved
    // UTF-8 coded frame/sample number
    uint64_t first = br.bits(8);
    int extra = 0;
    for (uint64_t m = 0x80; first & m; m >>= 1) ++extra;
    if (extra) --extra;
    for (int i = 0; i < extra; ++i) br.bits(8);
    int blocksize;
    if (bs_code == 1) blocksize = 192;
    else if (bs_code >= 2 && bs_code <= 5) blocksize = 576 << (bs_code - 2);
    else if (bs_code == 6) blocksize = (int)br.bits(8) + 1;
    else if (bs_code == 7) blocksize = (int)br.bits(16) + 1;
    else if (bs_code >= 8) blocksize = 256 << (bs_code - 8);
    else return -1;
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    (void)kRates;
    int bps = info->bits;
    static const int kBits[] = {0, 8, 12, 0, 16, 20, 24, 32};
    if (ss_code != 0 && kBits[ss_code]) bps = kBits[ss_code];
    br.bits(8);                                      // header CRC-8
    int nch = info->channels;
    int stereo_mode = 0;                             // 0=indep,1=LS,2=RS,3=MS
    if (ch_asgn >= 8 && ch_asgn <= 10) { nch = 2; stereo_mode = ch_asgn - 7; }
    else nch = ch_asgn + 1;
    std::vector<std::vector<int64_t>> chan(nch);
    for (int c = 0; c < nch; ++c) {
      int b = bps;
      if ((stereo_mode == 1 && c == 1) || (stereo_mode == 2 && c == 0) ||
          (stereo_mode == 3 && c == 1))
        b += 1;                                      // side channel
      if (!decode_subframe(&br, blocksize, b, &chan[c])) return -1;
    }
    br.align();
    br.bits(16);                                     // frame CRC-16
    if (br.overrun) return -1;
    // undo stereo decorrelation
    if (stereo_mode == 1) {        // left/side: right = left - side
      for (int i = 0; i < blocksize; ++i) chan[1][i] = chan[0][i] - chan[1][i];
    } else if (stereo_mode == 2) { // side/right: left = right + side
      for (int i = 0; i < blocksize; ++i) chan[0][i] = chan[1][i] + chan[0][i];
    } else if (stereo_mode == 3) { // mid/side
      for (int i = 0; i < blocksize; ++i) {
        int64_t side = chan[1][i];
        int64_t mid = (chan[0][i] << 1) | (side & 1);
        chan[0][i] = (mid + side) >> 1;
        chan[1][i] = (mid - side) >> 1;
      }
    }
    for (int i = 0; i < blocksize; ++i)
      for (int c = 0; c < nch; ++c) pcm->push_back((int32_t)chan[c][i]);
    done += blocksize;
    if (info->total_samples > 0 && done >= info->total_samples) break;
  }
  return done;
}

// ---------------------------------------------------------------------------
// Encoder: fixed-order-2 + rice (single partition), verbatim fallback
// ---------------------------------------------------------------------------

static void write_utf8_number(BitWriter* bw, uint64_t v) {
  if (v < 0x80) { bw->bits(v, 8); return; }
  int nbytes = v < 0x800 ? 2 : v < 0x10000 ? 3 : v < 0x200000 ? 4 :
               v < 0x4000000 ? 5 : 6;
  static const uint8_t lead[] = {0, 0, 0xC0, 0xE0, 0xF0, 0xF8, 0xFC};
  bw->bits(lead[nbytes] | (v >> (6 * (nbytes - 1))), 8);
  for (int i = nbytes - 2; i >= 0; --i)
    bw->bits(0x80 | ((v >> (6 * i)) & 0x3F), 8);
}

static int best_rice_param(const std::vector<int64_t>& res) {
  uint64_t acc = 0;
  for (int64_t r : res) acc += (uint64_t)(r < 0 ? -(r + 1) * 2 + 1 : r * 2);
  if (res.empty()) return 0;
  double mean = (double)acc / res.size();
  int p = 0;
  while ((1ULL << (p + 1)) < mean + 1 && p < 14) ++p;
  return p;
}

void flac_encode(const int32_t* pcm, int64_t n_per_ch, int channels,
                 int sample_rate, int bits, std::vector<uint8_t>* out) {
  const int BS = 4096;
  out->clear();
  out->insert(out->end(), {'f', 'L', 'a', 'C'});
  // STREAMINFO (last metadata block), 34 bytes
  BitWriter m;
  m.bits(1, 1); m.bits(0, 7); m.bits(34, 24);
  m.bits(BS, 16); m.bits(BS, 16);
  m.bits(0, 24); m.bits(0, 24);                      // min/max frame size unknown
  m.bits(sample_rate, 20);
  m.bits(channels - 1, 3);
  m.bits(bits - 1, 5);
  m.bits((uint64_t)n_per_ch, 36);
  for (int i = 0; i < 16; ++i) m.bits(0, 8);          // md5 unset
  m.align();
  out->insert(out->end(), m.out.begin(), m.out.end());

  static const int kRates[] = {0,     88200, 176400, 192000, 8000, 16000,
                               22050, 24000, 32000,  44100,  48000, 96000};
  int sr_code = 13;
  for (int i = 1; i < 12; ++i)
    if (kRates[i] == sample_rate) { sr_code = i; break; }
  // frame-header sample-size code (must match the subframe bit width)
  int ss_code;
  switch (bits) {
    case 8: ss_code = 1; break;
    case 12: ss_code = 2; break;
    case 16: ss_code = 4; break;
    case 20: ss_code = 5; break;
    case 24: ss_code = 6; break;
    default: out->clear(); return;   // unsupported width → caller errors
  }

  int64_t pos = 0;
  uint64_t frame_no = 0;
  while (pos < n_per_ch) {
    int blocksize = (int)std::min<int64_t>(BS, n_per_ch - pos);
    BitWriter f;
    f.bits(0x3FFE, 14); f.bits(0, 1); f.bits(0, 1);   // sync, res, fixed-bs
    f.bits(7, 4);                                     // blocksize: 16-bit field
    f.bits(sr_code, 4);
    f.bits(channels - 1, 4);                          // independent channels
    f.bits(ss_code, 3);
    f.bits(0, 1);
    write_utf8_number(&f, frame_no++);
    f.bits(blocksize - 1, 16);
    if (sr_code == 13) f.bits(sample_rate, 16);
    f.align();
    f.bits(crc8(f.out.data(), f.out.size()), 8);

    for (int c = 0; c < channels; ++c) {
      std::vector<int64_t> x(blocksize);
      for (int i = 0; i < blocksize; ++i)
        x[i] = pcm[(pos + i) * channels + c];
      // fixed order-2 residual
      std::vector<int64_t> res;
      if (blocksize > 2) {
        res.resize(blocksize - 2);
        for (int i = 2; i < blocksize; ++i)
          res[i - 2] = x[i] - 2 * x[i - 1] + x[i - 2];
      }
      int param = best_rice_param(res);
      uint64_t rice_cost = 0;
      for (int64_t r : res) {
        uint64_t zz = (uint64_t)(r < 0 ? -(r + 1) * 2 + 1 : r * 2);
        rice_cost += (zz >> param) + 1 + param;
      }
      bool verbatim = blocksize <= 2 || param >= 15 ||
                      rice_cost > (uint64_t)blocksize * bits;
      if (verbatim) {
        f.bits(0, 1); f.bits(1, 6); f.bits(0, 1);     // VERBATIM
        for (int i = 0; i < blocksize; ++i)
          f.bits((uint64_t)(x[i] & ((1ULL << bits) - 1)), bits);
      } else {
        f.bits(0, 1); f.bits(8 + 2, 6); f.bits(0, 1); // FIXED order 2
        for (int i = 0; i < 2; ++i)
          f.bits((uint64_t)(x[i] & ((1ULL << bits) - 1)), bits);
        f.bits(0, 2);                                 // 4-bit rice params
        f.bits(0, 4);                                 // partition order 0
        f.bits(param, 4);
        for (int64_t r : res) {
          uint64_t zz = (uint64_t)(r < 0 ? -(r + 1) * 2 + 1 : r * 2);
          uint64_t q = zz >> param;
          for (uint64_t i = 0; i < q; ++i) f.bits(0, 1);
          f.bits(1, 1);
          f.bits(zz & ((1ULL << param) - 1), param);
        }
      }
    }
    f.align();
    f.bits(crc16(f.out.data(), f.out.size()), 16);
    out->insert(out->end(), f.out.begin(), f.out.end());
    pos += blocksize;
  }
}

}  // namespace spoofkit
