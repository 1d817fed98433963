// Native FLAC decoder for the cpc2_torch data loader (a copy of the JAX
// package's `csrc/flacdec.cc`).
//
// The reference framework decodes its (LibriSpeech-style) .flac corpora
// through torchaudio/sox's C++ backends (`cpc/dataset.py:425`); this is the
// equivalent native component here, exposed to Python via ctypes
// (`cpc2_torch/data/audio_io.py`).
//
// Supports the FLAC subset relevant to speech corpora (and everything the
// format commonly uses): STREAMINFO parsing, frames with independent /
// left-side / right-side / mid-side channel assignment, constant / verbatim /
// fixed(0-4) / LPC(1-32) subframes, wasted bits, Rice residual partitions
// (methods 0 and 1) with escape codes, UTF-8 coded frame numbers.
//
// Built with g++ at first use into build/cpc2_torch_kernels/libflacdec.so
// (`cpc2_torch/ops/_build.py:build_host`).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

struct BitReader {
  const uint8_t* data;
  size_t size;
  size_t byte_pos = 0;
  int bit_pos = 0;  // bits consumed in current byte (0..7)
  bool error = false;

  BitReader(const uint8_t* d, size_t n) : data(d), size(n) {}

  bool eof() const { return byte_pos >= size; }

  inline uint32_t read_bit() {
    if (byte_pos >= size) { error = true; return 0; }
    uint32_t bit = (data[byte_pos] >> (7 - bit_pos)) & 1u;
    if (++bit_pos == 8) { bit_pos = 0; ++byte_pos; }
    return bit;
  }

  inline uint64_t read_bits(int n) {
    uint64_t v = 0;
    while (n > 0) {
      if (byte_pos >= size) { error = true; return v; }
      int avail = 8 - bit_pos;
      int take = n < avail ? n : avail;
      uint32_t chunk = (data[byte_pos] >> (avail - take)) &
                       ((1u << take) - 1u);
      v = (v << take) | chunk;
      bit_pos += take;
      if (bit_pos == 8) { bit_pos = 0; ++byte_pos; }
      n -= take;
    }
    return v;
  }

  inline int64_t read_signed(int n) {
    uint64_t v = read_bits(n);
    if (n > 0 && (v >> (n - 1)) & 1u)
      return (int64_t)(v | (~0ULL << n));
    return (int64_t)v;
  }

  inline uint32_t read_unary() {
    uint32_t q = 0;
    // fast path: skip zero bytes bitwise
    while (!error) {
      if (byte_pos >= size) { error = true; return q; }
      uint8_t cur = (uint8_t)(data[byte_pos] << bit_pos);
      if (cur == 0) {
        q += 8 - bit_pos;
        bit_pos = 0;
        ++byte_pos;
        continue;
      }
      // count leading zeros in remaining bits of this byte
      int lz = 0;
      while (!((cur >> (7 - lz)) & 1)) ++lz;
      q += lz;
      bit_pos += lz + 1;  // consume zeros + the terminating 1
      if (bit_pos >= 8) { bit_pos -= 8; ++byte_pos; }
      return q;
    }
    return q;
  }

  void align() {
    if (bit_pos != 0) { bit_pos = 0; ++byte_pos; }
  }
};

struct StreamInfo {
  uint32_t min_block = 0, max_block = 0;
  uint32_t sample_rate = 0;
  int channels = 0;
  int bits_per_sample = 0;
  uint64_t total_samples = 0;
  bool valid = false;
};

const int kFixedOrders[5][4] = {
    {0, 0, 0, 0},
    {1, 0, 0, 0},
    {2, -1, 0, 0},
    {3, -3, 1, 0},
    {4, -6, 4, -1},
};

// Decode a UTF-8-style coded number (frame/sample index).
bool read_utf8(BitReader& br, uint64_t* out) {
  uint32_t b0 = (uint32_t)br.read_bits(8);
  if (br.error) return false;
  int extra;
  uint64_t v;
  if ((b0 & 0x80) == 0) { *out = b0; return true; }
  else if ((b0 & 0xE0) == 0xC0) { extra = 1; v = b0 & 0x1F; }
  else if ((b0 & 0xF0) == 0xE0) { extra = 2; v = b0 & 0x0F; }
  else if ((b0 & 0xF8) == 0xF0) { extra = 3; v = b0 & 0x07; }
  else if ((b0 & 0xFC) == 0xF8) { extra = 4; v = b0 & 0x03; }
  else if ((b0 & 0xFE) == 0xFC) { extra = 5; v = b0 & 0x01; }
  else if (b0 == 0xFE) { extra = 6; v = 0; }
  else return false;
  for (int i = 0; i < extra; ++i) {
    uint32_t b = (uint32_t)br.read_bits(8);
    if (br.error || (b & 0xC0) != 0x80) return false;
    v = (v << 6) | (b & 0x3F);
  }
  *out = v;
  return true;
}

bool decode_residual(BitReader& br, int pred_order, uint32_t block_size,
                     int32_t* out /* block_size entries, first pred_order
                                     already filled */) {
  uint32_t method = (uint32_t)br.read_bits(2);
  if (method > 1 || br.error) return false;
  int param_bits = method == 0 ? 4 : 5;
  uint32_t escape = method == 0 ? 0xF : 0x1F;
  uint32_t partition_order = (uint32_t)br.read_bits(4);
  uint32_t partitions = 1u << partition_order;
  if (block_size % partitions != 0) return false;
  uint32_t part_len = block_size >> partition_order;
  if (part_len <= (uint32_t)pred_order && partitions == 1) return false;

  uint32_t idx = pred_order;
  for (uint32_t p = 0; p < partitions; ++p) {
    uint32_t count = part_len - (p == 0 ? pred_order : 0);
    uint32_t param = (uint32_t)br.read_bits(param_bits);
    if (br.error) return false;
    if (param == escape) {
      int raw_bits = (int)br.read_bits(5);
      for (uint32_t i = 0; i < count; ++i)
        out[idx++] = (int32_t)br.read_signed(raw_bits);
    } else {
      for (uint32_t i = 0; i < count; ++i) {
        uint32_t q = br.read_unary();
        uint32_t r = param ? (uint32_t)br.read_bits(param) : 0;
        uint32_t u = (q << param) | r;
        out[idx++] = (int32_t)(u >> 1) ^ -(int32_t)(u & 1);
      }
    }
    if (br.error) return false;
  }
  return idx == block_size;
}

bool decode_subframe(BitReader& br, uint32_t block_size, int bps,
                     int32_t* out) {
  if (br.read_bit() != 0) return false;  // reserved
  uint32_t type = (uint32_t)br.read_bits(6);
  uint32_t wasted = 0;
  if (br.read_bit()) {  // wasted bits flag
    wasted = 1 + br.read_unary();
  }
  if (br.error) return false;
  bps -= (int)wasted;

  if (type == 0) {  // CONSTANT
    int64_t v = br.read_signed(bps);
    for (uint32_t i = 0; i < block_size; ++i) out[i] = (int32_t)v;
  } else if (type == 1) {  // VERBATIM
    for (uint32_t i = 0; i < block_size; ++i)
      out[i] = (int32_t)br.read_signed(bps);
  } else if ((type & 0x38) == 0x08 && (type & 0x07) <= 4) {  // FIXED
    int order = type & 0x07;
    for (int i = 0; i < order; ++i)
      out[i] = (int32_t)br.read_signed(bps);
    if (!decode_residual(br, order, block_size, out)) return false;
    // reconstruct: residual stored in out[order..]
    for (uint32_t i = order; i < block_size; ++i) {
      int64_t pred = 0;
      const int* c = kFixedOrders[order];
      for (int j = 0; j < order; ++j) pred += (int64_t)c[j] * out[i - 1 - j];
      out[i] = (int32_t)(out[i] + pred);
    }
  } else if (type & 0x20) {  // LPC
    int order = (int)(type & 0x1F) + 1;
    for (int i = 0; i < order; ++i)
      out[i] = (int32_t)br.read_signed(bps);
    int precision = (int)br.read_bits(4) + 1;
    if (precision == 16) return false;  // 1111 invalid
    int shift = (int)br.read_signed(5);
    if (shift < 0) return false;
    int32_t coefs[32];
    for (int i = 0; i < order; ++i)
      coefs[i] = (int32_t)br.read_signed(precision);
    if (!decode_residual(br, order, block_size, out)) return false;
    for (uint32_t i = order; i < block_size; ++i) {
      int64_t pred = 0;
      for (int j = 0; j < order; ++j)
        pred += (int64_t)coefs[j] * out[i - 1 - j];
      out[i] = (int32_t)(out[i] + (pred >> shift));
    }
  } else {
    return false;
  }
  if (wasted) {
    for (uint32_t i = 0; i < block_size; ++i)
      out[i] = (int32_t)((uint32_t)out[i] << wasted);
  }
  return !br.error;
}

struct FrameInfo {
  uint32_t block_size;
  uint32_t sample_rate;
  int channels;
  int channel_assignment;  // 0..7 independent, 8 L/S, 9 R/S, 10 M/S
  int bps;
};

bool read_frame_header(BitReader& br, const StreamInfo& si, FrameInfo* fi) {
  uint32_t sync = (uint32_t)br.read_bits(14);
  if (br.error || sync != 0x3FFE) return false;
  br.read_bit();                       // reserved
  br.read_bit();                       // blocking strategy
  uint32_t bs_code = (uint32_t)br.read_bits(4);
  uint32_t sr_code = (uint32_t)br.read_bits(4);
  uint32_t ch_code = (uint32_t)br.read_bits(4);
  uint32_t ss_code = (uint32_t)br.read_bits(3);
  br.read_bit();                       // reserved
  uint64_t coded_number;
  if (!read_utf8(br, &coded_number)) return false;

  uint32_t block_size;
  switch (bs_code) {
    case 0: return false;
    case 1: block_size = 192; break;
    case 6: block_size = (uint32_t)br.read_bits(8) + 1; break;
    case 7: block_size = (uint32_t)br.read_bits(16) + 1; break;
    default:
      if (bs_code <= 5) block_size = 576u << (bs_code - 2);
      else block_size = 256u << (bs_code - 8);
  }

  uint32_t sample_rate = si.sample_rate;
  switch (sr_code) {
    case 0: break;  // from streaminfo
    case 1: sample_rate = 88200; break;
    case 2: sample_rate = 176400; break;
    case 3: sample_rate = 192000; break;
    case 4: sample_rate = 8000; break;
    case 5: sample_rate = 16000; break;
    case 6: sample_rate = 22050; break;
    case 7: sample_rate = 24000; break;
    case 8: sample_rate = 32000; break;
    case 9: sample_rate = 44100; break;
    case 10: sample_rate = 48000; break;
    case 11: sample_rate = 96000; break;
    case 12: sample_rate = (uint32_t)br.read_bits(8) * 1000; break;
    case 13: sample_rate = (uint32_t)br.read_bits(16); break;
    case 14: sample_rate = (uint32_t)br.read_bits(16) * 10; break;
    default: return false;
  }

  int channels, assignment = (int)ch_code;
  if (ch_code < 8) channels = (int)ch_code + 1;
  else if (ch_code <= 10) channels = 2;
  else return false;

  int bps;
  switch (ss_code) {
    case 0: bps = si.bits_per_sample; break;
    case 1: bps = 8; break;
    case 2: bps = 12; break;
    case 4: bps = 16; break;
    case 5: bps = 20; break;
    case 6: bps = 24; break;
    case 7: bps = 32; break;
    default: return false;
  }

  br.read_bits(8);  // CRC-8 (not verified; bitstream errors surface anyway)
  if (br.error) return false;
  fi->block_size = block_size;
  fi->sample_rate = sample_rate;
  fi->channels = channels;
  fi->channel_assignment = assignment;
  fi->bps = bps;
  return true;
}

// Returns number of frames decoded, or -1 on error. When `out` is null only
// counts samples. `out` is interleaved float32.
int64_t decode_stream(const uint8_t* data, size_t size, float* out,
                      int64_t capacity, int* sample_rate, int* channels,
                      int64_t* total_out) {
  if (size < 8 || memcmp(data, "fLaC", 4) != 0) return -1;
  BitReader br(data, size);
  br.byte_pos = 4;

  StreamInfo si;
  // metadata blocks
  bool last = false;
  while (!last) {
    last = br.read_bit() != 0;
    uint32_t type = (uint32_t)br.read_bits(7);
    uint32_t len = (uint32_t)br.read_bits(24);
    if (br.error) return -1;
    if (type == 0) {  // STREAMINFO
      si.min_block = (uint32_t)br.read_bits(16);
      si.max_block = (uint32_t)br.read_bits(16);
      br.read_bits(24);  // min frame size
      br.read_bits(24);  // max frame size
      si.sample_rate = (uint32_t)br.read_bits(20);
      si.channels = (int)br.read_bits(3) + 1;
      si.bits_per_sample = (int)br.read_bits(5) + 1;
      si.total_samples = br.read_bits(36);
      br.read_bits(64);  // MD5 (16 bytes) part 1
      br.read_bits(64);  // MD5 part 2
      si.valid = true;
    } else {
      br.byte_pos += len;
      if (br.byte_pos > size) return -1;
    }
  }
  if (!si.valid) return -1;
  *sample_rate = (int)si.sample_rate;
  *channels = si.channels;

  std::vector<std::vector<int64_t>> chan(si.channels);
  std::vector<int32_t> buf;
  int64_t written = 0;
  int64_t frames = 0;
  double scale = 1.0 / (double)(1ULL << (si.bits_per_sample - 1));

  while (true) {
    br.align();
    // skip trailing padding / detect EOF
    if (br.byte_pos >= size) break;
    FrameInfo fi;
    size_t frame_start = br.byte_pos;
    if (!read_frame_header(br, si, &fi)) {
      if (frames > 0 && br.byte_pos >= size) break;
      // tolerate trailing garbage after at least one frame
      if (frames > 0) break;
      return -1;
    }
    (void)frame_start;

    std::vector<std::vector<int32_t>> sub(fi.channels);
    for (int c = 0; c < fi.channels; ++c) {
      int bps = fi.bps;
      // side channels carry one extra bit
      if ((fi.channel_assignment == 8 && c == 1) ||
          (fi.channel_assignment == 9 && c == 0) ||
          (fi.channel_assignment == 10 && c == 1))
        bps += 1;
      sub[c].resize(fi.block_size);
      if (!decode_subframe(br, fi.block_size, bps, sub[c].data()))
        return frames > 0 ? written / fi.channels : -1;
    }
    br.align();
    br.read_bits(16);  // frame CRC-16
    if (br.error && frames == 0) return -1;

    // stereo decorrelation
    if (fi.channel_assignment == 8) {        // left/side
      for (uint32_t i = 0; i < fi.block_size; ++i)
        sub[1][i] = sub[0][i] - sub[1][i];
    } else if (fi.channel_assignment == 9) { // right/side: left = side+right
      for (uint32_t i = 0; i < fi.block_size; ++i)
        sub[0][i] = sub[0][i] + sub[1][i];
    } else if (fi.channel_assignment == 10) { // mid/side
      for (uint32_t i = 0; i < fi.block_size; ++i) {
        int64_t mid = sub[0][i];
        int64_t side = sub[1][i];
        mid = (mid << 1) | (side & 1);
        sub[0][i] = (int32_t)((mid + side) >> 1);
        sub[1][i] = (int32_t)((mid - side) >> 1);
      }
    }

    if (out != nullptr) {
      for (uint32_t i = 0; i < fi.block_size; ++i) {
        for (int c = 0; c < fi.channels; ++c) {
          if (written >= capacity) return -3;  // buffer too small
          out[written++] = (float)(sub[c][i] * scale);
        }
      }
    } else {
      written += (int64_t)fi.block_size * fi.channels;
    }
    ++frames;
    if (si.total_samples > 0 &&
        (uint64_t)(written / fi.channels) >= si.total_samples)
      break;
  }
  *total_out = written / (si.channels ? si.channels : 1);
  return frames;
}

std::vector<uint8_t> read_file(const char* path) {
  std::vector<uint8_t> buf;
  FILE* f = fopen(path, "rb");
  if (!f) return buf;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  fseek(f, 0, SEEK_SET);
  buf.resize((size_t)n);
  if (n > 0 && fread(buf.data(), 1, (size_t)n, f) != (size_t)n) buf.clear();
  fclose(f);
  return buf;
}

}  // namespace

extern "C" {

// Returns total samples per channel (from STREAMINFO, or by counting);
// fills sample_rate and channels. Negative on error.
long long flac_info_file(const char* path, int* sample_rate, int* channels) {
  std::vector<uint8_t> buf = read_file(path);
  if (buf.empty()) return -1;
  // Fast path: STREAMINFO total_samples
  if (buf.size() > 42 && memcmp(buf.data(), "fLaC", 4) == 0) {
    BitReader br(buf.data(), buf.size());
    br.byte_pos = 4;
    br.read_bit();
    uint32_t type = (uint32_t)br.read_bits(7);
    br.read_bits(24);
    if (type == 0) {
      br.read_bits(16); br.read_bits(16);
      br.read_bits(24); br.read_bits(24);
      *sample_rate = (int)br.read_bits(20);
      *channels = (int)br.read_bits(3) + 1;
      br.read_bits(5);
      uint64_t total = br.read_bits(36);
      if (total > 0) return (long long)total;
    }
  }
  int64_t total = 0;
  int sr = 0, ch = 0;
  int64_t frames = decode_stream(buf.data(), buf.size(), nullptr, 0, &sr,
                                 &ch, &total);
  if (frames < 0) return -2;
  *sample_rate = sr;
  *channels = ch;
  return (long long)total;
}

// Decodes into out (interleaved float32, capacity floats). Returns samples
// per channel, or negative on error (-3: capacity too small).
long long flac_decode_file(const char* path, float* out, long long capacity,
                           int* sample_rate, int* channels) {
  std::vector<uint8_t> buf = read_file(path);
  if (buf.empty()) return -1;
  int64_t total = 0;
  int64_t frames = decode_stream(buf.data(), buf.size(), out, capacity,
                                 sample_rate, channels, &total);
  if (frames < 0) return frames;
  return (long long)total;
}

}  // extern "C"
