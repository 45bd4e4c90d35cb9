// Huffman entropy decoder of baseline and extended-sequential JPEG scans
// (host code, used by `utils/imageio.decode_jpeg`): the entropy-coded
// segment of one scan -> the quantized DCT coefficients of its blocks, in
// natural (row-major) order. Everything after this step (dequantization,
// the integer IDCT, chroma upsampling, colour conversion) runs vectorized
// in numpy; only this bit-serial loop is native.
//
// Built by g++ at first use (`utils/native.py`) and called through ctypes.
// Follows ITU T.81 F.2.2: byte stuffing (FF 00), restart markers every
// `restart_interval` MCUs (the DC predictions reset, the bit buffer is
// discarded), interleaved scans (an MCU holds h x v blocks of each
// component) and single-component scans (an MCU is one block, over the
// component's own ceil(w/8) x ceil(h/8) blocks). At a marker or past the
// end the reader feeds zero bits, as libjpeg does.

#include <cstdint>
#include <cstring>

namespace {

const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // a corrupt run past 63 lands on the last coefficient, as in libjpeg
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

const int kLookBits = 9;

struct Table {
  // lookup of the next kLookBits bits: code length (0: longer code) and
  // symbol
  uint8_t look_len[1 << kLookBits];
  uint8_t look_sym[1 << kLookBits];
  int32_t maxcode[18];  // largest code of each length, -1 if none
  int32_t valoff[18];   // index into vals of the first code of a length
  uint8_t vals[256];
};

// Canonical code assignment (T.81 C.2); returns false for a table whose
// counts overflow the code space.
bool build_table(const uint8_t* bits, const uint8_t* vals, Table* t) {
  std::memset(t, 0, sizeof(Table));
  std::memcpy(t->vals, vals, 256);
  int code = 0, k = 0;
  for (int len = 1; len <= 16; ++len) {
    int n = bits[len - 1];
    if (k + n > 256) return false;
    t->valoff[len] = k - code;
    if (n) {
      if (code + n > (1 << len)) return false;
      for (int i = 0; i < n; ++i) {
        if (len <= kLookBits) {
          int shift = kLookBits - len;
          int first = (code + i) << shift;
          for (int j = 0; j < (1 << shift); ++j) {
            t->look_len[first + j] = static_cast<uint8_t>(len);
            t->look_sym[first + j] = vals[k + i];
          }
        }
      }
      t->maxcode[len] = code + n - 1;
    } else {
      t->maxcode[len] = -1;
    }
    k += n;
    code = (code + n) << 1;
  }
  t->maxcode[17] = 0x7fffffff;  // sentinel: ends the slow search
  return true;
}

struct BitReader {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t acc = 0;  // left-aligned
  int nbits = 0;
  bool at_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint64_t b = 0;
      if (!at_marker && p < end) {
        b = *p;
        if (b == 0xFF) {
          uint8_t next = (p + 1 < end) ? p[1] : 0xD9;
          if (next == 0x00) {
            p += 2;
          } else {
            at_marker = true;  // leave p on the marker
            b = 0;
          }
        } else {
          ++p;
        }
      }
      acc |= b << (56 - nbits);
      nbits += 8;
    }
  }
  uint32_t peek(int n) { return static_cast<uint32_t>(acc >> (64 - n)); }
  void skip(int n) {
    acc <<= n;
    nbits -= n;
  }
  int get(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = static_cast<int>(peek(n));
    skip(n);
    return v;
  }
  // Skip to and over the next RSTn marker and start a fresh bit buffer.
  void restart() {
    acc = 0;
    nbits = 0;
    while (p + 1 < end && !(p[0] == 0xFF && p[1] >= 0xD0 && p[1] <= 0xD7))
      ++p;
    if (p + 1 < end) p += 2;
    at_marker = false;
  }
};

// Next Huffman symbol, or -1 for a code no table entry has.
int decode(BitReader& br, const Table& t) {
  if (br.nbits < 16) br.fill();
  uint32_t look = br.peek(kLookBits);
  int len = t.look_len[look];
  if (len) {
    br.skip(len);
    return t.look_sym[look];
  }
  for (len = kLookBits + 1; len <= 16; ++len) {
    int32_t code = static_cast<int32_t>(br.peek(len));
    if (code <= t.maxcode[len]) {
      br.skip(len);
      return t.vals[(t.valoff[len] + code) & 0xFF];
    }
  }
  return -1;
}

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// One block: DC difference then the run-length coded AC terms.
bool decode_block(BitReader& br, const Table& dc, const Table& ac,
                  int* pred, int16_t* block) {
  int s = decode(br, dc);
  if (s < 0 || s > 16) return false;
  *pred += s ? extend(br.get(s), s) : 0;
  block[0] = static_cast<int16_t>(*pred);
  for (int k = 1; k < 64; ++k) {
    int rs = decode(br, ac);
    if (rs < 0) return false;
    int r = rs >> 4;
    s = rs & 15;
    if (s) {
      k += r;
      block[kNatural[k]] = static_cast<int16_t>(extend(br.get(s), s));
    } else {
      if (r != 15) break;  // EOB
      k += 15;
    }
  }
  return true;
}

}  // namespace

extern "C" {

// Decode one scan. `comp` holds 8 int32 per scan component: h, v (its
// sampling factors; ignored in a single-component scan), blocks a row of
// its coefficient array, blocks coded a row and block rows coded (both
// used by a single-component scan), DC table, AC table (0-3), and its
// block offset into `coefs` (the array holds 64 int16 a block, rows of
// the stated width). `bits`/`vals`: 8 tables (DC 0-3, AC 0-3) of 16
// counts and 256 symbols. `mcux` x `mcuy` MCUs for an interleaved scan.
// Returns 0, -1 for a corrupt code, -2 for an invalid table.
int jpeg_decode_scan(const uint8_t* data, int64_t len, int ncomp,
                     const int32_t* comp, const uint8_t* bits,
                     const uint8_t* vals, int mcux, int mcuy,
                     int restart_interval, int16_t* coefs) {
  static thread_local Table tables[8];
  bool used[8] = {false};
  for (int c = 0; c < ncomp; ++c) {
    used[comp[8 * c + 5] & 3] = true;
    used[4 + (comp[8 * c + 6] & 3)] = true;
  }
  for (int i = 0; i < 8; ++i)
    if (used[i] && !build_table(bits + 16 * i, vals + 256 * i, &tables[i]))
      return -2;

  BitReader br;
  br.p = data;
  br.end = data + len;
  int pred[4] = {0, 0, 0, 0};
  int64_t n_mcu, mcu_w;
  if (ncomp == 1) {
    mcu_w = comp[3];
    n_mcu = static_cast<int64_t>(comp[3]) * comp[4];
  } else {
    mcu_w = mcux;
    n_mcu = static_cast<int64_t>(mcux) * mcuy;
  }
  int todo = restart_interval;
  for (int64_t m = 0; m < n_mcu; ++m) {
    if (restart_interval) {
      if (todo == 0) {
        br.restart();
        std::memset(pred, 0, sizeof(pred));
        todo = restart_interval;
      }
      --todo;
    }
    int64_t my = m / mcu_w, mx = m % mcu_w;
    for (int c = 0; c < ncomp; ++c) {
      const int32_t* cp = comp + 8 * c;
      int h = ncomp == 1 ? 1 : cp[0], v = ncomp == 1 ? 1 : cp[1];
      const Table& dc = tables[cp[5] & 3];
      const Table& ac = tables[4 + (cp[6] & 3)];
      for (int y = 0; y < v; ++y)
        for (int x = 0; x < h; ++x) {
          int64_t by = my * v + y, bx = mx * h + x;
          int16_t* block =
              coefs + 64 * (static_cast<int64_t>(cp[7]) + by * cp[2] + bx);
          if (!decode_block(br, dc, ac, &pred[c], block)) return -1;
        }
    }
  }
  return 0;
}

}  // extern "C"
