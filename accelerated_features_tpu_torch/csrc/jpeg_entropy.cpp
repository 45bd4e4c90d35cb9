// Huffman entropy decoder of baseline and extended-sequential JPEG scans
// (host code, used by `utils/imageio.decode_jpeg`): the entropy-coded
// segment of one scan -> the quantized DCT coefficients of its blocks, in
// natural (row-major) order. Everything after this step (dequantization,
// the integer IDCT, chroma upsampling, colour conversion) runs vectorized
// in numpy; only this bit-serial loop is native. And its inverse, the
// baseline Huffman encoder of `utils/imageio.encode_jpeg`
// (`jpeg_encode_scan`, libjpeg's `jchuff.c` without optimized tables).
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

// Encoder side: the code and length of each symbol of a table (T.81 C.2,
// libjpeg's jpeg_make_c_derived_tbl), and a bit writer that stuffs a zero
// byte after every 0xFF and pads the last byte with ones.
struct CodeTable {
  uint32_t code[256];
  uint8_t size[256];
};

bool build_codes(const uint8_t* bits, CodeTable* t) {
  std::memset(t, 0, sizeof(CodeTable));
  uint32_t code = 0;
  int k = 0;
  uint8_t sizes[257];
  for (int len = 1; len <= 16; ++len)
    for (int i = 0; i < bits[len - 1]; ++i) {
      if (k >= 256) return false;
      sizes[k++] = static_cast<uint8_t>(len);
    }
  int n = k;
  k = 0;
  int si = n ? sizes[0] : 0;
  while (k < n) {
    while (k < n && sizes[k] == si) {
      t->size[k] = static_cast<uint8_t>(si);
      t->code[k++] = code++;
    }
    if (code >= (1u << si)) return false;  // an all-ones code
    code <<= 1;
    ++si;
  }
  return true;
}

struct BitWriter {
  uint8_t* out;
  int64_t cap;
  int64_t n = 0;
  uint64_t acc = 0;  // right-aligned
  int nbits = 0;
  bool overflow = false;

  void byte(uint8_t b) {
    if (n + 2 > cap) {
      overflow = true;
      return;
    }
    out[n++] = b;
    if (b == 0xFF) out[n++] = 0;
  }
  void put(uint32_t v, int size) {
    acc = (acc << size) | (v & ((1u << size) - 1));
    nbits += size;
    while (nbits >= 8) {
      nbits -= 8;
      byte(static_cast<uint8_t>(acc >> nbits));
    }
  }
  void flush() {
    if (nbits) put(0x7F, 8 - nbits);
  }
};

// One block: the DC difference's size category and bits, then the AC
// terms in zigzag order as (zero run, size) symbols with ZRL for runs of
// 16 and EOB after the last nonzero term (T.81 F.1.2). False for a term
// wider than baseline allows (11 bits DC, 10 bits AC).
bool encode_block(BitWriter& bw, const int16_t* block, int* pred,
                  const CodeTable& dc, const CodeTable& ac,
                  const uint8_t* dc_index, const uint8_t* ac_index) {
  int temp = block[0] - *pred;
  *pred = block[0];
  int mag = temp < 0 ? -temp : temp;
  int nbits = 0;
  while (mag >> nbits) ++nbits;
  if (nbits > 11) return false;
  int s = dc_index[nbits];
  bw.put(dc.code[s], dc.size[s]);
  if (nbits) bw.put(static_cast<uint32_t>(temp < 0 ? temp - 1 : temp), nbits);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    temp = block[kNatural[k]];
    if (temp == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      s = ac_index[0xF0];
      bw.put(ac.code[s], ac.size[s]);
      run -= 16;
    }
    mag = temp < 0 ? -temp : temp;
    nbits = 0;
    while (mag >> nbits) ++nbits;
    if (nbits > 10) return false;
    s = ac_index[(run << 4) + nbits];
    bw.put(ac.code[s], ac.size[s]);
    bw.put(static_cast<uint32_t>(temp < 0 ? temp - 1 : temp), nbits);
    run = 0;
  }
  if (run > 0) {
    s = ac_index[0];
    bw.put(ac.code[s], ac.size[s]);
  }
  return true;
}

}  // namespace

extern "C" {

// Encode one baseline scan into `out` (at most `cap` bytes). `comp` holds
// 6 int32 per scan component: h, v (blocks of it in an MCU), blocks a row
// of its coefficient array, its block offset into `coefs` (64 int16 a
// block, natural order, every block an MCU covers present, padding blocks
// included), DC table (0-1), AC table (0-1). `bits`/`vals`: 4 tables (DC
// 0-1, AC 0-1) of 16 counts and 256 symbols. `mcux` x `mcuy` MCUs, no
// restart interval. Returns the byte count, -1 if `cap` was too small, -2
// for an invalid table, a symbol a table lacks or a term too wide.
int64_t jpeg_encode_scan(int ncomp, const int32_t* comp, const int16_t* coefs,
                         const uint8_t* bits, const uint8_t* vals, int mcux,
                         int mcuy, uint8_t* out, int64_t cap) {
  CodeTable tables[4];
  uint8_t index[4][256];  // symbol -> its position in the table
  for (int i = 0; i < 4; ++i) {
    if (!build_codes(bits + 16 * i, &tables[i])) return -2;
    std::memset(index[i], 0, 256);
    int n = 0;
    for (int len = 0; len < 16; ++len) n += bits[16 * i + len];
    bool seen[256] = {false};
    for (int k = 0; k < n; ++k) {
      index[i][vals[256 * i + k]] = static_cast<uint8_t>(k);
      seen[vals[256 * i + k]] = true;
    }
    // every symbol a block can need must have a code
    for (int sym = 0; sym < 256; ++sym) {
      bool needed = i < 2 ? sym <= 11 : ((sym & 15) <= 10 && (sym & 15) != 0) ||
                                            sym == 0 || sym == 0xF0;
      if (needed && !seen[sym]) return -2;
    }
  }
  BitWriter bw;
  bw.out = out;
  bw.cap = cap;
  int pred[4] = {0, 0, 0, 0};
  for (int64_t my = 0; my < mcuy; ++my)
    for (int64_t mx = 0; mx < mcux; ++mx)
      for (int c = 0; c < ncomp; ++c) {
        const int32_t* cp = comp + 6 * c;
        int dc = cp[4] & 1, ac = 2 + (cp[5] & 1);
        for (int y = 0; y < cp[1]; ++y)
          for (int x = 0; x < cp[0]; ++x) {
            int64_t by = my * cp[1] + y, bx = mx * cp[0] + x;
            if (!encode_block(bw, coefs + 64 * (cp[3] + by * cp[2] + bx),
                              &pred[c], tables[dc], tables[ac], index[dc],
                              index[ac]))
              return -2;
          }
      }
  bw.flush();
  return bw.overflow ? -1 : bw.n;
}

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
