// JPEG decoder of the port's data library (see jpeg_decode.h).
//
// Each step follows the libjpeg-turbo 2.1 module that does it, so the
// output is the same to the byte, on good data and on bad:
//   - markers (jdmarker.c): SOI, SOFn, DHT, DQT, DRI, DAC, SOS, EOI, APPn
//     (JFIF APP0 and Adobe APP14 read, the others skipped), COM, DNL,
//     RSTn/TEM outside a scan; every other marker fails;
//   - the data source (jdatasrc.c): past the end of the data, every read
//     gives an EOI marker, FF D9, again and again;
//   - Huffman decoding (jdhuff.c, jdphuff.c): derived tables and their
//     checks, the standard tables where a sequential frame brings none,
//     restart markers and their resync rules, and, where the entropy data
//     meets a marker too early, zero bits for the rest of that MCU and
//     nothing more for the rest of the restart interval;
//   - arithmetic decoding (jdarith.c), sequential and progressive, with
//     the DAC conditioning;
//   - the coefficient buffer (jdcoefct.c): every scan decoded into it,
//     then block smoothing of a progressive image whose first AC
//     coefficients are not all known to full precision, row by row from
//     the coefficient state of the scan that wrote that row;
//   - the integer IDCT (jidctint.c) as libjpeg-turbo's x86 SIMD code
//     computes it, which differs only where a sum overflows;
//   - upsampling with fancy upsampling on (jdsample.c): the h2v1, h1v2 and
//     h2v2 triangle filters, box replication otherwise;
//   - colour conversion (jdcolor.c): the fixed-point YCbCr tables, the
//     colour space chosen by jdapimin.c's rules.

#include "jpeg_decode.h"

#include <algorithm>
#include <cstring>
#include <memory>

namespace wdm {
namespace {

struct Fail {};  // where libjpeg's error_exit would longjmp

[[noreturn]] void Error() { throw Fail(); }

// zigzag position -> natural position; 16 extra entries catch runs that
// overshoot the block, as jpeg_natural_order's do
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

enum Marker {
  kSOF0 = 0xC0, kSOF1 = 0xC1, kSOF2 = 0xC2, kDHT = 0xC4, kSOF9 = 0xC9,
  kSOF10 = 0xCA, kDAC = 0xCC, kRST0 = 0xD0, kRST7 = 0xD7, kSOI = 0xD8,
  kEOI = 0xD9, kSOS = 0xDA, kDQT = 0xDB, kDNL = 0xDC, kDRI = 0xDD,
  kAPP0 = 0xE0, kAPP14 = 0xEE, kAPP15 = 0xEF, kCOM = 0xFE, kTEM = 0x01,
};

// ------------------------------------------------------------ the input

struct Input {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  bool ran_out = false;
  int unread_marker = 0;

  int Byte() {
    if (pos < size) return data[pos++];
    ran_out = true;
    return ((pos++ - size) & 1) ? kEOI : 0xFF;
  }
  int Two() {
    int a = Byte();
    return (a << 8) | Byte();
  }
  void Skip(long n) {
    if (n <= 0) return;
    if (pos + size_t(n) > size) ran_out = true;
    pos += size_t(n);
  }
  // jdmarker.c next_marker: skip to the next FF xx with xx not 0 or FF
  void NextMarker() {
    int c;
    for (;;) {
      c = Byte();
      while (c != 0xFF) c = Byte();
      do {
        c = Byte();
      } while (c == 0xFF);
      if (c != 0) break;
    }
    unread_marker = c;
  }
};

// ---------------------------------------------------------- the bit reader

// MSB first in a 64-bit word; bits below the `n` valid ones are zero, which
// are the zero bits libjpeg supplies once it has met a marker.
struct Bits {
  Input* in = nullptr;
  bool* insufficient = nullptr;
  uint64_t acc = 0;
  int n = 0;

  void Reset() {
    acc = 0;
    n = 0;
  }
  void Fill() {
    while (n <= 56 && in->unread_marker == 0) {
      int c;
      if (in->pos < in->size && in->data[in->pos] != 0xFF)
        c = in->data[in->pos++];  // the common byte, no marker or stuffing
      else
        c = in->Byte();
      if (c == 0xFF) {
        do {
          c = in->Byte();
        } while (c == 0xFF);
        if (c == 0) {
          c = 0xFF;
        } else {
          in->unread_marker = c;
          break;
        }
      }
      acc |= uint64_t(c) << (56 - n);
      n += 8;
    }
  }
  void Drop(int k) {
    if (k > n) *insufficient = true;  // jdhuff.c's JWRN_HIT_MARKER
    acc <<= k;
    n = k > n ? 0 : n - k;
  }
  int Get(int k) {  // 1 <= k <= 16
    if (n < k) Fill();
    int v = int(acc >> (64 - k));
    Drop(k);
    return v;
  }
};

inline int Extend(int r, int s) {
  return r < (1 << (s - 1)) ? r - (1 << s) + 1 : r;
}

// ------------------------------------------------------------ Huffman

struct HuffSpec {
  bool present = false;
  uint8_t bits[17] = {0};
  uint8_t val[256] = {0};
};

struct HuffTable {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t val[256];
  uint16_t look[256];  // (length << 8) | symbol for codes of <= 8 bits
  // an AC code and its extra bits in the next 9 bits together, where they
  // fit and the coefficient in 8 bits: (value << 8) | (run << 4) | bits
  // used; 0 elsewhere
  int16_t fast_ac[512];
};

// jdhuff.c jpeg_make_d_derived_tbl, its checks included
void MakeTable(const HuffSpec& spec, bool dc, HuffTable* t) {
  if (!spec.present) Error();
  char size[257];
  unsigned int code[257];
  int p = 0;
  for (int l = 1; l <= 16; ++l) {
    int i = spec.bits[l];
    if (p + i > 256) Error();
    while (i--) size[p++] = char(l);
  }
  size[p] = 0;
  const int nsym = p;
  unsigned int c = 0;
  int si = size[0];
  p = 0;
  while (size[p]) {
    while (size[p] == si) code[p++] = c++;
    if (c >= (1u << si)) Error();
    c <<= 1;
    ++si;
  }
  p = 0;
  for (int l = 1; l <= 16; ++l) {
    if (spec.bits[l]) {
      t->valoffset[l] = p - int32_t(code[p]);
      p += spec.bits[l];
      t->maxcode[l] = int32_t(code[p - 1]);
    } else {
      t->maxcode[l] = -1;
    }
  }
  t->valoffset[17] = 0;
  t->maxcode[17] = 0xFFFFF;
  std::memcpy(t->val, spec.val, 256);
  std::memset(t->look, 0, sizeof(t->look));
  p = 0;
  for (int l = 1; l <= 8; ++l) {
    for (int i = 1; i <= spec.bits[l]; ++i, ++p) {
      int look = int(code[p]) << (8 - l);
      for (int ctr = 1 << (8 - l); ctr > 0; --ctr)
        t->look[look++] = uint16_t((l << 8) | spec.val[p]);
    }
  }
  std::memset(t->fast_ac, 0, sizeof(t->fast_ac));
  for (int i = 0; i < 512; ++i) {
    const int e = t->look[i >> 1];
    const int l = e >> 8, run = (e >> 4) & 15, size = e & 15;
    if (!e || !size || l + size > 9) continue;
    const int v = Extend(((i << l) & 511) >> (9 - size), size);
    if (v >= -128 && v <= 127)
      t->fast_ac[i] = int16_t(v * 256 + (run << 4) + l + size);
  }
  if (dc)
    for (int i = 0; i < nsym; ++i)
      if (spec.val[i] > 15) Error();
}

// a code longer than 8 bits
__attribute__((noinline)) int DecodeLong(Bits& b, const HuffTable& t) {
  int l = 9;
  int32_t code = int32_t(b.acc >> (64 - 9));
  while (code > t.maxcode[l]) {
    ++l;
    code = int32_t(b.acc >> (64 - l));
  }
  b.Drop(l);
  if (l > 16) return 0;  // JWRN_HUFF_BAD_CODE: a zero instead
  return t.val[(code + t.valoffset[l]) & 0xFF];
}

// One symbol.  Refilled below 32 bits, the buffer then holds the extra
// bits of a coefficient too (at most 16 + 15), short of a marker.
inline int Decode(Bits& b, const HuffTable& t) {
  if (b.n < 32) b.Fill();
  int e = t.look[b.acc >> 56];
  if (e) {
    b.Drop(e >> 8);
    return e & 0xFF;
  }
  return DecodeLong(b, t);
}

// jstdhuff.c: the tables of the JPEG standard's K.3, for sequential
// Huffman frames without DHT
void StdTables(HuffSpec* dc, HuffSpec* ac) {
  static const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1,
                                         1, 0, 0, 0, 0, 0, 0, 0};
  static const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1,
                                           1, 1, 1, 0, 0, 0, 0, 0};
  static const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3,
                                         5, 5, 4, 4, 0, 0, 1, 0x7d};
  static const uint8_t kAcLumVal[162] = {
      0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
      0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
      0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24,
      0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a,
      0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38,
      0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53,
      0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66,
      0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
      0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93,
      0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5,
      0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6, 0xb7,
      0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
      0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1,
      0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2,
      0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
  static const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4,
                                           7, 5, 4, 4, 0, 1, 2, 0x77};
  static const uint8_t kAcChromVal[162] = {
      0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
      0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
      0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15,
      0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17,
      0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37,
      0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a,
      0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65,
      0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
      0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a,
      0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
      0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5,
      0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
      0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9,
      0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2,
      0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
  auto set = [](HuffSpec* s, const uint8_t* bits, const uint8_t* val,
                int nval) {
    if (s->present) return;
    s->present = true;
    std::memcpy(s->bits, bits, 17);
    std::memset(s->val, 0, 256);
    std::memcpy(s->val, val, nval);
  };
  static const uint8_t kDcVal[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
  set(&dc[0], kDcLumBits, kDcVal, 12);
  set(&ac[0], kAcLumBits, kAcLumVal, 162);
  set(&dc[1], kDcChromBits, kDcVal, 12);
  set(&ac[1], kAcChromBits, kAcChromVal, 162);
}

// ------------------------------------------------------ arithmetic coding

// The JPEG standard's Table D.2 as jaricom.c packs it: Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; entry 113 is the
// fixed probability 0.5.
const uint32_t kAriTab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617,
    0x00e50719, 0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09,
    0x00030d0a, 0x00010d0c, 0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227,
    0x17b91328, 0x1182142a, 0x0cef152b, 0x09a1162d, 0x072f172e, 0x055c1830,
    0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36, 0x01441d38, 0x00f51e39,
    0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320, 0x002c0921,
    0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d,
    0x0861314e, 0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633,
    0x02d43734, 0x025c3835, 0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39,
    0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d, 0x008f203d, 0x5b1241c1, 0x4d044250,
    0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654, 0x23794756, 0x1edf4857,
    0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a, 0x0d514e4b,
    0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f,
    0x44d95b60, 0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df,
    0x4f466165, 0x47e56266, 0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669,
    0x4c0f676a, 0x4639686b, 0x415e6367, 0x56276ae9, 0x50e76b6c, 0x4b85676d,
    0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70, 0x59eb6ff0, 0x5a1d7171};

// jdarith.c's decoder registers and arith_decode
struct Arith {
  Input* in = nullptr;
  int64_t c = 0;  // base of the interval + the input bit buffer
  int64_t a = 0;  // normalized size of the interval
  int ct = -16;   // bits left in the buffer part of c; -1 after an error

  void Reset() {
    c = 0;
    a = 0;
    ct = -16;  // read 2 bytes first
  }

  int Decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;  // zeros once a marker is met
        if (in->unread_marker == 0) {
          data = in->Byte();
          if (data == 0xFF) {
            do {
              data = in->Byte();
            } while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              in->unread_marker = data;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;  // the 2 initial bytes are in
      }
      a <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = int(qe & 0xFF);
    qe >>= 8;
    const int nm = int(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < qe) {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < qe) {
        *st = uint8_t((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = uint8_t((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

// --------------------------------------------------------------- the IDCT

inline int16_t Wrap16(int32_t x) { return int16_t(uint16_t(uint32_t(x))); }
inline int16_t Sat16(int32_t x) {
  return int16_t(x < -32768 ? -32768 : (x > 32767 ? 32767 : x));
}
inline int32_t Add32(int32_t a, int32_t b) {
  return int32_t(uint32_t(a) + uint32_t(b));
}
inline int32_t Sub32(int32_t a, int32_t b) {
  return int32_t(uint32_t(a) - uint32_t(b));
}

// Eight 1-D passes of libjpeg's integer IDCT side by side, lane i taking
// its input k from v[8k + i], as the x86 SIMD code computes each: sums of
// two inputs in 16 bits, products in pmaddwd pairs (the jidctint.c
// constants folded pairwise), the rest in 32 bits.  Writes lane i's
// tmp10+tmp3 ... tmp13-tmp0, before descaling, to o[i], ..., o[56 + i].
// The lanes are independent, so the compiler runs them in vector lanes.
inline void Idct1d8(const int16_t* v, int32_t* o) {
  for (int i = 0; i < 8; ++i) {
    const int32_t in0 = v[i], in1 = v[8 + i], in2 = v[16 + i],
                  in3 = v[24 + i], in4 = v[32 + i], in5 = v[40 + i],
                  in6 = v[48 + i], in7 = v[56 + i];
    const int32_t tmp3 = in2 * 10703 + in6 * 4433;    // F130, F054
    const int32_t tmp2 = in2 * 4433 + in6 * -10704;   // F054, -F130
    const int32_t tmp0 = int32_t(Wrap16(in0 + in4)) * 8192;
    const int32_t tmp1 = int32_t(Wrap16(in0 - in4)) * 8192;
    const int32_t tmp10 = Add32(tmp0, tmp3), tmp13 = Sub32(tmp0, tmp3);
    const int32_t tmp11 = Add32(tmp1, tmp2), tmp12 = Sub32(tmp1, tmp2);
    const int32_t z3 = Wrap16(in7 + in3), z4 = Wrap16(in5 + in1);
    const int32_t Z3 = z3 * -6436 + z4 * 9633;        // -F078, F117
    const int32_t Z4 = z3 * 9633 + z4 * 6437;         // F117, F078
    const int32_t o0 = Add32(in7 * -4927 + in1 * -7373, Z3);
    const int32_t o1 = Add32(in5 * -4176 + in3 * -20995, Z4);
    const int32_t o2 = Add32(in5 * -20995 + in3 * 4177, Z3);
    const int32_t o3 = Add32(in7 * -7373 + in1 * 4926, Z4);
    o[i] = Add32(tmp10, o3);
    o[56 + i] = Sub32(tmp10, o3);
    o[8 + i] = Add32(tmp11, o2);
    o[48 + i] = Sub32(tmp11, o2);
    o[16 + i] = Add32(tmp12, o1);
    o[40 + i] = Sub32(tmp12, o1);
    o[24 + i] = Add32(tmp13, o0);
    o[32 + i] = Sub32(tmp13, o0);
  }
}

// the second pass's descaling to a sample, saturated as the SIMD packs do
inline uint8_t Descale8(int32_t x) {
  int v = Sat16(Add32(x, 1 << 17) >> 18);
  v = v < -128 ? -128 : (v > 127 ? 127 : v);
  return uint8_t(v + 128);
}

// libjpeg-turbo's JDCT_ISLOW IDCT (jidctint.c) as its x86-64 SIMD code
// (jidctint-avx2.asm, -sse2.asm) computes it, which is what the JAX
// package's library runs: 16-bit dequantization; a block whose rows 1-7
// are all zero takes the DC shortcut for every column, and then its eight
// rows are equal, so the second pass runs once for all of them; the first
// pass's results saturate to 16 bits, the second's to 8 bits around 128.
// Equal to jidctint.c wherever nothing overflows.  q is the table in
// natural order; writes 8x8 samples with row stride `stride`.
void IdctIslow(const int16_t* in, const int16_t* q, uint8_t* out,
               size_t stride) {
  alignas(16) int16_t deq[64];
  alignas(16) int16_t ws[64];   // the first pass's output, transposed
  alignas(32) int32_t o[64];
  bool rows_zero = true;
  for (int i = 8; i < 64 && rows_zero; ++i) rows_zero = in[i] == 0;
  if (rows_zero) {             // lane 0 is every row; the rest idle
    for (int c = 0; c < 8; ++c)
      ws[8 * c] = Wrap16(int32_t(Wrap16(int32_t(in[c]) * q[c])) * 4);
    for (int i = 0; i < 64; ++i)
      if (i % 8) ws[i] = 0;
    Idct1d8(ws, o);
    uint8_t px[8];
    for (int c = 0; c < 8; ++c) px[c] = Descale8(o[8 * c]);
    for (int r = 0; r < 8; ++r) std::memcpy(out + r * stride, px, 8);
    return;
  }
  for (int i = 0; i < 64; ++i) deq[i] = Wrap16(int32_t(in[i]) * q[i]);
  Idct1d8(deq, o);              // lane c is column c; o[8r + c] its row r
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c)
      ws[8 * c + r] = Sat16(Add32(o[8 * r + c], 1 << 10) >> 11);
  Idct1d8(ws, o);               // lane r is row r; o[8c + r] its column c
  alignas(16) uint8_t px[64];
  for (int i = 0; i < 64; ++i) px[i] = Descale8(o[i]);
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) out[r * stride + c] = px[8 * c + r];
}

// ------------------------------------------------------------ the decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;          // real blocks across and down
  int bw_pad = 0, bh_pad = 0;  // rounded up to whole MCUs
  int dw = 0, dh = 0;          // downsampled width and height
  bool latched = false;        // its quantization table was saved
  uint16_t q[64];              // natural order
  std::vector<int16_t> coef;   // bh_pad x bw_pad blocks of 64

  int16_t* Block(int r, int c) {
    return &coef[(size_t(r) * bw_pad + c) * 64];
  }
};

enum ColorSpace { kGray, kYCbCr, kRGB, kOther };

class Decoder {
 public:
  Decoder(const uint8_t* data, size_t size) {
    in_.data = data;
    in_.size = size;
    bits_.in = &in_;
    bits_.insufficient = &insufficient_;
    arith_dec_.in = &in_;
  }

  bool ran_out() const { return in_.ran_out; }
  int width() const { return width_; }
  int height() const { return height_; }

  // jpeg_read_header(cinfo, TRUE)
  void ReadHeader() {
    if (in_.size == 0) Error();  // JERR_INPUT_EMPTY
    if (ReadMarkers() != kSOS) Error();  // JERR_NO_IMAGE / SOF_NO_SOS
    InitialSetup();
  }

  // jpeg_start_decompress, the scanlines and jpeg_finish_decompress
  void Decompress(std::vector<uint8_t>* rgb) {
    ColorSpace cs = ChooseColorSpace();
    if (cs == kOther) Error();  // JERR_CONVERSION_NOTIMPL
    for (auto& c : comps_) {
      int hi = c.h, vi = c.v;
      if (!((max_h_ % hi) == 0 && (max_v_ % vi) == 0))
        Error();  // JERR_FRACT_SAMPLE_NOTIMPL
    }
    // jdhuff.c's decoder (not jdphuff.c's) brings the standard tables
    if (!arith_ && !progressive_) StdTables(dc_spec_, ac_spec_);
    for (auto& c : comps_) {
      c.bw_pad = (c.bw + c.h - 1) / c.h * c.h;
      c.bh_pad = (c.bh + c.v - 1) / c.v * c.v;
      c.coef.assign(size_t(c.bw_pad) * c.bh_pad * 64, 0);
    }
    if (progressive_) {
      coef_bits_.assign(size_t(ncomp_) * 64, -1);
      prev_coef_bits_.assign(size_t(ncomp_) * 64, 0);
    }
    for (;;) {
      StartScan();
      DecodeScan();
      int m = ReadMarkers();
      if (m == kEOI) break;
      if (!multiple_scans_) Error();  // JERR_EOI_EXPECTED
    }
    Output(cs, rgb);
  }

 private:
  // ------------------------------------------------------------- markers

  int ReadMarkers() {
    for (;;) {
      if (in_.unread_marker == 0) {
        if (!saw_soi_) {
          int c = in_.Byte(), c2 = in_.Byte();
          if (c != 0xFF || c2 != kSOI) Error();  // JERR_NO_SOI
          in_.unread_marker = c2;
        } else {
          in_.NextMarker();
        }
      }
      int m = in_.unread_marker;
      switch (m) {
        case kSOI:
          GetSoi();
          break;
        case kSOF0:
        case kSOF1:
          GetSof(false, false);
          break;
        case kSOF2:
          GetSof(true, false);
          break;
        case kSOF9:
          GetSof(false, true);
          break;
        case kSOF10:
          GetSof(true, true);
          break;
        case kSOS:
          GetSos();
          in_.unread_marker = 0;
          return kSOS;
        case kEOI:
          in_.unread_marker = 0;
          return kEOI;
        case kDAC:
          GetDac();
          break;
        case kDHT:
          GetDht();
          break;
        case kDQT:
          GetDqt();
          break;
        case kDRI:
          GetDri();
          break;
        case kCOM:
        case kDNL:
          SkipVariable();
          break;
        case kTEM:
          break;
        default:
          if (m >= kRST0 && m <= kRST7) break;
          if (m == kAPP0 || m == kAPP14) {
            GetAppn(m);
            break;
          }
          if (m > kAPP0 && m <= kAPP15) {
            SkipVariable();
            break;
          }
          Error();  // SOF3/5-7/11/13-15, JPG, DHP, EXP, JPGn, RESn
      }
      in_.unread_marker = 0;
    }
  }

  void GetSoi() {
    if (saw_soi_) Error();
    for (int i = 0; i < 16; ++i) {
      arith_dc_l_[i] = 0;
      arith_dc_u_[i] = 1;
      arith_ac_k_[i] = 5;
    }
    restart_interval_ = 0;
    saw_jfif_ = saw_adobe_ = false;
    adobe_transform_ = 0;
    saw_soi_ = true;
  }

  void GetSof(bool prog, bool arith) {
    progressive_ = prog;
    arith_ = arith;
    long length = in_.Two();
    precision_ = in_.Byte();
    height_ = in_.Two();
    width_ = in_.Two();
    ncomp_ = in_.Byte();
    length -= 8;
    if (saw_sof_) Error();
    if (height_ <= 0 || width_ <= 0 || ncomp_ <= 0) Error();
    if (length != ncomp_ * 3) Error();
    comps_.assign(ncomp_, Component());
    for (auto& c : comps_) {
      c.id = in_.Byte();
      int hv = in_.Byte();
      c.h = (hv >> 4) & 15;
      c.v = hv & 15;
      c.tq = in_.Byte();
    }
    saw_sof_ = true;
  }

  void GetSos() {
    if (!saw_sof_) Error();
    long length = in_.Two();
    int n = in_.Byte();
    if (length != n * 2 + 6 || n < 1 || n > 4) Error();
    comps_in_scan_ = n;
    int cur[4] = {-1, -1, -1, -1};
    for (int i = 0; i < n; ++i) {
      int cc = in_.Byte(), c = in_.Byte();
      int found = -1;
      for (int ci = 0; ci < ncomp_ && ci < 4; ++ci)
        if (cc == comps_[ci].id && cur[ci] < 0) {
          found = ci;
          break;
        }
      if (found < 0) Error();  // JERR_BAD_COMPONENT_ID
      cur[i] = found;
      comps_[found].dc_tbl = (c >> 4) & 15;
      comps_[found].ac_tbl = c & 15;
      for (int pi = 0; pi < i; ++pi)
        if (cur[pi] == found) Error();
    }
    for (int i = 0; i < 4; ++i) scan_comp_[i] = cur[i];
    ss_ = in_.Byte();
    se_ = in_.Byte();
    int a = in_.Byte();
    ah_ = (a >> 4) & 15;
    al_ = a & 15;
    next_restart_num_ = 0;
    ++input_scan_number_;
  }

  void GetDht() {
    long length = in_.Two() - 2;
    while (length > 16) {
      int index = in_.Byte();
      uint8_t bits[17] = {0};
      int count = 0;
      for (int i = 1; i <= 16; ++i) {
        bits[i] = uint8_t(in_.Byte());
        count += bits[i];
      }
      length -= 17;
      if (count > 256 || count > length) Error();
      uint8_t val[256] = {0};
      for (int i = 0; i < count; ++i) val[i] = uint8_t(in_.Byte());
      length -= count;
      HuffSpec* spec;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index >= 4) Error();
        spec = &ac_spec_[index];
      } else {
        if (index < 0 || index >= 4) Error();
        spec = &dc_spec_[index];
      }
      spec->present = true;
      std::memcpy(spec->bits, bits, 17);
      std::memcpy(spec->val, val, 256);
    }
    if (length != 0) Error();
  }

  void GetDqt() {
    long length = in_.Two() - 2;
    while (length > 0) {
      int n = in_.Byte();
      int prec = n >> 4;
      n &= 0x0F;
      if (n >= 4) Error();
      qt_present_[n] = true;
      for (int i = 0; i < 64; ++i)
        qt_[n][kNatural[i]] = uint16_t(prec ? in_.Two() : in_.Byte());
      length -= 65;
      if (prec) length -= 64;
    }
    if (length != 0) Error();
  }

  void GetDri() {
    if (in_.Two() != 4) Error();
    restart_interval_ = in_.Two();
  }

  void GetDac() {
    long length = in_.Two() - 2;
    while (length > 0) {
      int index = in_.Byte(), val = in_.Byte();
      length -= 2;
      if (index >= 32) Error();
      if (index >= 16) {
        arith_ac_k_[index - 16] = val;
      } else {
        arith_dc_l_[index] = val & 0x0F;
        arith_dc_u_[index] = val >> 4;
        if (arith_dc_l_[index] > arith_dc_u_[index]) Error();
      }
    }
    if (length != 0) Error();
  }

  void GetAppn(int m) {
    long length = in_.Two() - 2;
    int numtoread = length >= 14 ? 14 : (length > 0 ? int(length) : 0);
    uint8_t b[14];
    for (int i = 0; i < numtoread; ++i) b[i] = uint8_t(in_.Byte());
    length -= numtoread;
    if (m == kAPP0) {
      if (numtoread >= 14 && b[0] == 'J' && b[1] == 'F' && b[2] == 'I' &&
          b[3] == 'F' && b[4] == 0)
        saw_jfif_ = true;
    } else if (numtoread >= 12 && b[0] == 'A' && b[1] == 'd' &&
               b[2] == 'o' && b[3] == 'b' && b[4] == 'e') {
      saw_adobe_ = true;
      adobe_transform_ = b[11];
    }
    if (length > 0) in_.Skip(length);
  }

  void SkipVariable() {
    long length = in_.Two() - 2;
    if (length > 0) in_.Skip(length);
  }

  // --------------------------------------------------------------- setup

  // jdinput.c initial_setup, at the first SOS
  void InitialSetup() {
    if (height_ > 65500 || width_ > 65500) Error();
    if (precision_ != 8) Error();
    if (ncomp_ > 10) Error();
    max_h_ = max_v_ = 1;
    for (auto& c : comps_) {
      if (c.h <= 0 || c.h > 4 || c.v <= 0 || c.v > 4) Error();
      max_h_ = std::max(max_h_, c.h);
      max_v_ = std::max(max_v_, c.v);
    }
    for (auto& c : comps_) {
      c.bw = int((int64_t(width_) * c.h + 8 * max_h_ - 1) / (8 * max_h_));
      c.bh = int((int64_t(height_) * c.v + 8 * max_v_ - 1) / (8 * max_v_));
      c.dw = int((int64_t(width_) * c.h + max_h_ - 1) / max_h_);
      c.dh = int((int64_t(height_) * c.v + max_v_ - 1) / max_v_);
    }
    total_imcu_rows_ = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
    multiple_scans_ = comps_in_scan_ < ncomp_ || progressive_;
  }

  // jdapimin.c default_decompress_parms, then what jdcolor.c converts to
  // RGB
  ColorSpace ChooseColorSpace() const {
    if (ncomp_ == 1) return kGray;
    if (ncomp_ != 3) return kOther;  // CMYK, YCCK or unknown
    if (saw_jfif_) return kYCbCr;
    if (saw_adobe_) return adobe_transform_ == 0 ? kRGB : kYCbCr;
    int c0 = comps_[0].id, c1 = comps_[1].id, c2 = comps_[2].id;
    if (c0 == 82 && c1 == 71 && c2 == 66) return kRGB;  // 'R' 'G' 'B'
    return kYCbCr;
  }

  // jdinput.c start_input_pass + the entropy decoder's start_pass
  void StartScan() {
    if (comps_in_scan_ == 1) {
      Component& c = comps_[scan_comp_[0]];
      mcus_per_row_ = c.bw;
      mcu_rows_ = c.bh;
    } else {
      mcus_per_row_ = (width_ + 8 * max_h_ - 1) / (8 * max_h_);
      mcu_rows_ = (height_ + 8 * max_v_ - 1) / (8 * max_v_);
      int blocks = 0;
      for (int i = 0; i < comps_in_scan_; ++i) {
        const Component& c = comps_[scan_comp_[i]];
        blocks += c.h * c.v;
        if (blocks > 10) Error();  // JERR_BAD_MCU_SIZE
      }
    }
    for (int i = 0; i < comps_in_scan_; ++i) {  // latch_quant_tables
      Component& c = comps_[scan_comp_[i]];
      if (c.latched) continue;
      if (c.tq >= 4 || !qt_present_[c.tq]) Error();
      std::memcpy(c.q, qt_[c.tq], sizeof(c.q));
      c.latched = true;
    }
    if (progressive_) {
      const bool dc = ss_ == 0;
      bool bad = false;
      if (dc) {
        if (se_ != 0) bad = true;
      } else {
        if (ss_ > se_ || se_ >= 64) bad = true;
        if (comps_in_scan_ != 1) bad = true;
      }
      if (ah_ != 0 && al_ != ah_ - 1) bad = true;
      if (al_ > 13) bad = true;
      if (bad) Error();  // JERR_BAD_PROGRESSION
      for (int i = 0; i < comps_in_scan_; ++i) {
        int ci = scan_comp_[i];
        int* cb = &coef_bits_[size_t(ci) * 64];
        int* prev = &prev_coef_bits_[size_t(ci) * 64];
        for (int k = std::min(ss_, 1); k <= std::max(se_, 9); ++k)
          prev[k] = input_scan_number_ > 1 ? cb[k] : 0;
        for (int k = ss_; k <= se_; ++k) cb[k] = al_;
      }
      if (!arith_)
        for (int i = 0; i < comps_in_scan_; ++i) {
          const Component& c = comps_[scan_comp_[i]];
          if (dc) {
            if (ah_ == 0) BuildTable(true, c.dc_tbl);
          } else {
            BuildTable(false, c.ac_tbl);
          }
        }
    } else if (!arith_) {
      for (int i = 0; i < comps_in_scan_; ++i) {
        const Component& c = comps_[scan_comp_[i]];
        BuildTable(true, c.dc_tbl);
        BuildTable(false, c.ac_tbl);
      }
    }
    if (arith_) ResetStats(true);  // jdarith.c start_pass
    for (int& d : last_dc_) d = 0;
    bits_.Reset();
    arith_dec_.Reset();
    insufficient_ = false;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
  }

  // zero the statistics bins the scan uses, and its DC predictions
  void ResetStats(bool check) {
    for (int i = 0; i < comps_in_scan_; ++i) {
      const Component& c = comps_[scan_comp_[i]];
      if (!progressive_ || (ss_ == 0 && ah_ == 0)) {
        if (check && c.dc_tbl >= 16) Error();  // JERR_NO_ARITH_TABLE
        std::memset(dc_stats_[c.dc_tbl], 0, 64);
        last_dc_[i] = 0;
        dc_context_[i] = 0;
      }
      if (!progressive_ || ss_) {
        if (check && c.ac_tbl >= 16) Error();
        std::memset(ac_stats_[c.ac_tbl], 0, 256);
      }
    }
  }

  void BuildTable(bool dc, int tbl) {
    if (tbl < 0 || tbl >= 4) Error();  // JERR_NO_HUFF_TABLE
    MakeTable(dc ? dc_spec_[tbl] : ac_spec_[tbl], dc,
              dc ? &dc_tables_[tbl] : &ac_tables_[tbl]);
  }

  // ---------------------------------------------------------------- scans

  void DecodeScan() {
    int16_t* blocks[10];
    int owner[10];
    for (int row = 0; row < mcu_rows_; ++row) {
      int imcu = comps_in_scan_ == 1 ? row / comps_[scan_comp_[0]].v : row;
      for (int col = 0; col < mcus_per_row_; ++col) {
        int nb = 0;
        if (comps_in_scan_ == 1) {
          blocks[0] = comps_[scan_comp_[0]].Block(row, col);
          owner[0] = 0;
          nb = 1;
        } else {
          for (int i = 0; i < comps_in_scan_; ++i) {
            Component& c = comps_[scan_comp_[i]];
            for (int y = 0; y < c.v; ++y)
              for (int x = 0; x < c.h; ++x) {
                blocks[nb] = c.Block(row * c.v + y, col * c.h + x);
                owner[nb++] = i;
              }
          }
        }
        if (!insufficient_) last_good_imcu_row_ = imcu;
        if (arith_) {
          DecodeArith(blocks, owner, nb);
          continue;
        }
        if (restart_interval_) {
          if (restarts_to_go_ == 0) ProcessRestart();
        }
        if (!progressive_)
          DecodeSequential(blocks, owner, nb);
        else if (ss_ == 0)
          ah_ == 0 ? DecodeDcFirst(blocks, owner, nb)
                   : DecodeDcRefine(blocks, nb);
        else
          ah_ == 0 ? DecodeAcFirst(blocks[0]) : DecodeAcRefine(blocks[0]);
        if (restart_interval_) --restarts_to_go_;
      }
    }
  }

  // jdhuff.c process_restart / jdphuff.c process_restart
  void ProcessRestart() {
    bits_.Reset();
    if (in_.unread_marker == 0) in_.NextMarker();
    if (in_.unread_marker == kRST0 + next_restart_num_)
      in_.unread_marker = 0;
    else
      ResyncToRestart(next_restart_num_);
    next_restart_num_ = (next_restart_num_ + 1) & 7;
    for (int& d : last_dc_) d = 0;
    eobrun_ = 0;
    restarts_to_go_ = restart_interval_;
    if (in_.unread_marker == 0) insufficient_ = false;
  }

  // jdmarker.c jpeg_resync_to_restart
  void ResyncToRestart(int desired) {
    int marker = in_.unread_marker;
    for (;;) {
      int action;
      if (marker < kSOF0) {
        action = 2;
      } else if (marker < kRST0 || marker > kRST7) {
        action = 3;
      } else if (marker == kRST0 + ((desired + 1) & 7) ||
                 marker == kRST0 + ((desired + 2) & 7)) {
        action = 3;
      } else if (marker == kRST0 + ((desired - 1) & 7) ||
                 marker == kRST0 + ((desired - 2) & 7)) {
        action = 2;
      } else {
        action = 1;
      }
      if (action == 1) {
        in_.unread_marker = 0;
        return;
      }
      if (action == 3) return;
      in_.NextMarker();
      marker = in_.unread_marker;
    }
  }

  void DecodeSequential(int16_t** blocks, const int* owner, int nb) {
    if (insufficient_) return;  // the rest of the interval stays zero
    Bits bits = bits_;          // in registers for the MCU
    for (int b = 0; b < nb; ++b) {
      const Component& c = comps_[scan_comp_[owner[b]]];
      int16_t* blk = blocks[b];
      int s = Decode(bits, dc_tables_[c.dc_tbl]);
      if (s) s = Extend(bits.Get(s), s);
      s = int(unsigned(s) + unsigned(last_dc_[owner[b]]));
      last_dc_[owner[b]] = s;
      blk[0] = int16_t(s);
      const HuffTable& ac = ac_tables_[c.ac_tbl];
      for (int k = 1; k < 64; ++k) {
        if (bits.n < 32) bits.Fill();
        const int f = ac.fast_ac[bits.acc >> (64 - 9)];
        if (f) {                // code and extra bits at once
          k += (f >> 4) & 15;
          bits.Drop(f & 15);
          blk[kNatural[k]] = int16_t(f >> 8);
          continue;
        }
        s = Decode(bits, ac);
        int r = s >> 4;
        s &= 15;
        if (s) {
          k += r;
          blk[kNatural[k]] = int16_t(Extend(bits.Get(s), s));
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
    }
    bits_ = bits;
  }

  void DecodeDcFirst(int16_t** blocks, const int* owner, int nb) {
    if (insufficient_) return;
    for (int b = 0; b < nb; ++b) {
      const Component& c = comps_[scan_comp_[owner[b]]];
      int s = Decode(bits_, dc_tables_[c.dc_tbl]);
      if (s) s = Extend(bits_.Get(s), s);
      int last = last_dc_[owner[b]];
      if ((last >= 0 && s > INT32_MAX - last) ||
          (last < 0 && s < INT32_MIN - last))
        Error();  // JERR_BAD_DCT_COEF
      s += last;
      last_dc_[owner[b]] = s;
      blocks[b][0] = int16_t(unsigned(s) << al_);
    }
  }

  void DecodeDcRefine(int16_t** blocks, int nb) {
    // no check of insufficient_: zero bits change nothing
    const int p1 = 1 << al_;
    for (int b = 0; b < nb; ++b)
      if (bits_.Get(1)) blocks[b][0] = int16_t(blocks[b][0] | p1);
  }

  void DecodeAcFirst(int16_t* blk) {
    if (insufficient_) return;
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    const HuffTable& t = ac_tables_[comps_[scan_comp_[0]].ac_tbl];
    for (int k = ss_; k <= se_; ++k) {
      int s = Decode(bits_, t);
      int r = s >> 4;
      s &= 15;
      if (s) {
        k += r;
        int v = Extend(bits_.Get(s), s);
        blk[kNatural[k]] = int16_t(unsigned(v) << al_);
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1u << r;
        if (r) eobrun_ += unsigned(bits_.Get(r));
        --eobrun_;
        break;
      }
    }
  }

  void DecodeAcRefine(int16_t* blk) {
    if (insufficient_) return;
    const int p1 = 1 << al_;
    const int m1 = int(unsigned(-1) << al_);
    const HuffTable& t = ac_tables_[comps_[scan_comp_[0]].ac_tbl];
    int k = ss_;
    if (eobrun_ == 0) {
      for (; k <= se_; ++k) {
        int s = Decode(bits_, t);
        int r = s >> 4;
        s &= 15;
        if (s) {
          s = bits_.Get(1) ? p1 : m1;  // a size other than 1 is read as 1
        } else if (r != 15) {
          eobrun_ = 1u << r;
          if (r) eobrun_ += unsigned(bits_.Get(r));
          break;
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (bits_.Get(1) && (*coef & p1) == 0)
              *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
          } else {
            if (--r < 0) break;
          }
          ++k;
        } while (k <= se_);
        if (s) blk[kNatural[k]] = int16_t(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se_; ++k) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0 && bits_.Get(1) && (*coef & p1) == 0)
          *coef = int16_t(*coef >= 0 ? *coef + p1 : *coef + m1);
      }
      --eobrun_;
    }
  }

  // ------------------------------------------------- arithmetic MCUs

  // jdarith.c: decode_mcu, decode_mcu_DC_first, _AC_first, _DC_refine and
  // _AC_refine for one MCU, with its restart processing
  void DecodeArith(int16_t** blocks, const int* owner, int nb) {
    if (restart_interval_) {
      if (restarts_to_go_ == 0) {
        if (in_.unread_marker == 0) in_.NextMarker();
        if (in_.unread_marker == kRST0 + next_restart_num_)
          in_.unread_marker = 0;
        else
          ResyncToRestart(next_restart_num_);
        next_restart_num_ = (next_restart_num_ + 1) & 7;
        ResetStats(false);
        arith_dec_.Reset();
        restarts_to_go_ = restart_interval_;
      }
      --restarts_to_go_;
    }
    const bool dc_refine = progressive_ && ss_ == 0 && ah_ != 0;
    if (arith_dec_.ct == -1 && !dc_refine) return;  // after an error
    if (!progressive_) {
      for (int b = 0; b < nb; ++b) {
        const Component& c = comps_[scan_comp_[owner[b]]];
        if (!ArithDc(owner[b], c.dc_tbl)) return;
        blocks[b][0] = int16_t(last_dc_[owner[b]]);
        if (!ArithAc(blocks[b], c.ac_tbl, 1, 63, 0)) return;
      }
    } else if (ss_ == 0 && ah_ == 0) {
      for (int b = 0; b < nb; ++b) {
        const Component& c = comps_[scan_comp_[owner[b]]];
        if (!ArithDc(owner[b], c.dc_tbl)) return;
        blocks[b][0] = int16_t(unsigned(last_dc_[owner[b]]) << al_);
      }
    } else if (ss_ == 0) {
      const int p1 = 1 << al_;
      for (int b = 0; b < nb; ++b)
        if (arith_dec_.Decode(fixed_bin_))
          blocks[b][0] = int16_t(blocks[b][0] | p1);
    } else if (ah_ == 0) {
      ArithAc(blocks[0], comps_[scan_comp_[0]].ac_tbl, ss_, se_, al_);
    } else {
      ArithAcRefine(blocks[0], comps_[scan_comp_[0]].ac_tbl);
    }
  }

  // Figures F.19, F.21-F.24: one DC difference into last_dc_[ci]; false
  // on a magnitude overflow
  bool ArithDc(int ci, int tbl) {
    Arith& e = arith_dec_;
    uint8_t* st = dc_stats_[tbl] + dc_context_[ci];
    if (e.Decode(st) == 0) {
      dc_context_[ci] = 0;
      return true;
    }
    const int sign = e.Decode(st + 1);
    st += 2 + sign;
    int m = e.Decode(st);
    if (m != 0) {
      st = dc_stats_[tbl] + 20;
      while (e.Decode(st)) {
        if ((m <<= 1) == 0x8000) {
          e.ct = -1;  // JWRN_ARITH_BAD_CODE
          return false;
        }
        st += 1;
      }
    }
    if (m < int((1L << arith_dc_l_[tbl]) >> 1))
      dc_context_[ci] = 0;
    else if (m > int((1L << arith_dc_u_[tbl]) >> 1))
      dc_context_[ci] = 12 + sign * 4;
    else
      dc_context_[ci] = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (e.Decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    last_dc_[ci] = (last_dc_[ci] + v) & 0xffff;
    return true;
  }

  // Figure F.20 over k = ss..se, each value shifted left by al; false on
  // a spectral or magnitude overflow
  bool ArithAc(int16_t* blk, int tbl, int ss, int se, int al) {
    Arith& e = arith_dec_;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (e.Decode(st)) break;  // EOB
      while (e.Decode(st + 1) == 0) {
        st += 3;
        if (++k > se) {
          e.ct = -1;
          return false;
        }
      }
      const int sign = e.Decode(fixed_bin_);
      st += 2;
      int m = e.Decode(st);
      if (m != 0 && e.Decode(st)) {
        m <<= 1;
        st = ac_stats_[tbl] + (k <= arith_ac_k_[tbl] ? 189 : 217);
        while (e.Decode(st)) {
          if ((m <<= 1) == 0x8000) {
            e.ct = -1;
            return false;
          }
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (e.Decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kNatural[k]] = int16_t(unsigned(v) << al);
    }
    return true;
  }

  void ArithAcRefine(int16_t* blk, int tbl) {
    Arith& e = arith_dec_;
    const int p1 = 1 << al_;
    const int m1 = int(unsigned(-1) << al_);
    int kex = se_;
    for (; kex > 0; --kex)
      if (blk[kNatural[kex]]) break;
    for (int k = ss_; k <= se_; ++k) {
      uint8_t* st = ac_stats_[tbl] + 3 * (k - 1);
      if (k > kex && e.Decode(st)) break;  // EOB
      for (;;) {
        int16_t* coef = blk + kNatural[k];
        if (*coef) {
          if (e.Decode(st + 2))
            *coef = int16_t(*coef < 0 ? *coef + m1 : *coef + p1);
          break;
        }
        if (e.Decode(st + 1)) {
          *coef = int16_t(e.Decode(fixed_bin_) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se_) {
          e.ct = -1;
          return;
        }
      }
    }
  }

  // ----------------------------------------------------------- the output

  // jdcoefct.c smoothing_ok: whether to smooth, and the coefficient states
  // it reads (the current ones, and those before each component's last
  // scan, for rows the last scan did not reach)
  bool SmoothingOk() {
    if (!progressive_) return false;
    bool useful = false;
    latch_.assign(size_t(ncomp_) * 10, 0);
    prev_latch_.assign(size_t(ncomp_) * 10, 0);
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    for (int ci = 0; ci < ncomp_; ++ci) {
      const Component& c = comps_[ci];
      if (!c.latched) return false;
      for (int p : kPos)
        if (c.q[p] == 0) return false;
      const int* cb = &coef_bits_[size_t(ci) * 64];
      const int* prev = &prev_coef_bits_[size_t(ci) * 64];
      if (cb[0] < 0) return false;
      latch_[ci * 10] = cb[0];
      for (int k = 1; k < 10; ++k) {
        prev_latch_[ci * 10 + k] = input_scan_number_ > 1 ? prev[k] : -1;
        latch_[ci * 10 + k] = cb[k];
        if (cb[k] != 0) useful = true;
      }
    }
    return useful;
  }

  // the IDCT of every real block of component ci into its plane
  void PlainIdct(Component& c, const int16_t* q, uint8_t* plane,
                 size_t stride) {
    for (int r = 0; r < c.bh; ++r)
      for (int col = 0; col < c.bw; ++col)
        IdctIslow(c.Block(r, col), q, plane + size_t(r) * 8 * stride + col * 8,
                  stride);
  }

  // jdcoefct.c decompress_smooth_data, one component
  void SmoothIdct(int ci, const int16_t* q, uint8_t* plane, size_t stride) {
    Component& c = comps_[ci];
    const int last_row = total_imcu_rows_ - 1;
    const int64_t Q00 = c.q[0], Q01 = c.q[1], Q10 = c.q[8], Q20 = c.q[16],
                  Q11 = c.q[9], Q02 = c.q[2];
    auto predict = [](int64_t qk, int64_t num, int al) {
      int pred;
      if (num >= 0) {
        pred = int(((qk << 7) + num) / (qk << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = int(((qk << 7) - num) / (qk << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      return int16_t(pred);
    };
    int16_t ws[64];
    for (int imcu = 0; imcu < total_imcu_rows_; ++imcu) {
      int block_rows;
      if (imcu < last_row) {
        block_rows = c.v;
      } else {
        block_rows = c.bh % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      const int* cb = imcu > last_good_imcu_row_ ? &prev_latch_[ci * 10]
                                                 : &latch_[ci * 10];
      bool change_dc = true;
      for (int k = 1; k < 10; ++k)
        if (cb[k] != -1) change_dc = false;
      int64_t Q03 = 0, Q12 = 0, Q21 = 0, Q30 = 0;
      if (change_dc) {
        Q03 = c.q[3];
        Q12 = c.q[10];
        Q21 = c.q[17];
        Q30 = c.q[24];
      }
      for (int br = 0; br < block_rows; ++br) {
        // the neighbouring block rows, decided by block and iMCU row as
        // jdcoefct.c decides them (so the second block row of iMCU row 1
        // takes its own predecessor for the one two rows up)
        const int g = imcu * c.v + br;
        const int prev_g = (br > 0 || imcu > 0) ? g - 1 : g;
        const int pprev_g = (br > 1 || imcu > 1) ? g - 2 : prev_g;
        const int next_g =
            (br < block_rows - 1 || imcu < last_row) ? g + 1 : g;
        const int nnext_g =
            (br < block_rows - 2 || imcu + 1 < last_row) ? g + 2 : next_g;
        const int16_t* rows[5] = {c.Block(pprev_g, 0), c.Block(prev_g, 0),
                                  c.Block(g, 0), c.Block(next_g, 0),
                                  c.Block(nnext_g, 0)};
        // DC[row][col]: the sliding 5x5 window, col 2 the current block
        int dc[5][5];
        for (int r = 0; r < 5; ++r)
          for (int k = 0; k < 5; ++k) dc[r][k] = rows[r][0];
        const int last_col = c.bw - 1;
        for (int col = 0; col <= last_col; ++col) {
          std::memcpy(ws, c.Block(g, col), sizeof(ws));
          if (col == 0 && col < last_col)
            for (int r = 0; r < 5; ++r) dc[r][3] = rows[r][64];
          if (col + 1 < last_col)
            for (int r = 0; r < 5; ++r) dc[r][4] = rows[r][(col + 2) * 64];
          const int64_t DC01 = dc[0][0], DC02 = dc[0][1], DC03 = dc[0][2],
                        DC04 = dc[0][3], DC05 = dc[0][4], DC06 = dc[1][0],
                        DC07 = dc[1][1], DC08 = dc[1][2], DC09 = dc[1][3],
                        DC10 = dc[1][4], DC11 = dc[2][0], DC12 = dc[2][1],
                        DC13 = dc[2][2], DC14 = dc[2][3], DC15 = dc[2][4],
                        DC16 = dc[3][0], DC17 = dc[3][1], DC18 = dc[3][2],
                        DC19 = dc[3][3], DC20 = dc[3][4], DC21 = dc[4][0],
                        DC22 = dc[4][1], DC23 = dc[4][2], DC24 = dc[4][3],
                        DC25 = dc[4][4];
          int al;
          if ((al = cb[1]) != 0 && ws[1] == 0) {
            int64_t num =
                Q00 * (change_dc
                           ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 +
                              13 * DC07 - 13 * DC09 + 3 * DC10 - 3 * DC11 +
                              38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 +
                              13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 -
                              DC22 + DC24 + DC25)
                           : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15));
            ws[1] = predict(Q01, num, al);
          }
          if ((al = cb[2]) != 0 && ws[8] == 0) {
            int64_t num =
                Q00 * (change_dc
                           ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 -
                              DC06 + 13 * DC07 + 38 * DC08 + 13 * DC09 -
                              DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                              13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 +
                              3 * DC24 + DC25)
                           : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23));
            ws[8] = predict(Q10, num, al);
          }
          if ((al = cb[3]) != 0 && ws[16] == 0) {
            int64_t num =
                Q00 * (change_dc
                           ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 -
                              5 * DC12 - 14 * DC13 - 5 * DC14 + 2 * DC17 +
                              7 * DC18 + 2 * DC19 + DC23)
                           : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 -
                              DC23));
            ws[16] = predict(Q20, num, al);
          }
          if ((al = cb[4]) != 0 && ws[9] == 0) {
            int64_t num =
                Q00 * (change_dc
                           ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 +
                              9 * DC19 + DC21 - DC25)
                           : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 -
                              DC20 + DC22 - DC24 + DC04 - DC06 + 10 * DC07 -
                              10 * DC09));
            ws[9] = predict(Q11, num, al);
          }
          if ((al = cb[5]) != 0 && ws[2] == 0) {
            int64_t num =
                Q00 * (change_dc
                           ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 +
                              7 * DC12 - 14 * DC13 + 7 * DC14 + DC15 +
                              2 * DC17 - 5 * DC18 + 2 * DC19)
                           : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 -
                              DC15));
            ws[2] = predict(Q02, num, al);
          }
          if (change_dc) {
            if ((al = cb[6]) != 0 && ws[3] == 0)
              ws[3] = predict(Q03,
                              Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 +
                                     DC17 - DC19),
                              al);
            if ((al = cb[7]) != 0 && ws[10] == 0)
              ws[10] = predict(Q12,
                               Q00 * (DC07 - 3 * DC08 + DC09 - DC17 +
                                      3 * DC18 - DC19),
                               al);
            if ((al = cb[8]) != 0 && ws[17] == 0)
              ws[17] = predict(Q21,
                               Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 +
                                      DC17 - DC19),
                               al);
            if ((al = cb[9]) != 0 && ws[24] == 0)
              ws[24] = predict(Q30,
                               Q00 * (DC07 + 2 * DC08 + DC09 - DC17 -
                                      2 * DC18 - DC19),
                               al);
            int64_t num =
                Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 -
                       2 * DC05 - 6 * DC06 + 6 * DC07 + 42 * DC08 +
                       6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 +
                       152 * DC13 + 42 * DC14 - 8 * DC15 - 6 * DC16 +
                       6 * DC17 + 42 * DC18 + 6 * DC19 - 6 * DC20 -
                       2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25);
            ws[0] = predict(Q00, num, 0);
          }
          IdctIslow(ws, q, plane + size_t(g) * 8 * stride + col * 8, stride);
          for (int r = 0; r < 5; ++r) {
            dc[r][0] = dc[r][1];
            dc[r][1] = dc[r][2];
            dc[r][2] = dc[r][3];
            dc[r][3] = dc[r][4];
          }
        }
      }
    }
  }

  // row y of component plane p (dw x dh valid, row stride ps) upsampled
  // to the image's width by jdsample.c's method for its ratio: a row of
  // p itself at 1:1, else written to `row` (2 * dw wide at least); both
  // returned
  const uint8_t* UpsampleRow(const Component& c, const uint8_t* p,
                             size_t ps, int y, uint8_t* row) const {
    const int W = width_;
    const int hi = c.h, vi = c.v, ho = max_h_, vo = max_v_;
    const int dw = c.dw, dh = c.dh;
    if (hi == ho && vi == vo) return p + size_t(y) * ps;
    const bool h2v1 = hi * 2 == ho && vi == vo;
    const bool h1v2 = hi == ho && vi * 2 == vo;
    const bool h2v2 = hi * 2 == ho && vi * 2 == vo;
    if (h2v1 && dw > 2) {
      const uint8_t* in = p + size_t(y) * ps;
      row[0] = in[0];
      row[1] = uint8_t((in[0] * 3 + in[1] + 2) >> 2);
      for (int j = 1; j < dw - 1; ++j) {
        int v = in[j] * 3;
        row[2 * j] = uint8_t((v + in[j - 1] + 1) >> 2);
        row[2 * j + 1] = uint8_t((v + in[j + 1] + 2) >> 2);
      }
      int v = in[dw - 1];
      row[2 * dw - 2] = uint8_t((v * 3 + in[dw - 2] + 1) >> 2);
      row[2 * dw - 1] = uint8_t(v);
      return row;
    }
    if (h2v2 && dw > 2) {
      int i = y / 2;
      int f = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      const uint8_t* near = p + size_t(i) * ps;
      const uint8_t* far = p + size_t(f) * ps;
      auto colsum = [&](int j) { return near[j] * 3 + far[j]; };
      int t = colsum(0), nx = colsum(1);
      row[0] = uint8_t((t * 4 + 8) >> 4);
      row[1] = uint8_t((t * 3 + nx + 7) >> 4);
      for (int j = 1; j < dw - 1; ++j) {
        const int cur = colsum(j);
        row[2 * j] = uint8_t((cur * 3 + colsum(j - 1) + 8) >> 4);
        row[2 * j + 1] = uint8_t((cur * 3 + colsum(j + 1) + 7) >> 4);
      }
      t = colsum(dw - 1);
      row[2 * dw - 2] = uint8_t((t * 3 + colsum(dw - 2) + 8) >> 4);
      row[2 * dw - 1] = uint8_t((t * 4 + 7) >> 4);
      return row;
    }
    if (h1v2) {
      int i = y / 2;
      int f = (y & 1) ? std::min(i + 1, dh - 1) : std::max(i - 1, 0);
      int bias = (y & 1) ? 2 : 1;
      const uint8_t* near = p + size_t(i) * ps;
      const uint8_t* far = p + size_t(f) * ps;
      for (int x = 0; x < W; ++x)
        row[x] = uint8_t((near[x] * 3 + far[x] + bias) >> 2);
      return row;
    }
    // box replication: h2v1/h2v2 of narrow components, other ratios
    const int he = ho / hi, ve = vo / vi;
    const uint8_t* in = p + size_t(y / ve) * ps;
    for (int x = 0; x < W; ++x) row[x] = in[x / he];
    return row;
  }

  // every component's IDCT into its plane, then row by row the upsampling
  // and the colour conversion
  void Output(ColorSpace cs, std::vector<uint8_t>* rgb) {
    const bool smooth = SmoothingOk();
    const int W = width_;
    std::vector<std::unique_ptr<uint8_t[]>> planes(ncomp_);
    std::vector<size_t> strides(ncomp_);
    for (int ci = 0; ci < ncomp_; ++ci) {
      Component& c = comps_[ci];
      const size_t stride = size_t(c.bw) * 8, size = stride * c.bh * 8;
      planes[ci].reset(new uint8_t[size]);
      strides[ci] = stride;
      if (!c.latched) {  // no scan of it: its zero table gives mid grey
        std::memset(planes[ci].get(), 128, size);
      } else {
        int16_t q[64];
        for (int i = 0; i < 64; ++i) q[i] = int16_t(c.q[i]);
        if (smooth)
          SmoothIdct(ci, q, planes[ci].get(), stride);
        else
          PlainIdct(c, q, planes[ci].get(), stride);
      }
    }
    rgb->resize(size_t(W) * height_ * 3);
    // a row per component (room for 2 * dw >= W), then R, G, B planar
    std::vector<uint8_t> rows(size_t(ncomp_ + 3) * (W + 16));
    uint8_t* r_out = rows.data() + size_t(ncomp_) * (W + 16);
    uint8_t* g_out = r_out + W + 16;
    uint8_t* b_out = g_out + W + 16;
    const uint8_t* in[3] = {nullptr, nullptr, nullptr};
    for (int y = 0; y < height_; ++y) {
      for (int ci = 0; ci < ncomp_; ++ci)
        in[ci] = UpsampleRow(comps_[ci], planes[ci].get(), strides[ci], y,
                             rows.data() + size_t(ci) * (W + 16));
      uint8_t* o = rgb->data() + size_t(y) * W * 3;
      if (cs == kGray) {
        for (int x = 0; x < W; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] =
            in[0][x];
        continue;
      }
      if (cs == kYCbCr) {
        YccToRgb(in[0], in[1], in[2], r_out, g_out, b_out, W);
        in[0] = r_out;
        in[1] = g_out;
        in[2] = b_out;
      }
      for (int x = 0; x < W; ++x) {
        o[3 * x] = in[0][x];
        o[3 * x + 1] = in[1][x];
        o[3 * x + 2] = in[2][x];
      }
    }
  }

  // jdcolor.c build_ycc_rgb_table and ycc_rgb_convert over n pixels, to
  // planar R, G, B, each table entry computed where it is used (every sum
  // fits in 32 bits) so that the compiler runs the pixels in vector lanes
  static void YccToRgb(const uint8_t* __restrict y_in,
                       const uint8_t* __restrict cb_in,
                       const uint8_t* __restrict cr_in,
                       uint8_t* __restrict r_out, uint8_t* __restrict g_out,
                       uint8_t* __restrict b_out, int n) {
    constexpr int kScale = 16;
    constexpr int32_t kHalf = int32_t(1) << (kScale - 1);
    auto fix = [](double x) { return int32_t(x * (1L << kScale) + 0.5); };
    const int32_t kCrR = fix(1.40200), kCbB = fix(1.77200),
                  kCrG = fix(0.71414), kCbG = fix(0.34414);
    auto clamp = [](int32_t v) {
      return uint8_t(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    for (int i = 0; i < n; ++i) {
      const int32_t y = y_in[i], cb = int32_t(cb_in[i]) - 128,
                    cr = int32_t(cr_in[i]) - 128;
      r_out[i] = clamp(y + ((kCrR * cr + kHalf) >> kScale));
      g_out[i] = clamp(y + ((kHalf - kCbG * cb - kCrG * cr) >> kScale));
      b_out[i] = clamp(y + ((kCbB * cb + kHalf) >> kScale));
    }
  }

  Input in_;
  Bits bits_;
  bool insufficient_ = false;

  bool saw_soi_ = false, saw_sof_ = false;
  bool progressive_ = false, arith_ = false;
  int precision_ = 0, width_ = 0, height_ = 0, ncomp_ = 0;
  std::vector<Component> comps_;
  uint16_t qt_[4][64] = {};
  bool qt_present_[4] = {false, false, false, false};
  HuffSpec dc_spec_[4], ac_spec_[4];
  HuffTable dc_tables_[4], ac_tables_[4];
  int restart_interval_ = 0;
  bool saw_jfif_ = false, saw_adobe_ = false;
  int adobe_transform_ = 0;

  int comps_in_scan_ = 0;
  int scan_comp_[4] = {-1, -1, -1, -1};
  int ss_ = 0, se_ = 0, ah_ = 0, al_ = 0;
  int next_restart_num_ = 0;
  int input_scan_number_ = 0;
  int max_h_ = 1, max_v_ = 1, total_imcu_rows_ = 0;
  bool multiple_scans_ = false;
  int mcus_per_row_ = 0, mcu_rows_ = 0;
  int restarts_to_go_ = 0;
  unsigned eobrun_ = 0;
  int last_dc_[4] = {0, 0, 0, 0};
  int last_good_imcu_row_ = 0;

  // arithmetic decoding: the registers, the DAC conditioning and the
  // statistics bins
  Arith arith_dec_;
  int arith_dc_l_[16] = {0}, arith_dc_u_[16] = {0}, arith_ac_k_[16] = {0};
  int dc_context_[4] = {0, 0, 0, 0};
  uint8_t dc_stats_[16][64] = {};
  uint8_t ac_stats_[16][256] = {};
  uint8_t fixed_bin_[4] = {113, 0, 0, 0};

  std::vector<int> coef_bits_, prev_coef_bits_;  // progressive state
  std::vector<int> latch_, prev_latch_;          // smoothing_ok's copies
};

}  // namespace

bool DecodeJpeg(const uint8_t* data, size_t size, bool header_only,
                int* width, int* height, std::vector<uint8_t>* rgb,
                bool* ran_out) {
  Decoder dec(data, size);
  bool ok = true;
  try {
    dec.ReadHeader();
    if (!header_only) dec.Decompress(rgb);
    *width = dec.width();
    *height = dec.height();
  } catch (const Fail&) {
    ok = false;
  } catch (const std::bad_alloc&) {
    ok = false;
  }
  if (ran_out) *ran_out = dec.ran_out();
  return ok;
}

}  // namespace wdm
