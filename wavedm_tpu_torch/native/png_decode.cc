// PNG decoder of the port's data library (see png_decode.h).
//
// It reads a file as libpng 1.6's sequential reader does, so it accepts and
// refuses what libpng does and gives the same pixels:
//   - png_read_info: the signature, then chunk by chunk up to the first
//     IDAT: the chunk header checks (length, name, size limits), IHDR and
//     its validation, PLTE (truncated to 2^depth entries, the table kept
//     at 256 zeroed entries, so an index past it reads black), ancillary
//     chunks read and dropped (a CRC error in one only warns), an unknown
//     critical chunk refused, a CRC error in a critical chunk refused;
//   - png_read_image: one inflate call a row (Adam7 pass by pass, each
//     pass's first row filtered against zeros), its input taken from the
//     IDAT chunks in windows of at most 8192 bytes, so zlib meets the end
//     of the stream, and its Adler-32 check, exactly where it does under
//     libpng: during the last row a bad check fails the image, after it
//     (the stream's end in a later window) only a warning;
//   - png_read_finish_IDAT: the rest of the last IDAT read and its CRC
//     checked; nothing after it is read;
//   - the transforms: 16-bit samples keep their high byte, grey of 1, 2
//     or 4 bits is scaled to 8, palette indices are looked up, grey is
//     copied to R, G and B, alpha and tRNS are dropped.

#include "png_decode.h"

#include <zlib.h>

#include <algorithm>
#include <cstring>

namespace wdm {
namespace {

struct Fail {};

[[noreturn]] void Error() { throw Fail(); }

constexpr uint32_t ChunkName(const char* s) {
  return (uint32_t(uint8_t(s[0])) << 24) | (uint32_t(uint8_t(s[1])) << 16) |
         (uint32_t(uint8_t(s[2])) << 8) | uint32_t(uint8_t(s[3]));
}

constexpr uint32_t kIHDR = ChunkName("IHDR"), kPLTE = ChunkName("PLTE"),
                   kIDAT = ChunkName("IDAT"), kIEND = ChunkName("IEND");

// the ancillary chunks libpng has handlers for: each refuses to come
// before IHDR
constexpr uint32_t kKnownAncillary[] = {
    ChunkName("bKGD"), ChunkName("cHRM"), ChunkName("eXIf"),
    ChunkName("gAMA"), ChunkName("hIST"), ChunkName("iCCP"),
    ChunkName("iTXt"), ChunkName("oFFs"), ChunkName("pCAL"),
    ChunkName("pHYs"), ChunkName("sBIT"), ChunkName("sCAL"),
    ChunkName("sPLT"), ChunkName("sRGB"), ChunkName("tEXt"),
    ChunkName("tIME"), ChunkName("tRNS"), ChunkName("zTXt")};

constexpr uint8_t kSignature[8] = {137, 80, 78, 71, 13, 10, 26, 10};
constexpr uint32_t kIdatReadSize = 8192;    // PNG_IDAT_READ_SIZE
constexpr uint32_t kChunkMallocMax = 8000000;  // PNG_USER_CHUNK_MALLOC_MAX
constexpr uint32_t kUserDimMax = 1000000;   // PNG_USER_WIDTH/HEIGHT_MAX
constexpr uint32_t kUint31Max = 0x7fffffffu;

inline uint32_t Be32(const uint8_t* b) {
  return (uint32_t(b[0]) << 24) | (uint32_t(b[1]) << 16) |
         (uint32_t(b[2]) << 8) | uint32_t(b[3]);
}

struct Header {
  uint32_t width = 0, height = 0;
  int depth = 0, color_type = 0, interlace = 0, channels = 0;
};

// The file as libpng reads it: exact reads that fail past the end, and the
// running CRC of the current chunk.
struct Stream {
  const uint8_t* data;
  size_t size;
  size_t pos = 0;
  uint32_t crc = 0;
  uint32_t chunk = 0;
  const Header* hdr = nullptr;

  const uint8_t* Take(size_t n) {
    if (size - pos < n) Error();  // "Read Error"
    const uint8_t* p = data + pos;
    pos += n;
    return p;
  }
  // png_crc_read
  const uint8_t* CrcTake(size_t n) {
    const uint8_t* p = Take(n);
    crc = uint32_t(crc32(crc, p, uInt(n)));
    return p;
  }
  // png_read_chunk_header, its length, name and size checks included
  uint32_t ChunkHeader() {
    const uint8_t* b = Take(8);
    uint32_t length = Be32(b);
    if (length > kUint31Max) Error();
    chunk = Be32(b + 4);
    crc = uint32_t(crc32(0, b + 4, 4));
    for (int i = 0; i < 4; ++i) {
      int c = b[4 + i];
      if (c < 65 || c > 122 || (c > 90 && c < 97)) Error();
    }
    uint64_t limit = kChunkMallocMax;
    if (chunk == kIDAT) {
      uint64_t idat_limit;
      uint64_t row_factor = uint64_t(hdr->width) * hdr->channels *
                                (hdr->depth > 8 ? 2 : 1) +
                            1 + (hdr->interlace ? 6 : 0);
      if (hdr->height > 0xffffffffull / row_factor)
        idat_limit = kUint31Max;
      else
        idat_limit = hdr->height * row_factor;
      row_factor = std::min<uint64_t>(row_factor, 32566);
      idat_limit += 6 + 5 * (idat_limit / row_factor + 1);
      idat_limit = std::min<uint64_t>(idat_limit, kUint31Max);
      limit = std::max(limit, idat_limit);
    }
    if (length > limit) Error();  // "chunk data is too large"
    return length;
  }
  // png_crc_finish: read the rest of the chunk and its CRC.  A mismatch
  // fails a critical chunk; an ancillary one is only warned of.
  void CrcFinish(uint32_t skip) {
    CrcTake(skip);
    uint32_t want = Be32(Take(4));
    if (want != crc && !((chunk >> 29) & 1)) Error();
  }
};

// png_read_IDAT_data and png_read_finish_IDAT
struct Idat {
  Stream* s;
  z_stream zs;
  uint32_t idat_size;
  bool ended = false;

  Idat(Stream* stream, uint32_t first_length)
      : s(stream), idat_size(first_length) {
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, 0) != Z_OK) Error();  // the header's window
  }
  ~Idat() { inflateEnd(&zs); }

  void Refill() {
    while (idat_size == 0) {
      s->CrcFinish(0);
      idat_size = s->ChunkHeader();
      if (s->chunk != kIDAT) Error();  // "Not enough image data"
    }
    uint32_t n = std::min(kIdatReadSize, idat_size);
    zs.next_in = const_cast<Bytef*>(s->CrcTake(n));
    zs.avail_in = n;
    idat_size -= n;
  }

  void ReadRow(uint8_t* out, size_t n) {
    zs.next_out = out;
    size_t avail_out = n;
    do {
      if (zs.avail_in == 0) Refill();
      zs.avail_out = uInt(avail_out);
      avail_out = 0;
      int ret = inflate(&zs, Z_NO_FLUSH);
      avail_out += zs.avail_out;
      zs.avail_out = 0;
      if (ret == Z_STREAM_END) {
        ended = true;  // extra data after it only warns
        break;
      }
      if (ret != Z_OK) Error();
    } while (avail_out > 0);
    if (avail_out > 0) Error();  // the stream ended before the image
  }

  void Finish() {
    if (!ended) {  // look for the stream's end: problems only warn
      uint8_t tmp[1024];  // PNG_INFLATE_BUF_SIZE
      size_t extra = 0;
      do {
        if (zs.avail_in == 0) Refill();
        zs.next_out = tmp;
        zs.avail_out = sizeof(tmp);
        int ret = inflate(&zs, Z_NO_FLUSH);
        extra += sizeof(tmp) - zs.avail_out;
        zs.avail_out = 0;
        if (ret == Z_STREAM_END || ret != Z_OK) break;
      } while (extra > 0);
      ended = true;
    }
    s->CrcFinish(idat_size);
  }
};

// png_read_info: the signature and the chunks up to the first IDAT.
// Returns the first IDAT's length; fills the header and the palette.
uint32_t ReadInfo(Stream* s, Header* h, uint8_t palette[256][3]) {
  const uint8_t* sig = s->Take(8);
  if (std::memcmp(sig, kSignature, 8) != 0) Error();
  bool have_ihdr = false, have_plte = false;
  for (;;) {
    uint32_t length = s->ChunkHeader();
    uint32_t name = s->chunk;
    if (name == kIDAT) {
      if (!have_ihdr) Error();
      if (h->color_type == 3 && !have_plte) Error();
      return length;
    }
    if (name == kIHDR) {
      if (have_ihdr || length != 13) Error();
      have_ihdr = true;
      const uint8_t* b = s->CrcTake(13);
      s->CrcFinish(0);
      uint32_t w = Be32(b), ht = Be32(b + 4);
      if (w > kUint31Max || ht > kUint31Max) Error();
      int depth = b[8], ct = b[9];
      bool bad = false;
      if (w == 0 || w > kUserDimMax || ht == 0 || ht > kUserDimMax)
        bad = true;
      if (depth != 1 && depth != 2 && depth != 4 && depth != 8 &&
          depth != 16)
        bad = true;
      if (ct == 1 || ct == 5 || ct > 6) bad = true;
      if ((ct == 3 && depth > 8) ||
          ((ct == 2 || ct == 4 || ct == 6) && depth < 8))
        bad = true;
      if (b[12] > 1 || b[10] != 0 || b[11] != 0) bad = true;
      if (bad) Error();  // "Invalid IHDR data"
      h->width = w;
      h->height = ht;
      h->depth = depth;
      h->color_type = ct;
      h->interlace = b[12];
      static const int kChannels[7] = {1, 0, 3, 1, 2, 0, 4};
      h->channels = kChannels[ct];
    } else if (name == kIEND) {
      Error();  // "out of place": no IDAT yet
    } else if (name == kPLTE) {
      if (!have_ihdr || have_plte) Error();
      have_plte = true;
      if (!(h->color_type & 2)) {  // ignored in grey images
        s->CrcFinish(length);
        continue;
      }
      if (length > 768 || length % 3) {
        s->CrcFinish(length);
        if (h->color_type == 3) Error();
        continue;
      }
      int num = int(length / 3);
      int max_len = h->color_type == 3 ? (1 << h->depth) : 256;
      num = std::min(num, max_len);
      const uint8_t* p = s->CrcTake(size_t(num) * 3);
      s->CrcFinish(length - uint32_t(num) * 3);
      if (num == 0) Error();  // "Invalid palette"
      if (h->color_type == 3) std::memcpy(palette, p, size_t(num) * 3);
    } else {
      bool known = false;
      for (uint32_t k : kKnownAncillary) known = known || k == name;
      if (known && !have_ihdr) Error();  // "missing IHDR"
      s->CrcFinish(length);
      if (!((name >> 29) & 1)) Error();  // "unhandled critical chunk"
    }
  }
}

inline uint8_t Paeth(int a, int b, int c) {
  int pa = std::abs(b - c), pb = std::abs(a - c), pc = std::abs(a + b - 2 * c);
  if (pa <= pb && pa <= pc) return uint8_t(a);
  return uint8_t(pb <= pc ? b : c);
}

void Unfilter(int filter, uint8_t* row, const uint8_t* prev, size_t n,
              int bpp) {
  switch (filter) {
    case 0:
      return;
    case 1:
      for (size_t i = bpp; i < n; ++i) row[i] = uint8_t(row[i] + row[i - bpp]);
      return;
    case 2:
      for (size_t i = 0; i < n; ++i) row[i] = uint8_t(row[i] + prev[i]);
      return;
    case 3:
      for (size_t i = 0; i < n; ++i) {
        int a = i >= size_t(bpp) ? row[i - bpp] : 0;
        row[i] = uint8_t(row[i] + ((a + prev[i]) >> 1));
      }
      return;
    case 4:
      for (size_t i = 0; i < n; ++i) {
        int a = i >= size_t(bpp) ? row[i - bpp] : 0;
        int c = i >= size_t(bpp) ? prev[i - bpp] : 0;
        row[i] = uint8_t(row[i] + Paeth(a, prev[i], c));
      }
      return;
    default:
      Error();  // "bad adaptive filter value"
  }
}

// one pixel of an unfiltered row -> RGB under JAX's transforms
inline void Pixel(const Header& h, const uint8_t* row, uint32_t i,
                  const uint8_t palette[256][3], uint8_t* out) {
  const int d = h.depth;
  if (h.color_type == 0 || h.color_type == 3) {
    int v;
    if (d == 16) {
      v = row[2 * i];
    } else if (d == 8) {
      v = row[i];
    } else {
      int per = 8 / d;
      int shift = 8 - d * (int(i % per) + 1);
      v = (row[i / per] >> shift) & ((1 << d) - 1);
    }
    if (h.color_type == 3) {
      std::memcpy(out, palette[v], 3);
      return;
    }
    if (d < 8) v = v * (d == 1 ? 255 : d == 2 ? 85 : 17);
    out[0] = out[1] = out[2] = uint8_t(v);
    return;
  }
  const int bytes = d / 8;  // 1 or 2: the high byte comes first
  const uint8_t* p = row + size_t(i) * h.channels * bytes;
  if (h.color_type == 4) {
    out[0] = out[1] = out[2] = p[0];
  } else {  // 2 or 6
    out[0] = p[0];
    out[1] = p[bytes];
    out[2] = p[2 * bytes];
  }
}

}  // namespace

bool IsPng(const uint8_t* data, size_t size) {
  return size >= 8 && std::memcmp(data, kSignature, 8) == 0;
}

bool DecodePng(const uint8_t* data, size_t size, bool header_only,
               int* width, int* height, std::vector<uint8_t>* rgb) {
  try {
    Header h;
    Stream s{data, size};
    s.hdr = &h;
    uint8_t palette[256][3];
    std::memset(palette, 0, sizeof(palette));
    uint32_t first = ReadInfo(&s, &h, palette);
    if (header_only) {
      *width = int(h.width);
      *height = int(h.height);
      return true;
    }
    const uint32_t W = h.width, H = h.height;
    rgb->assign(size_t(W) * H * 3, 0);
    const int pixel_bits = h.depth * h.channels;
    const int bpp = (pixel_bits + 7) / 8;
    static const int kPass[7][4] = {{0, 0, 8, 8}, {4, 0, 8, 8}, {0, 4, 4, 8},
                                    {2, 0, 4, 4}, {0, 2, 2, 4}, {1, 0, 2, 2},
                                    {0, 1, 1, 2}};
    static const int kWhole[1][4] = {{0, 0, 1, 1}};
    const int (*passes)[4] = h.interlace ? kPass : kWhole;
    const int npass = h.interlace ? 7 : 1;
    Idat idat(&s, first);
    std::vector<uint8_t> row, prev;
    for (int p = 0; p < npass; ++p) {
      const uint32_t x0 = passes[p][0], y0 = passes[p][1];
      const uint32_t dx = passes[p][2], dy = passes[p][3];
      if (x0 >= W || y0 >= H) continue;  // an empty pass
      const uint32_t pw = (W - x0 + dx - 1) / dx;
      const size_t rowbytes = (size_t(pw) * pixel_bits + 7) / 8;
      row.assign(rowbytes + 1, 0);
      prev.assign(rowbytes + 1, 0);
      for (uint32_t y = y0; y < H; y += dy) {
        idat.ReadRow(row.data(), rowbytes + 1);
        Unfilter(row[0], row.data() + 1, prev.data() + 1, rowbytes, bpp);
        uint8_t* out = rgb->data() + size_t(y) * W * 3;
        for (uint32_t i = 0; i < pw; ++i)
          Pixel(h, row.data() + 1, i, palette, out + size_t(x0 + i * dx) * 3);
        std::swap(row, prev);
      }
    }
    idat.Finish();
    *width = int(W);
    *height = int(H);
    return true;
  } catch (const Fail&) {
    return false;
  } catch (const std::bad_alloc&) {
    return false;
  }
}

}  // namespace wdm
