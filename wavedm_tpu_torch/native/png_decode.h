// PNG decoder of the port's data library: every colour type and bit depth,
// Adam7 included, to 8-bit RGB over zlib's inflate, equal to the byte to
// what libpng 1.6 gives under png_set_strip_16, png_set_palette_to_rgb,
// png_set_expand_gray_1_2_4_to_8, png_set_tRNS_to_alpha,
// png_set_gray_to_rgb and png_set_strip_alpha, read with png_read_image.
//
// Reentrant: every call keeps its state on its own stack and heap.

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace wdm {

// True when the 8 bytes at `data` are the PNG signature.
bool IsPng(const uint8_t* data, size_t size);

// Decode the `size` bytes at `data`.  With header_only, stop once the
// chunks before the first IDAT are read, with only *width and *height set.
// Returns false where libpng fails: data that ends early, a bad IHDR, a
// CRC error in a critical chunk, a zlib stream that is corrupt or ends
// before the image, an unknown critical chunk.
bool DecodePng(const uint8_t* data, size_t size, bool header_only,
               int* width, int* height, std::vector<uint8_t>* rgb);

}  // namespace wdm
