// JPEG decoder of the port's data library: baseline, extended and
// progressive JPEG, Huffman or arithmetic coded, to 8-bit RGB, equal to the
// byte to what libjpeg-turbo 2.1 gives with jpeg_read_header,
// out_color_space = JCS_RGB and every other setting at its default
// (integer IDCT, fancy upsampling, block smoothing), scanlines read one at
// a time.
//
// Reentrant: every call keeps its state on its own stack and heap.

#pragma once

#include <cstddef>
#include <cstdint>
#include <vector>

namespace wdm {

// Decode the `size` bytes at `data`.  With header_only, stop at the first
// scan with only *width and *height set.  Data that ends before the
// decoder is done is read on as libjpeg's data sources read it (an EOI
// marker after the end), and *ran_out says that it did.  Returns false
// where libjpeg fails: a malformed stream, 12-bit samples, lossless or
// hierarchical frames, sampling ratios that are not whole numbers, and
// colour spaces other than grey, YCbCr and RGB (CMYK, YCCK).
bool DecodeJpeg(const uint8_t* data, size_t size, bool header_only,
                int* width, int* height, std::vector<uint8_t>* rgb,
                bool* ran_out);

}  // namespace wdm
