// WaveDM data library of the PyTorch port: JPEG/PNG decode and the
// training crop stream, with a plain C interface loaded through ctypes
// (wavedm_tpu_torch/data/native_loader.py; built by native/build.py).
//
// The port's own copy of the JAX package's native/dataloader/wavedm_data.cc.
// wdm_decode_image and wdm_make_crop_batch keep that library's ABI and
// results to the byte: the same libjpeg/libpng transforms, `* (1.0f/255)`,
// the worker pool over an atomic index and the per-slot
// mt19937_64(Mix(seed, slot)) crop coordinates, y before x.  Two changes:
//   - wdm_make_crop_batch skips a pair smaller than the patch, as it skips
//     one that fails to decode (the JAX copy reads past the image there);
//   - wdm_image_size_mem and wdm_decode_mem decode from memory to uint8,
//     for request bodies: the header's size first, so the caller
//     allocates exactly, then the pixels.  A JPEG body that ends before
//     its image does fails there (as PIL refuses it), where the file
//     route, like the JAX copy, takes libjpeg's grey fill.

#include <cstddef>  // jpeglib.h needs size_t and FILE declared first
#include <cstdio>

#include <jpeglib.h>
#include <jerror.h>  // JWRN_JPEG_EOF
#include <png.h>

#include <atomic>
#include <csetjmp>
#include <cstdint>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

#define WDM_STR2(x) #x
#define WDM_STR(x) WDM_STR2(x)
#ifndef WAVEDM_SRC_HASH
#define WAVEDM_SRC_HASH unversioned
#endif
// native/build.py passes the source hash as -DWAVEDM_SRC_HASH and finds
// this string in the library to tell a current build from a stale one
extern "C" const char wdm_src_hash[] =
    "wavedm-src-hash=" WDM_STR(WAVEDM_SRC_HASH);

namespace {

struct Image {
  int w = 0, h = 0;
  std::vector<uint8_t> rgb;  // h*w*3
  bool ok = false;
};

// Where the encoded bytes come from: an open file, or a buffer.
struct Source {
  FILE* file = nullptr;
  const uint8_t* data = nullptr;
  size_t size = 0;
  size_t pos = 0;
};

// ----------------------------------------------------------------- JPEG

struct JpegErrorMgr {
  jpeg_error_mgr pub;
  jmp_buf setjmp_buffer;
  void (*default_emit)(j_common_ptr, int) = nullptr;
  bool ended_early = false;  // the data ended before the image did
};

void JpegErrorExit(j_common_ptr cinfo) {
  auto* mgr = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  longjmp(mgr->setjmp_buffer, 1);
}

void JpegEmitMessage(j_common_ptr cinfo, int msg_level) {
  auto* mgr = reinterpret_cast<JpegErrorMgr*>(cinfo->err);
  if (msg_level < 0 && cinfo->err->msg_code == JWRN_JPEG_EOF)
    mgr->ended_early = true;
  mgr->default_emit(cinfo, msg_level);
}

// header_only: stop after the header, with only w and h set.
bool DecodeJpeg(Source* src, Image* out, bool header_only) {
  jpeg_decompress_struct cinfo;
  JpegErrorMgr jerr;
  cinfo.err = jpeg_std_error(&jerr.pub);
  jerr.pub.error_exit = JpegErrorExit;
  jerr.default_emit = jerr.pub.emit_message;
  jerr.pub.emit_message = JpegEmitMessage;
  if (setjmp(jerr.setjmp_buffer)) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  jpeg_create_decompress(&cinfo);
  if (src->file)
    jpeg_stdio_src(&cinfo, src->file);
  else
    jpeg_mem_src(&cinfo, src->data, static_cast<unsigned long>(src->size));
  if (jpeg_read_header(&cinfo, TRUE) != JPEG_HEADER_OK) {
    jpeg_destroy_decompress(&cinfo);
    return false;
  }
  if (header_only) {
    out->w = cinfo.image_width;
    out->h = cinfo.image_height;
    jpeg_destroy_decompress(&cinfo);
    return true;
  }
  cinfo.out_color_space = JCS_RGB;
  jpeg_start_decompress(&cinfo);
  out->w = cinfo.output_width;
  out->h = cinfo.output_height;
  out->rgb.resize(size_t(out->w) * out->h * 3);
  while (cinfo.output_scanline < cinfo.output_height) {
    uint8_t* row = out->rgb.data() + size_t(cinfo.output_scanline) * out->w * 3;
    jpeg_read_scanlines(&cinfo, &row, 1);
  }
  jpeg_finish_decompress(&cinfo);
  jpeg_destroy_decompress(&cinfo);
  // from memory, a body cut short is refused; a file is taken as JAX's is
  out->ok = src->file || !jerr.ended_early;
  return out->ok;
}

// ------------------------------------------------------------------ PNG

void PngReadMem(png_structp png, png_bytep dst, png_size_t n) {
  auto* src = static_cast<Source*>(png_get_io_ptr(png));
  if (src->size - src->pos < n) png_error(png, "read past the end of data");
  std::memcpy(dst, src->data + src->pos, n);
  src->pos += n;
}

bool DecodePng(Source* src, Image* out, bool header_only) {
  png_structp png =
      png_create_read_struct(PNG_LIBPNG_VER_STRING, nullptr, nullptr, nullptr);
  if (!png) return false;
  png_infop info = png_create_info_struct(png);
  if (!info) {
    png_destroy_read_struct(&png, nullptr, nullptr);
    return false;
  }
  std::vector<png_bytep> rows;  // before setjmp: a longjmp skips no destructor
  if (setjmp(png_jmpbuf(png))) {
    png_destroy_read_struct(&png, &info, nullptr);
    return false;
  }
  if (src->file)
    png_init_io(png, src->file);
  else
    png_set_read_fn(png, src, PngReadMem);
  png_read_info(png, info);
  png_uint_32 w, h;
  int bit_depth, color_type;
  png_get_IHDR(png, info, &w, &h, &bit_depth, &color_type, nullptr, nullptr,
               nullptr);
  if (header_only) {
    out->w = int(w);
    out->h = int(h);
    png_destroy_read_struct(&png, &info, nullptr);
    return true;
  }
  if (bit_depth == 16) png_set_strip_16(png);
  if (color_type == PNG_COLOR_TYPE_PALETTE) png_set_palette_to_rgb(png);
  if (color_type == PNG_COLOR_TYPE_GRAY && bit_depth < 8)
    png_set_expand_gray_1_2_4_to_8(png);
  if (png_get_valid(png, info, PNG_INFO_tRNS)) png_set_tRNS_to_alpha(png);
  if (color_type == PNG_COLOR_TYPE_GRAY ||
      color_type == PNG_COLOR_TYPE_GRAY_ALPHA)
    png_set_gray_to_rgb(png);
  if (color_type & PNG_COLOR_MASK_ALPHA) png_set_strip_alpha(png);
  png_read_update_info(png, info);

  out->w = int(w);
  out->h = int(h);
  out->rgb.resize(size_t(w) * h * 3);
  rows.resize(h);
  for (png_uint_32 y = 0; y < h; ++y)
    rows[y] = out->rgb.data() + size_t(y) * w * 3;
  png_read_image(png, rows.data());
  png_destroy_read_struct(&png, &info, nullptr);
  out->ok = true;
  return true;
}

// Dispatch on the signature: FF D8 is JPEG, the 8-byte signature PNG.
bool Decode(Source* src, const uint8_t* magic, size_t n, Image* out,
            bool header_only) {
  if (n >= 2 && magic[0] == 0xFF && magic[1] == 0xD8)
    return DecodeJpeg(src, out, header_only);
  if (n >= 8 && png_sig_cmp(magic, 0, 8) == 0)
    return DecodePng(src, out, header_only);
  return false;
}

bool DecodeFile(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  uint8_t magic[8] = {0};
  size_t n = fread(magic, 1, 8, f);
  rewind(f);
  Source src;
  src.file = f;
  bool ok = Decode(&src, magic, n, out, false);
  fclose(f);
  return ok;
}

bool DecodeMem(const uint8_t* data, size_t size, Image* out,
               bool header_only) {
  Source src;
  src.data = data;
  src.size = size;
  return Decode(&src, data, size, out, header_only);
}

// splittable deterministic RNG per (seed, image index)
uint64_t Mix(uint64_t a, uint64_t b) {
  uint64_t x = a * 0x9E3779B97F4A7C15ULL + b;
  x ^= x >> 30;
  x *= 0xBF58476D1CE4E5B9ULL;
  x ^= x >> 27;
  x *= 0x94D049BB133111EBULL;
  x ^= x >> 31;
  return x;
}

}  // namespace

extern "C" {

// Decode one image to float32 [0,1] RGB. Caller provides a buffer of
// capacity cap_h*cap_w*3; actual size written to *w,*h. Returns 0 on success.
int wdm_decode_image(const char* path, float* out, int cap_h, int cap_w,
                     int* h, int* w) {
  Image img;
  if (!DecodeFile(path, &img)) return 1;
  if (img.h > cap_h || img.w > cap_w) return 2;
  *h = img.h;
  *w = img.w;
  const float inv = 1.0f / 255.0f;
  for (size_t i = 0, n = img.rgb.size(); i < n; ++i) out[i] = img.rgb[i] * inv;
  return 0;
}

// The height and width in the header of an encoded JPEG or PNG held in
// memory, without decoding its pixels. Returns 0 on success.
int wdm_image_size_mem(const uint8_t* data, size_t size, int* h, int* w) {
  Image img;
  if (!DecodeMem(data, size, &img, true)) return 1;
  *h = img.h;
  *w = img.w;
  return 0;
}

// Decode an encoded JPEG or PNG held in memory to (h, w, 3) uint8 RGB in a
// buffer of capacity cap_h*cap_w*3; actual size written to *h, *w.
// Returns 0 on success, 1 when it does not decode, 2 when it is larger
// than the buffer.
int wdm_decode_mem(const uint8_t* data, size_t size, uint8_t* out, int cap_h,
                   int cap_w, int* h, int* w) {
  Image img;
  if (!DecodeMem(data, size, &img, false)) return 1;
  if (img.h > cap_h || img.w > cap_w) return 2;
  *h = img.h;
  *w = img.w;
  std::memcpy(out, img.rgb.data(), img.rgb.size());
  return 0;
}

// Assemble a training batch: for each of n_images (input_path, gt_path)
// pairs, draw patch_n random patch x patch crops at shared coordinates and
// write [cond|gt] channels-last float32 [0,1] into
// out[(n_images*patch_n), patch, patch, 6].
// Crop coordinates derive deterministically from (seed, image slot).
// A pair that fails to decode, differs in size or is smaller than the
// patch is skipped (its rows stay as they were).
// Returns number of images decoded successfully.
int wdm_make_crop_batch(const char** input_paths, const char** gt_paths,
                        int n_images, int patch_n, int patch, uint64_t seed,
                        int n_threads, float* out) {
  std::atomic<int> next(0), ok_count(0);
  const float inv = 1.0f / 255.0f;

  auto worker = [&]() {
    for (;;) {
      int idx = next.fetch_add(1);
      if (idx >= n_images) return;
      Image inp, gt;
      if (!DecodeFile(input_paths[idx], &inp) ||
          !DecodeFile(gt_paths[idx], &gt))
        continue;
      if (gt.w != inp.w || gt.h != inp.h) continue;
      if (inp.h < patch || inp.w < patch) continue;
      std::mt19937_64 rng(Mix(seed, uint64_t(idx)));
      for (int k = 0; k < patch_n; ++k) {
        int max_y = inp.h - patch, max_x = inp.w - patch;
        int y = max_y > 0 ? int(rng() % uint64_t(max_y + 1)) : 0;
        int x = max_x > 0 ? int(rng() % uint64_t(max_x + 1)) : 0;
        float* dst =
            out + (size_t(idx) * patch_n + k) * size_t(patch) * patch * 6;
        for (int r = 0; r < patch; ++r) {
          const uint8_t* in_row = inp.rgb.data() + (size_t(y + r) * inp.w + x) * 3;
          const uint8_t* gt_row = gt.rgb.data() + (size_t(y + r) * gt.w + x) * 3;
          float* drow = dst + size_t(r) * patch * 6;
          for (int c = 0; c < patch; ++c) {
            drow[c * 6 + 0] = in_row[c * 3 + 0] * inv;
            drow[c * 6 + 1] = in_row[c * 3 + 1] * inv;
            drow[c * 6 + 2] = in_row[c * 3 + 2] * inv;
            drow[c * 6 + 3] = gt_row[c * 3 + 0] * inv;
            drow[c * 6 + 4] = gt_row[c * 3 + 1] * inv;
            drow[c * 6 + 5] = gt_row[c * 3 + 2] * inv;
          }
        }
      }
      ok_count.fetch_add(1);
    }
  };

  int nt = n_threads > 0 ? n_threads : int(std::thread::hardware_concurrency());
  if (nt < 1) nt = 1;
  if (nt > n_images) nt = n_images;
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int i = 0; i < nt; ++i) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
  return ok_count.load();
}

}  // extern "C"
