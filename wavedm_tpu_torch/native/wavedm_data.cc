// WaveDM data library of the PyTorch port: JPEG/PNG decode and the
// training crop stream, with a plain C interface loaded through ctypes
// (wavedm_tpu_torch/data/native_loader.py; built by native/build.py).
//
// The port's own copy of the JAX package's native/dataloader/wavedm_data.cc.
// wdm_decode_image and wdm_make_crop_batch keep that library's ABI and
// results to the byte: the same decodes as its libjpeg/libpng calls, from
// the port's own decoders (jpeg_decode.cc, png_decode.cc over zlib), so
// the library needs zlib alone; `* (1.0f/255)`, the worker pool over an
// atomic index and the per-slot mt19937_64(Mix(seed, slot)) crop
// coordinates, y before x.  Two changes:
//   - wdm_make_crop_batch skips a pair smaller than the patch, as it skips
//     one that fails to decode (the JAX copy reads past the image there);
//   - wdm_image_size_mem and wdm_decode_mem decode from memory to uint8,
//     for request bodies: the header's size first, so the caller
//     allocates exactly, then the pixels.  A JPEG body that ends before
//     its image does fails there (as PIL refuses it), where the file
//     route, like the JAX copy, takes libjpeg's grey fill.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <random>
#include <thread>
#include <vector>

#include "jpeg_decode.h"
#include "png_decode.h"

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
};

// Decode an encoded JPEG or PNG, told apart by the signature: FF D8 is
// JPEG, the 8-byte signature PNG.  from_file: a JPEG that ends early is
// taken with libjpeg's fill, as the JAX copy's file route takes it.
bool Decode(const uint8_t* data, size_t size, bool from_file, Image* out,
            bool header_only) {
  if (size >= 2 && data[0] == 0xFF && data[1] == 0xD8) {
    bool ran_out = false;
    if (!wdm::DecodeJpeg(data, size, header_only, &out->w, &out->h,
                         &out->rgb, &ran_out))
      return false;
    return header_only || from_file || !ran_out;
  }
  if (wdm::IsPng(data, size))
    return wdm::DecodePng(data, size, header_only, &out->w, &out->h,
                          &out->rgb);
  return false;
}

bool DecodeFile(const char* path, Image* out) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  std::vector<uint8_t> data;
  uint8_t buf[1 << 16];
  for (size_t n; (n = fread(buf, 1, sizeof(buf), f)) > 0;)
    data.insert(data.end(), buf, buf + n);
  fclose(f);
  return Decode(data.data(), data.size(), true, out, false);
}

bool DecodeMem(const uint8_t* data, size_t size, Image* out,
               bool header_only) {
  return Decode(data, size, false, out, header_only);
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
