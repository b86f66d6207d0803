"""Write the image fixtures of ``tests/golden/images/`` (this directory).

    python tests/golden/images/make_fixtures.py            # both parts
    python tests/golden/images/make_fixtures.py --native   # the second only

The port has no JPEG, WebP, GIF or TIFF encoder, so the files of those
formats that the CPU tests and ``chip_smoke.py`` decode, and PIL's
decodes of them, are committed data made by this script from RainDrop
test image 0000
(``data/raindrop/raindrop_test/input/0000.png``):

- ``raindrop_0000.jpg``: the whole 720x480 image, quality 90, 4:2:0;
- ``raindrop_0000_palette.png``: the same image as an 8-bit palette PNG
  (PIL's adaptive 256-colour palette);
- five 40x64 JPEGs of a crop at (y 200, x 300): quality 95 4:4:4,
  quality 90 4:2:0, quality 75 4:2:2, progressive quality 90, and grey;
- the formats the port reads through PIL, of the same crop: a lossy WebP
  (quality 80), a lossless one, a lossless RGBA WebP (alpha rising left
  to right), a GIF (PIL's adaptive palette) and an uncompressed TIFF;
- ``decodes.npz``: ``Image.open(f).convert("RGB")`` of each file above,
  as (H, W, 3) uint8 keyed by file name.

The second part (``--native``) writes what the port's data library is held
to on the card, where neither JAX nor libjpeg is, and adds to
``decodes.npz`` without touching its other keys:

- JPEGs PIL cannot write, of the same 40x64 crop, written by this host's
  libjpeg through a small C helper the script compiles (``cc``,
  ``-ljpeg``): 4:4:0 and 4:1:1 sampling (``rain_440.jpg``,
  ``rain_411.jpg``), a restart interval of 5 MCUs, which ends
  intervals mid-row (``rain_restart5.jpg``), and arithmetic coding,
  sequential and progressive (``rain_arith.jpg``,
  ``rain_arith_progressive.jpg``); their decodes by the JAX package's
  ``libwavedm_data.so`` go into ``decodes.npz``;
- ``crop_batch.npz``: that library's ``make_crop_batch`` of RainDrop test
  pairs 0000 and 0001 (``data/raindrop/raindrop_test/{input,gt}``), patch
  64, ``patch_n`` 2, seed ``CROP_SEED``, as uint8 (``batch * 255``
  rounded) under ``batch``, with the pairs' paths under ``inputs``/``gts``.

Not a test (pytest collects ``test_*.py`` only).
"""

import os
import subprocess
import sys
import tempfile

import numpy as np
from PIL import Image

OUT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(OUT)))
SOURCE = os.path.join(REPO, "data", "raindrop", "raindrop_test", "input",
                      "0000.png")
CROP_SEED = 20261018
CROP_PAIRS = ("0000.png", "0001.png")

# name -> (sampling "hv" per component, restart interval in MCUs,
# arithmetic coding, progressive)
LIBJPEG_FILES = {
    "rain_440.jpg": ("12,11,11", 0, 0, 0),
    "rain_411.jpg": ("41,11,11", 0, 0, 0),
    "rain_restart5.jpg": ("22,11,11", 5, 0, 0),
    "rain_arith.jpg": ("22,11,11", 0, 1, 0),
    "rain_arith_progressive.jpg": ("22,11,11", 0, 1, 1),
}

# writes argv[5] from argv[1], raw RGB of argv[2] x argv[3], at quality
# 90 with the given sampling, restart interval, coding and progression
WRITER_C = r"""
#include <stdio.h>
#include <stdlib.h>
#include <jpeglib.h>
int main(int argc, char** argv) {
  int w = atoi(argv[2]), h = atoi(argv[3]);
  const char* hv = argv[4];
  unsigned char* px = malloc((size_t)w * h * 3);
  FILE* in = fopen(argv[1], "rb");
  if (!in || fread(px, 1, (size_t)w * h * 3, in) != (size_t)w * h * 3)
    return 1;
  fclose(in);
  struct jpeg_compress_struct c;
  struct jpeg_error_mgr e;
  c.err = jpeg_std_error(&e);
  jpeg_create_compress(&c);
  FILE* out = fopen(argv[5], "wb");
  jpeg_stdio_dest(&c, out);
  c.image_width = w;
  c.image_height = h;
  c.input_components = 3;
  c.in_color_space = JCS_RGB;
  jpeg_set_defaults(&c);
  jpeg_set_quality(&c, 90, TRUE);
  for (int i = 0; i < 3; ++i, hv += 3) {
    c.comp_info[i].h_samp_factor = hv[0] - '0';
    c.comp_info[i].v_samp_factor = hv[1] - '0';
  }
  c.restart_interval = atoi(argv[6]);
  c.arith_code = atoi(argv[7]);
  if (atoi(argv[8])) jpeg_simple_progression(&c);
  jpeg_start_compress(&c, TRUE);
  while (c.next_scanline < c.image_height) {
    JSAMPROW row = px + (size_t)c.next_scanline * w * 3;
    jpeg_write_scanlines(&c, &row, 1);
  }
  jpeg_finish_compress(&c);
  jpeg_destroy_compress(&c);
  fclose(out);
  return 0;
}
"""


def crop(full=None):
    """The 64 wide, 40 high crop at (y 200, x 300) of test image 0000 (of
    ``full``, that image in RGB, where it is open already)."""
    if full is None:
        full = Image.open(SOURCE).convert("RGB")
    return full.crop((300, 200, 364, 240))


def main():
    os.makedirs(OUT, exist_ok=True)
    full = Image.open(SOURCE).convert("RGB")
    small = crop(full)
    rgba = small.copy()
    rgba.putalpha(Image.fromarray(np.tile(np.linspace(
        0, 255, 64).astype(np.uint8), (40, 1))))
    files = {
        "raindrop_0000.jpg": (full, dict(quality=90, subsampling="4:2:0")),
        "raindrop_0000_palette.png": (
            full.convert("P", palette=Image.ADAPTIVE, colors=256), {}),
        "rain_q95_444.jpg": (small, dict(quality=95, subsampling="4:4:4")),
        "rain_q90_420.jpg": (small, dict(quality=90, subsampling="4:2:0")),
        "rain_q75_422.jpg": (small, dict(quality=75, subsampling="4:2:2")),
        "rain_progressive.jpg": (small, dict(quality=90, progressive=True)),
        "grey.jpg": (small.convert("L"), dict(quality=90)),
        "rain_q80.webp": (small, dict(quality=80)),
        "rain_lossless.webp": (small, dict(lossless=True)),
        "rain_rgba.webp": (rgba, dict(lossless=True)),
        "rain.gif": (small, {}),
        "rain.tif": (small, {}),
    }
    decodes = {}
    for name, (img, kw) in files.items():
        path = os.path.join(OUT, name)
        img.save(path, **kw)
        decodes[name] = np.asarray(Image.open(path).convert("RGB"))
    np.savez_compressed(os.path.join(OUT, "decodes.npz"), **decodes)


def native_fixtures():
    """The libjpeg-written JPEGs and their JAX-library decodes, merged
    into ``decodes.npz``, and ``crop_batch.npz``."""
    sys.path.insert(0, REPO)
    from wavedm_tpu.data import native_loader as jax_native

    pixels = np.ascontiguousarray(np.asarray(crop()), np.uint8)
    h, w = pixels.shape[:2]
    path = os.path.join(OUT, "decodes.npz")
    with np.load(path) as old:
        decodes = {k: old[k] for k in old.files}
    with tempfile.TemporaryDirectory() as tmp:
        writer = os.path.join(tmp, "writer")
        with open(writer + ".c", "w") as f:
            f.write(WRITER_C)
        subprocess.run(["cc", "-O1", "-o", writer, writer + ".c", "-ljpeg"],
                       check=True)
        raw = os.path.join(tmp, "crop.rgb")
        pixels.tofile(raw)
        for name, (hv, restart, arith, prog) in LIBJPEG_FILES.items():
            out = os.path.join(OUT, name)
            subprocess.run([writer, raw, str(w), str(h), hv, out,
                            str(restart), str(arith), str(prog)], check=True)
            dec = jax_native.decode_image(out, 64, 64)
            decodes[name] = np.round(dec * 255).astype(np.uint8)
    np.savez_compressed(path, **decodes)

    test = os.path.join(REPO, "data", "raindrop", "raindrop_test")
    inputs = [os.path.join(test, "input", n) for n in CROP_PAIRS]
    gts = [os.path.join(test, "gt", n) for n in CROP_PAIRS]
    batch = jax_native.make_crop_batch(inputs, gts, patch_n=2, patch=64,
                                       seed=CROP_SEED, n_threads=2)
    np.savez_compressed(
        os.path.join(OUT, "crop_batch.npz"),
        batch=np.round(batch * 255).astype(np.uint8),
        inputs=np.array([os.path.relpath(p, REPO) for p in inputs]),
        gts=np.array([os.path.relpath(p, REPO) for p in gts]),
        seed=np.array(CROP_SEED), patch=np.array(64), patch_n=np.array(2))


if __name__ == "__main__":
    if "--native" not in sys.argv[1:]:
        main()
    native_fixtures()
