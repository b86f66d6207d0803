"""Write the image fixtures of ``tests/golden/images/`` (this directory)
with PIL.

    python tests/golden/images/make_fixtures.py

The port has no JPEG encoder and uses no PIL, so the JPEGs that the CPU
tests and ``chip_smoke.py`` decode, and PIL's decodes of them, are
committed data made by this script from RainDrop test image 0000
(``data/raindrop/raindrop_test/input/0000.png``):

- ``raindrop_0000.jpg``: the whole 720x480 image, quality 90, 4:2:0;
- ``raindrop_0000_palette.png``: the same image as an 8-bit palette PNG
  (PIL's adaptive 256-colour palette);
- five 40x64 JPEGs of a crop at (y 200, x 300): quality 95 4:4:4,
  quality 90 4:2:0, quality 75 4:2:2, progressive quality 90, and grey;
- ``decodes.npz``: ``Image.open(f).convert("RGB")`` of each file above,
  as (H, W, 3) uint8 keyed by file name.

Not a test (pytest collects ``test_*.py`` only).
"""

import os

import numpy as np
from PIL import Image

OUT = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(OUT)))
SOURCE = os.path.join(REPO, "data", "raindrop", "raindrop_test", "input",
                      "0000.png")


def main():
    os.makedirs(OUT, exist_ok=True)
    full = Image.open(SOURCE).convert("RGB")
    crop = full.crop((300, 200, 364, 240))          # 64 wide, 40 high
    files = {
        "raindrop_0000.jpg": (full, dict(quality=90, subsampling="4:2:0")),
        "raindrop_0000_palette.png": (
            full.convert("P", palette=Image.ADAPTIVE, colors=256), {}),
        "rain_q95_444.jpg": (crop, dict(quality=95, subsampling="4:4:4")),
        "rain_q90_420.jpg": (crop, dict(quality=90, subsampling="4:2:0")),
        "rain_q75_422.jpg": (crop, dict(quality=75, subsampling="4:2:2")),
        "rain_progressive.jpg": (crop, dict(quality=90, progressive=True)),
        "grey.jpg": (crop.convert("L"), dict(quality=90)),
    }
    decodes = {}
    for name, (img, kw) in files.items():
        path = os.path.join(OUT, name)
        img.save(path, **kw)
        decodes[name] = np.asarray(Image.open(path).convert("RGB"))
    np.savez_compressed(os.path.join(OUT, "decodes.npz"), **decodes)


if __name__ == "__main__":
    main()
