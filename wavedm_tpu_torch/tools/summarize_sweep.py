"""Summarize an eval-sweep directory (``tools/eval_sweep.py`` output) into
one JSON and a markdown table.

The port's own copy of the JAX package's ``tools/summarize_sweep.py``.
Each row log is the grep-filtered standard output of
``cli/eval_diffusion.py``:

    psnr all torch 30.54
    psnr all np 30.54
    psnr all GPU 30.55
    ssim all 0.912
    (8 images)

  python -m wavedm_tpu_torch.tools.summarize_sweep \\
      [--dir results/r4_sweep] [--out f.json]

The JSON goes to ``--out``, by default ``results/torch/<dir's
name>.summary.json`` (JAX writes ``summary.json`` into the directory,
which may be one the repository holds).  Host only: no device.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

from wavedm_tpu_torch.tools.common import out_path

__all__ = ["parse_log", "summarize", "main"]

_METRICS = {
    "psnr_torch": re.compile(r"psnr all torch\s+([-\d.]+)"),
    "psnr_np_y": re.compile(r"psnr all np\s+([-\d.]+)"),
    "psnr_y": re.compile(r"psnr all GPU\s+([-\d.]+)"),
    "ssim": re.compile(r"ssim all\s+([-\d.]+)"),
    "n_images": re.compile(r"\((\d+) images\)"),
}


def parse_log(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    row = {}
    for key, rx in _METRICS.items():
        m = rx.search(text)
        if m:
            row[key] = float(m.group(1)) if key != "n_images" else int(
                m.group(1))
    return row


def summarize(directory: str) -> dict:
    """Row name -> its metrics, for each ``*.log`` that holds any (the
    ``.full`` transcripts and ``diag`` left out)."""
    rows = {}
    for path in sorted(glob.glob(os.path.join(directory, "*.log"))):
        name = os.path.splitext(os.path.basename(path))[0]
        if name.endswith(".full") or name == "diag":
            continue
        row = parse_log(path)
        if row:
            rows[name] = row
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dir", default="results/r4_sweep")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    rows = summarize(args.dir)
    if not rows:
        print(f"no parsable rows in {args.dir}", file=sys.stderr)
        return 1
    out = args.out or out_path(
        os.path.basename(os.path.normpath(args.dir)) + ".summary.json")
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    with open(out, "w") as f:
        json.dump(rows, f, indent=1, sort_keys=True)

    print("| Row | PSNR-Y (torch) | SSIM | n |")
    print("|---|---|---|---|")
    for name, row in sorted(rows.items()):
        print(f"| {name} | {row.get('psnr_torch', float('nan')):.2f} dB "
              f"| {row.get('ssim', float('nan')):.3f} "
              f"| {row.get('n_images', '?')} |")
    print(f"\nwrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
