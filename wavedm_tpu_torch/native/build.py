"""Build and load the port's data library, ``native/wavedm_data.cc``.

The library decodes JPEG and PNG with libjpeg and libpng and assembles the
training crop stream (``data/native_loader.py`` binds it).  It is host
code: the host C++ compiler builds it, the one ``nvcc`` itself needs
(``CXX``, else ``c++`` or ``g++`` on ``PATH``), with the flags of the JAX
package's ``native/dataloader/Makefile``, into
``_build/libwavedm_tpu_torch_data.so``, which :func:`library` loads with
``ctypes``.  No CUDA toolkit is needed.

The build runs at first use and again only when the source or the flags
change: their hash is compiled into the library as a marker string.  The
library is written to a temporary file and moved into place, so processes
that build at once never load a half-written file.

:func:`unavailable_reason` names what is missing when the compiler or one
of ``jpeglib.h``, ``png.h`` and ``zlib.h`` is absent; only then is the
library unavailable.  With all of them present a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict, List, Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "wavedm_data.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libwavedm_tpu_torch_data.so")
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")
LIBS = ("-ljpeg", "-lpng", "-lz", "-lpthread")
HEADERS = ("jpeglib.h", "png.h", "zlib.h")
BUILD_TIMEOUT_S = 120

_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_size_t
_IP = ctypes.POINTER(ctypes.c_int)
# C entry points: name -> argtypes (all return int)
ENTRIES = {
    "wdm_decode_image": (ctypes.c_char_p, _P, _I, _I, _IP, _IP),
    "wdm_image_size_mem": (_P, _S, _IP, _IP),
    "wdm_decode_mem": (_P, _S, _P, _I, _I, _IP, _IP),
    "wdm_make_crop_batch": (ctypes.POINTER(ctypes.c_char_p),
                            ctypes.POINTER(ctypes.c_char_p), _I, _I, _I,
                            ctypes.c_uint64, _I, _P),
}

_lock = threading.Lock()
_lib = None
_probe: Optional[Dict] = None
last_build_seconds = None   # wall time of this process's build, if any


def find_cxx() -> Optional[str]:
    """``CXX`` when set, else ``c++`` or ``g++`` on ``PATH``; None if none
    is found."""
    env = os.environ.get("CXX")
    for cand in ([env] if env else []) + ["c++", "g++"]:
        found = shutil.which(cand)
        if found:
            return found
    return None


def _has_header(cxx: str, header: str) -> bool:
    """Whether the compiler's preprocessor finds ``<header>``."""
    res = subprocess.run([cxx, "-E", "-x", "c++", "-", "-o", os.devnull],
                         input=f"#include <cstddef>\n#include <cstdio>\n"
                         f"#include <{header}>\n", capture_output=True,
                         text=True, timeout=60)
    return res.returncode == 0


def probe() -> Dict:
    """The compiler and which of :data:`HEADERS` it finds (asked once a
    process): ``{"compiler": path or None, "headers": {name: bool}}``."""
    global _probe
    with _lock:
        if _probe is None:
            cxx = find_cxx()
            _probe = {"compiler": cxx,
                      "headers": {h: bool(cxx) and _has_header(cxx, h)
                                  for h in HEADERS}}
        return _probe


def unavailable_reason() -> Optional[str]:
    """Why the library cannot be built here (no compiler, or which headers
    the compiler does not find), or None when it is built or can be."""
    if _lib is not None or _is_current(source_hash()):
        return None
    found = probe()
    if found["compiler"] is None:
        return ("no C++ compiler (CXX, c++ or g++) to build the data "
                "library")
    missing: List[str] = [h for h, ok in found["headers"].items() if not ok]
    if missing:
        return (f"{', '.join(missing)} not found by {found['compiler']} "
                "(the data library needs libjpeg's, libpng's and zlib's "
                "development headers)")
    return None


def source_hash() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return h.hexdigest()[:32]


def _marker(digest: str) -> bytes:
    # wavedm_data.cc compiles "wavedm-src-hash=" #WAVEDM_SRC_HASH into the .so
    return f"wavedm-src-hash=h{digest}".encode()


def _is_current(digest: str) -> bool:
    if not os.path.isfile(LIB_PATH):
        return False
    with open(LIB_PATH, "rb") as f:
        return _marker(digest) in f.read()


def build() -> str:
    """Compile :data:`SOURCE` unless the library is current; returns its
    path.  Raises when the toolchain is missing (the reason) or the
    compiler fails (its message)."""
    global last_build_seconds
    digest = source_hash()
    if _is_current(digest):
        return LIB_PATH
    reason = unavailable_reason()
    if reason:
        raise RuntimeError(reason)
    cxx = probe()["compiler"]
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cxx, *CXX_FLAGS, f"-DWAVEDM_SRC_HASH=h{digest}", "-o", tmp,
           SOURCE, *LIBS]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=BUILD_TIMEOUT_S)
        if res.returncode:
            raise RuntimeError(f"the data library failed to build "
                               f"({' '.join(cmd)}):\n{res.stderr}")
        os.replace(tmp, LIB_PATH)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"{cxx} timed out after {BUILD_TIMEOUT_S} s") \
            from e
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    last_build_seconds = time.perf_counter() - t0
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded data library (built first if needed); raises when it
    cannot be built."""
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(path)
            for name, argtypes in ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def status() -> Dict:
    """Build the library if it can be, and say how it went: the compiler,
    the headers it finds, this process's build seconds (None when the
    library was current), ``available`` and, when not, the reason.  A
    failed build with the toolchain present raises."""
    reason = unavailable_reason()
    if reason is None:
        library()
    found = probe()
    return {"compiler": found["compiler"], "headers": found["headers"],
            "build_seconds": last_build_seconds,
            "available": reason is None, "reason": reason,
            "library": LIB_PATH if reason is None else None}
