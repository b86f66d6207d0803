"""Build and load the port's CUDA kernels into one ``.so``.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into
``_build/libwavedm_tpu_torch_kernels.so``, a shared library with a plain C
interface that :func:`library` loads with ``ctypes``.  Nothing here includes
PyTorch's headers, which keeps the build at seconds.  ``ptxas -v`` output
(registers, shared memory and spills of each kernel) is kept in
``last_ptxas``.

The build runs at first use and again only when the sources change: a hash
of the sources and flags is compiled into the library as a marker string,
so the library file is the only thing the build leaves in the tree.
:func:`launch` calls an entry on a tensor's device and current stream; the
entries are looked up once, when the library loads.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libwavedm_tpu_torch_kernels.so")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 300

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
# C entry points of csrc/*.cu: name -> argtypes (all return cudaError_t)
ENTRIES = {
    "wavelet_dec_f32": (_P, _P, _I, _I, _I, _I, _L, _L, _P),
    "wavelet_rec_f32": (_P, _P, _I, _I, _I, _I, _L, _L, _P),
    "group_norm_f32": (_P,) * 4 + (_I,) * 4 + (_F,) + (_I,) * 5 + (_P,),
    "group_norm_bf16": (_P,) * 4 + (_I,) * 4 + (_F,) + (_I,) * 5 + (_P,),
    "fused_gn_swish_conv_f32": (_P,) * 8 + (_I,) * 8 + (_F, _P),
    "fused_gn_swish_conv_bf16": (_P,) * 8 + (_I,) * 8 + (_F, _P),
}

_lock = threading.Lock()
_lib = None
_fns = {}        # entry name -> its bound ctypes function, once loaded
last_build_seconds = None   # wall time of this process's build, if any
last_ptxas = ""             # ptxas -v report of that build


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu*"))):  # + .cuh
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:32]


def _marker(digest: str) -> bytes:
    # csrc/common.cu compiles "wavedm-src-hash=" #WAVEDM_SRC_HASH into the .so
    return f"wavedm-src-hash=h{digest}".encode()


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += ["/usr/local/cuda/bin/nvcc"]
    for cand in candidates:
        if os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels of "
            "wavedm_tpu_torch cannot be built, and there is no fallback")
    return found


def _is_current(digest: str) -> bool:
    if not os.path.isfile(LIB_PATH):
        return False
    with open(LIB_PATH, "rb") as f:
        return _marker(digest) in f.read()


def _run_all(cmds, deadline: float):
    """Run the commands side by side; raise on the first failure, killing
    whatever still runs.  Returns their stderr texts."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for cmd in cmds]
    try:
        errs = []
        for proc, cmd in zip(procs, cmds):
            _, err = proc.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))
            if proc.returncode:
                raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{err}")
            errs.append(err)
        return errs
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def build(force: bool = False) -> str:
    """Compile ``csrc/*.cu`` unless the library is current; returns its path."""
    global last_build_seconds, last_ptxas
    digest = source_hash()
    if not force and _is_current(digest):
        return LIB_PATH
    nvcc = find_nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{os.getpid()}.o")
            for src in _sources()]
    compile_cmds = [[nvcc, *NVCC_FLAGS, f"-DWAVEDM_SRC_HASH=h{digest}", "-c",
                     src, "-o", obj] for src, obj in zip(_sources(), objs)]
    t0 = time.perf_counter()
    deadline = t0 + BUILD_TIMEOUT_S
    try:
        errs = _run_all(compile_cmds, deadline)
        _run_all([[nvcc, "-shared", "-o", tmp, *objs]], deadline)
        os.replace(tmp, LIB_PATH)
    except subprocess.TimeoutExpired as e:
        raise RuntimeError(f"nvcc timed out after {BUILD_TIMEOUT_S} s") from e
    finally:
        for path in (tmp, *objs):
            if os.path.exists(path):
                os.remove(path)
    last_build_seconds = time.perf_counter() - t0
    last_ptxas = "".join(errs)
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library (built first if needed); raises when it
    cannot be built."""
    global _lib
    if _lib is not None:      # every launch asks: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in ENTRIES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[name] = fn
            lib.wavedm_error_string.argtypes = (ctypes.c_int,)
            lib.wavedm_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        msg = lib.wavedm_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def launch(lib: ctypes.CDLL, entry: str, index: int, *args) -> None:
    """Call C entry ``entry`` with ``args`` and the current stream of CUDA
    device ``index`` (a tensor's ``get_device()``), with that device
    current, and raise on a CUDA error.  The stream is asked for on every
    call (a caller's ``torch.cuda.stream`` or a graph capture changes it)
    through the raw handle; the device is switched only when ``index`` is
    not the current one, asked of the runtime directly."""
    stream = torch._C._cuda_getCurrentRawStream(index)
    if index == torch._C._cuda_getDevice():
        err = _fns[entry](*args, stream)
    else:
        with torch.cuda.device(index):
            err = _fns[entry](*args, stream)
    if err:
        check(lib, err, entry)
