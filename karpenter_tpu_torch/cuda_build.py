"""Build and load the package's CUDA kernels (``csrc/*.cu``) at first use.

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so
a build takes seconds).  Builds land in ``karpenter_tpu_torch/_build/``
(listed in ``.gitignore``) under a name carrying a digest of the source
and flags, so an edited source never loads a stale library.
:func:`build_all` starts one ``nvcc`` per source at once and waits for
all of them; a kernel that fails to build raises — nothing falls back.

Fast math is never enabled: the FFD scan's rank / fit divide and the
segment, presence and cost sums' adds must be IEEE round-to-nearest
(see ``csrc/*.cu``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# kernel name -> the C functions its library exports, with ctypes types
_SIGNATURES = {
    "cost_sum": {
        "cost_word_launch": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
        "cost_sum_max_len": (ctypes.c_int, []),
        "cost_sum_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "ffd_scan": {
        "ffd_scan_launch": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]),
        "ffd_scan_max_nodes": (ctypes.c_int, []),
        "ffd_scan_row_words": (ctypes.c_int, [ctypes.c_int]),
        "ffd_scan_variant": (ctypes.c_int,
                             [ctypes.c_int, ctypes.c_int, ctypes.c_int]),
        "ffd_scan_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "presence_sum": {
        "presence_sum_launch": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
        "presence_sum_max_groups": (ctypes.c_int, []),
        "presence_sum_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "segment_sum": {
        "segment_sum_launch": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
        "segment_sum_max_cols": (ctypes.c_int, []),
        "segment_sum_max_items": (ctypes.c_int, []),
        "segment_sum_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
}

KERNEL_SOURCES = tuple(sorted(_SIGNATURES))

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}
# kernel name -> (seconds the build took, ptxas report), for this process
build_reports: dict[str, tuple[float, str]] = {}


def nvcc_path() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or NVCC to build the "
                       "CUDA kernels")


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build_all(names=KERNEL_SOURCES) -> dict[str, float]:
    """Compile every named kernel whose library is missing, one ``nvcc``
    per source, all started together.  Returns name -> build seconds (0
    for a library already built).  Raises RuntimeError with the
    compiler's output when any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            seconds[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        build_reports[name] = (seconds[name], log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
        out.with_suffix(".ptxas.txt").write_text(log)
    if failures:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return seconds


def stream_handle(index: int) -> int:
    """The raw handle of the current CUDA stream of device ``index``
    (``tensor.get_device()``), read anew on every call: the stream
    PyTorch's own ops on that device launch on, without building a
    ``torch.cuda.Stream`` object per call."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        for fn, (restype, argtypes) in _SIGNATURES[name].items():
            f = getattr(lib, fn)
            f.restype = restype
            f.argtypes = argtypes
        _loaded[name] = lib
        return lib
