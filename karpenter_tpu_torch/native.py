"""ctypes binding for the per-pod FFD twin on the host (``csrc/ffd_host.cpp``).

Port of ``karpenter_tpu/native.py``.  The library is built at first use
with ``g++ -O2 -fPIC -shared -std=c++17`` into ``_build/`` (listed in
``.gitignore``) under a name carrying a digest of the source and flags,
so an edited source never loads a stale library.  Several processes may
build at once (test workers): each compiles into a file of its own and
moves it into place with ``os.replace``, so a reader never sees half a
library.  Without a toolchain ``load()`` returns None and the greedy
oracle takes its python loop, as in the reference.  This is host code:
it never stands in for a kernel on the card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

from karpenter_tpu_torch.cuda_build import BUILD_DIR, CSRC_DIR
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("native")

SOURCE = CSRC_DIR / "ffd_host.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-shared", "-std=c++17", "-Wall", "-Wextra")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_load_failed = False

_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")


def library_path():
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libffd_host-{digest[:16]}.so"


def _build(out) -> None:
    """Compile the source into ``out`` (through a file of this process's
    own); raises when there is no compiler or it fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def load() -> ctypes.CDLL | None:
    """Load (building if needed) the native library; None if it cannot
    be built or loaded."""
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
            lib.ffd_solve.restype = ctypes.c_int
            lib.ffd_solve.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _I32P, _I32P, _I32P, _U8P, _I32P, _F32P,
                _I32P, _I32P, _I32P,
            ]
            lib.ffd_solve_gid.restype = ctypes.c_int
            lib.ffd_solve_gid.argtypes = [
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                _I32P, _I32P, _I32P, _U8P, _I32P, _F32P,
                _I32P, _I32P,
                _I32P, _I32P, _I32P,
            ]
            _lib = lib
        except (OSError, RuntimeError, AttributeError,
                subprocess.SubprocessError) as e:
            log.warning("native build or load failed; using python greedy",
                        error=str(e)[:300])
            _load_failed = True
        return _lib


def ffd_solve(group_req: np.ndarray, group_count: np.ndarray,
              group_cap: np.ndarray, compat: np.ndarray,
              off_alloc: np.ndarray, off_rank: np.ndarray,
              max_nodes: int, gid: np.ndarray = None):
    """Run the per-pod FFD.  Returns (node_off, assign, unplaced, open)
    or None when the native library is unavailable; ``open`` is -1 on
    node overflow (the caller escalates max_nodes).

    ``gid``: per-row original-group ids of a per-pod expansion: the
    per-node cap is then counted across all rows sharing a gid (a
    per-pod row holds one pod, so its own assign count never reaches a
    cap; see ``ffd_solve_gid`` in the source)."""
    lib = load()
    if lib is None:
        return None
    G, O = compat.shape
    N = int(max_nodes)
    node_off = np.full(N, -1, dtype=np.int32)
    assign = np.zeros((G, N), dtype=np.int32)
    unplaced = np.zeros(G, dtype=np.int32)
    args = [
        G, O, N,
        np.ascontiguousarray(group_req, dtype=np.int32),
        np.ascontiguousarray(group_count, dtype=np.int32),
        np.ascontiguousarray(np.minimum(group_cap, np.iinfo(np.int32).max),
                             dtype=np.int32),
        np.ascontiguousarray(compat, dtype=np.uint8),
        np.ascontiguousarray(off_alloc, dtype=np.int32),
        np.ascontiguousarray(off_rank, dtype=np.float32),
    ]
    if gid is None:
        n_open = lib.ffd_solve(*args, node_off, assign, unplaced)
    else:
        gid = np.ascontiguousarray(gid, dtype=np.int32)
        n_gids = int(gid.max()) + 1 if gid.size else 1
        gid_count = np.zeros((n_gids, N), dtype=np.int32)
        n_open = lib.ffd_solve_gid(*args, gid, gid_count,
                                   node_off, assign, unplaced)
    return node_off, assign, unplaced, n_open
