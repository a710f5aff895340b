"""Cold-start mitigation: kernels built at start + bucket warmup (port of
``karpenter_tpu/solver/warmup.py``).

A freshly started process pays first-dispatch costs before its first
solve.  In the reference those are XLA compiles; in the port they are:

1. **The kernels' build**: ``nvcc`` over ``csrc/*.cu``, seconds per
   source.  :func:`enable_persistent_compile_cache` builds every kernel
   into the build directory (``$KARPENTER_TPU_COMPILE_CACHE`` when set,
   the reference's variable, else ``cuda_build.BUILD_DIR``), so a
   restart that finds the libraries there builds nothing.
2. **The first dispatch of each signature**: the hand kernel's first
   load through ``ctypes``, ``cudaFuncSetAttribute`` on a new chain
   instantiation and the caching allocator's growth.
   :func:`warmup_solver` dispatches the common bucket ladder through the
   solver's real ``dispatch_packed`` (and the batch program at the batch
   widths), with exactly the shapes production dispatches use, so each
   of those signatures is seen (``obs.devtel``) and paid for at start.
3. **Catalog upload**: warmup also puts the catalog tensors on the
   device, so the first window's dispatch finds them resident.
"""

from __future__ import annotations

import os
from collections.abc import Sequence

import numpy as np

from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("solver.warmup")


def enable_persistent_compile_cache(path: str | None = None) -> str:
    """Build every hand kernel into ``path`` (or
    ``$KARPENTER_TPU_COMPILE_CACHE``, or the package's build directory)
    and load them from there from now on.  Returns the directory in use.
    Without a CUDA card nothing is built: the plain versions need no
    build."""
    import torch

    from karpenter_tpu_torch import cuda_build

    d = path if path is not None else \
        os.environ.get("KARPENTER_TPU_COMPILE_CACHE", "")
    if d:
        cuda_build.use_build_dir(d)
    if torch.cuda.is_available():
        cuda_build.ensure_built()
    log.info("kernel build directory in use", dir=str(cuda_build.BUILD_DIR))
    return str(cuda_build.BUILD_DIR)


# (G_pad, U_pad, N, expected_pods) combos covering the common ladder:
# small windows (G<=64) at the two usual node buckets.  Each entry warms
# the single-window program and the batch program at each batch width.
DEFAULT_WARMUP_SHAPES: tuple[tuple[int, int, int, int], ...] = (
    (64, 4, 512, 10000),
    (64, 16, 512, 10000),
    (64, 4, 128, 1000),
)


def warmup_prep(solver, catalog, G_pad: int, U_pad: int, N: int,
                total: int):
    """A prepared all-zero window (0-count groups: the solve is trivial,
    its shapes are the point) at one ladder shape of ``catalog``'s
    offering bucket, on the FFD route."""
    from karpenter_tpu_torch.solver.torch_backend import (
        _Prepared, pack_input,
    )
    from karpenter_tpu_torch.solver.types import OFFERING_BUCKETS, bucket

    O_pad = bucket(max(catalog.num_offerings, 1), OFFERING_BUCKETS)
    max_slots = int(catalog.offering_alloc()[:, 3].max()) \
        if catalog.num_offerings else 1
    packed = pack_input(np.zeros((G_pad, 4), np.int32),
                        np.zeros(G_pad, np.int32), np.zeros(G_pad, np.int32),
                        np.zeros(G_pad, np.int32),
                        np.zeros((U_pad, O_pad), bool))
    K0, K_cap = solver._compact_k(total, G_pad)
    return _Prepared(catalog=catalog, G_pad=G_pad, O_pad=O_pad, U_pad=U_pad,
                     N=N, N_cap=N, K0=K0, K_cap=K_cap, packed=packed,
                     dense16_ok=max_slots < (1 << 15))


def warmup_solver(solver, catalog, *,
                  shapes: Sequence[tuple[int, int, int, int]] = None,
                  batch_widths: Sequence[int] = (16, 32),
                  force: bool = False) -> int:
    """Dispatch the solve programs for ``catalog``'s offering bucket at
    the given (G_pad, U_pad, N, expected_pods) shapes through the
    solver's real dispatch (``dispatch_packed``, and the batch program
    at each of ``batch_widths``), waiting for each.  Returns the number
    of programs warmed.  On the CPU without ``force`` only the catalog
    is uploaded, as the reference skips its compiles there."""
    from karpenter_tpu_torch.solver.torch_backend import BatchPendingSolve
    from karpenter_tpu_torch.solver.types import OFFERING_BUCKETS, bucket

    shapes = DEFAULT_WARMUP_SHAPES if shapes is None else shapes
    O_pad = bucket(max(catalog.num_offerings, 1), OFFERING_BUCKETS)
    if solver.device.type != "cuda" and not force:
        solver.device_offerings(catalog, O_pad)
        log.info("solver warmup: catalog resident (cpu device, "
                 "dispatches skipped)")
        return 0
    warmed = 0
    for G_pad, U_pad, N, total in shapes:
        prep = warmup_prep(solver, catalog, G_pad, U_pad, N, total)
        solver.dispatch_packed(prep)
        warmed += 1
        for C in batch_widths:
            batch = BatchPendingSolve(solver, [(None, prep.clone())] * C)
            if batch._event is not None:
                batch._event.synchronize()
            warmed += 1
    if solver.device.type == "cuda":
        import torch

        torch.cuda.synchronize(solver.device)
    log.info("solver warmup done", programs=warmed, O_pad=O_pad)
    return warmed
