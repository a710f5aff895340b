"""Typed device-fault errors raised at the dispatch-guard seam (port of
``karpenter_tpu/faulttol/errors.py``).

Every error derives from :class:`DeviceFaultError` so the existing
fallback ladders (``ResilientSolver``, ``ResilientShardedService``,
``ResilientPlanner``, the jax_backend ``_dispatch_*`` return-None
idiom, the pallas->scan chain) catch the whole family with the broad
``except Exception`` they already have — the types exist so callers
that WANT to distinguish (the OOM chunking path, the quarantine gate)
can, without string-matching XLA messages.

The port raises them and catches none: no site falls back to the host
or to another route on a fault (that ladder is ROADMAP queue 1 item
13).  Its classification adds what a CUDA device reports and XLA does
not: :func:`is_resource_exhausted` also reads an allocator
``torch.cuda.OutOfMemoryError`` and a hand kernel's
``cudaErrorMemoryAllocation``, and :func:`is_device_error` names the
CUDA failures that become ``DeviceFaultError(kind="error")``.
"""

from __future__ import annotations


class DeviceFaultError(RuntimeError):
    """A device dispatch failed, timed out, or was gated: the caller
    must fail over to the host oracle for its plane."""

    def __init__(self, message: str, *, kernel: str = "",
                 device: str = "", kind: str = "fault"):
        super().__init__(message)
        self.kernel = kernel
        self.device = device
        self.kind = kind


class DispatchDeadlineExceeded(DeviceFaultError):
    """The dispatch->fetch wall blew the per-kernel deadline (a hung
    XLA dispatch must never stall the provisioning loop)."""

    def __init__(self, message: str, *, kernel: str = "",
                 device: str = "", deadline_s: float = 0.0,
                 elapsed_s: float = 0.0):
        super().__init__(message, kernel=kernel, device=device,
                         kind="deadline")
        self.deadline_s = deadline_s
        self.elapsed_s = elapsed_s


class DeviceQuarantinedError(DeviceFaultError):
    """Dispatch admission was refused: the target device is
    quarantined.  Raised BEFORE the kernel launches, so a known-bad
    chip costs the caller nothing but the host fallback."""

    def __init__(self, message: str, *, kernel: str = "",
                 device: str = ""):
        super().__init__(message, kernel=kernel, device=device,
                         kind="quarantined")


class DeviceResourceExhausted(DeviceFaultError):
    """RESOURCE_EXHAUSTED from the runtime (or injected): the caller
    may step the window down the pad/batch ladder before giving up to
    the host path."""

    def __init__(self, message: str, *, kernel: str = "",
                 device: str = ""):
        super().__init__(message, kernel=kernel, device=device,
                         kind="oom")


class DeviceCorruptResult(DeviceFaultError):
    """An independent validator rejected a fetched device result
    (non-finite cost, out-of-range index).  The device state itself is
    not trusted afterwards."""

    def __init__(self, message: str, *, kernel: str = "",
                 device: str = ""):
        super().__init__(message, kernel=kernel, device=device,
                         kind="corrupt")


# RESOURCE_EXHAUSTED classification: the runtime surfaces OOM as an
# XlaRuntimeError whose message carries the grpc-style status name; the
# caching allocator's message reads "CUDA out of memory"
_OOM_MARKERS = ("RESOURCE_EXHAUSTED", "Out of memory", "out of memory")

# cudaErrorMemoryAllocation: a hand kernel's launch could not get memory
_CUDA_ERROR_MEMORY_ALLOCATION = 2


def is_resource_exhausted(exc: BaseException) -> bool:
    import torch

    from karpenter_tpu_torch.cuda_build import KernelLaunchError

    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    if isinstance(exc, KernelLaunchError):
        return exc.code == _CUDA_ERROR_MEMORY_ALLOCATION
    text = str(exc)
    return any(m in text for m in _OOM_MARKERS)


def is_device_error(exc: BaseException) -> bool:
    """A failure of the device rather than of the host code around it: a
    hand kernel's launch error (``KernelLaunchError``, the cudaError its
    C entry returned), torch's ``AcceleratorError`` where the installed
    torch has it, or a ``RuntimeError`` whose text begins ``CUDA
    error`` (torch's report of a failed CUDA call, at the call or at the
    next synchronize).  Shape checks (``ValueError``) and packing bugs
    are not."""
    import torch

    from karpenter_tpu_torch.cuda_build import KernelLaunchError

    if isinstance(exc, KernelLaunchError):
        return True
    accel = getattr(torch, "AcceleratorError", None)
    if accel is not None and isinstance(exc, accel):
        return True
    return isinstance(exc, RuntimeError) \
        and str(exc).lstrip().startswith("CUDA error")
