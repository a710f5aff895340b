"""Device resolution: the port runs on the card unless asked for the CPU.

``resolve_device("cuda")`` (the default of every entry point) returns
the current CUDA device and raises when there is none — a solve that
was meant for the card never carries on silently on the CPU.  Callers
that want the CPU (the tests, the plain-version comparisons) pass
``"cpu"``.

Selecting the card also builds every hand kernel, once per process
(``cuda_build.ensure_built``, a flag test afterwards): every entry
point resolves its device at construction or call, so the ``nvcc``
runs land there and never inside a guarded dispatch's deadline window.
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA device requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        from karpenter_tpu_torch import cuda_build

        cuda_build.ensure_built()
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or "
                         f"'cpu'")
    return dev
