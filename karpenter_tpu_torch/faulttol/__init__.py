"""Device-fault survivability: the device itself as a failure domain
(port of ``karpenter_tpu/faulttol``).

- :mod:`dispatch` — ``device_guard``, the one shared wrapper around
  every kernel dispatch site: quarantine-gated admission, profiler-EWMA
  deadlines on the dispatch->fetch wall, typed fault classification
  (a hand kernel's cudaError, torch's CUDA error, an allocator OOM);
- :mod:`health` — the per-device state machine (healthy -> suspect ->
  quarantined -> probation) with a torch probe and triage bundles on
  quarantine;
- :mod:`deadline` — ``max(floor, k x EWMA)`` deadline derivation;
- :mod:`inject` — the deterministic ``FaultyDeviceInjector``;
- :mod:`errors` — the ``DeviceFaultError`` family.

The port raises every fault to its caller: no site catches one and
carries on, on the CPU or down another route (the reference's host
fallbacks are ROADMAP queue 1 item 13).
"""

from karpenter_tpu_torch.faulttol.deadline import DeadlineModel, get_deadline_model
from karpenter_tpu_torch.faulttol.dispatch import DeviceGuard, device_guard
from karpenter_tpu_torch.faulttol.errors import (DeviceCorruptResult,
                                           DeviceFaultError,
                                           DeviceQuarantinedError,
                                           DeviceResourceExhausted,
                                           DispatchDeadlineExceeded)
from karpenter_tpu_torch.faulttol.health import (HEALTHY, PROBATION, QUARANTINED,
                                           SUSPECT, HealthBoard,
                                           default_device_id, device_id,
                                           device_ids,
                                           get_health_board)
from karpenter_tpu_torch.faulttol.inject import (FaultyDeviceInjector,
                                           clear_injector, get_injector,
                                           install_injector)

__all__ = [
    "DeviceGuard", "device_guard",
    "DeadlineModel", "get_deadline_model",
    "DeviceFaultError", "DispatchDeadlineExceeded",
    "DeviceQuarantinedError", "DeviceResourceExhausted",
    "DeviceCorruptResult",
    "HealthBoard", "get_health_board", "default_device_id", "device_id",
    "device_ids",
    "HEALTHY", "SUSPECT", "QUARANTINED", "PROBATION",
    "FaultyDeviceInjector", "install_injector", "clear_injector",
    "get_injector",
]
