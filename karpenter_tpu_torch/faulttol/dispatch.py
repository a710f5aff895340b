"""``device_guard`` — the one shared wrapper around every kernel
dispatch site (port of ``karpenter_tpu/faulttol/dispatch.py``).

Usage (the shape graftlint GL111 pins at every dispatch site)::

    with device_guard("scan") as guard:
        with get_profiler().sampled("scan") as probe:
            out_dev = solve_packed(...)
            probe.dispatched(out_dev)
        out_np = guard.fetch(out_dev)      # fetch sites
    # fetch-free sites (device-resident results) just exit the block

What the guard does, in order:

- **admission**: ticks the health board (drives quarantine->probation
  transitions + probes) and refuses dispatch to quarantined devices
  (``DeviceQuarantinedError`` BEFORE the kernel launches — a known-bad
  device costs one refused dispatch, not a hang);
- **injection**: consults the installed ``FaultyDeviceInjector`` once
  per dispatch (chaos only; None in production) and simulates the drawn
  fault at the fetch/exit edge;
- **deadline**: bounds the dispatch->fetch wall with the profiler-EWMA
  deadline (faulttol/deadline.py), measured on ``time.monotonic`` read
  at call time so chaos scenarios ride the virtual clock; a guard whose
  devices are all CPUs has none unless the caller passes one (the
  plain program runs inside the dispatch: host work, no device to
  hang);
- **classification**: a real fetch failure becomes a typed
  ``DeviceFaultError``; an allocator OOM or a launch returning
  ``cudaErrorMemoryAllocation`` anywhere in the block becomes
  ``DeviceResourceExhausted`` (the chunking/backoff signal); a hand
  kernel's launch error (``KernelLaunchError``) or torch's CUDA error
  anywhere in the block becomes ``DeviceFaultError(kind="error")``.
  The port's kernels report a bad launch synchronously, at the launch,
  where XLA reports it at the fetch.  Host-side exceptions (shape
  checks, packing bugs) pass through UNTOUCHED and are never counted as
  device faults;
- **health accounting**: faults feed the per-device state machine,
  clean exits feed recovery; every fault leaves an
  ``ERRORS{device,<kind>}`` breadcrumb.

Steady-state cost is two monotonic reads, one injector check (None),
one board tick and one success record — no extra dispatches, no syncs,
no CUDA call; the accumulated bookkeeping wall is metered against the
profiler's dispatch-wall estimate (``healthy_overhead_fraction``, <1%
gate).

The guard builds nothing: every hand kernel is built when an entry
point first selects the card (``device.resolve_device``), before any
guarded dispatch, since an ``nvcc`` run inside the deadline window
would look like a hang.  ``fetch`` takes device tensors (a pinned copy
and its event on the card) or a copy already in flight (``event=``).
"""

from __future__ import annotations

import time

import numpy as np

from karpenter_tpu_torch.faulttol.deadline import get_deadline_model
from karpenter_tpu_torch.faulttol.errors import (
    DeviceFaultError, DeviceQuarantinedError, DeviceResourceExhausted,
    DispatchDeadlineExceeded, is_device_error, is_resource_exhausted,
)
from karpenter_tpu_torch.faulttol.health import default_device_id, get_health_board
from karpenter_tpu_torch.faulttol.inject import get_injector
from karpenter_tpu_torch.utils import metrics

# real-time reference for self-overhead metering, captured at import so
# the chaos virtual clock can't skew the accounting (same rule as the
# profiler's perf_counter timings)
_PERF = time.perf_counter


def host_copy(out) -> np.ndarray:
    """One device tensor (or host array) as numpy: through pinned memory
    and an event on the tensor's stream on the card — the way production
    fetches — the tensor's own memory on the CPU."""
    import torch

    if not isinstance(out, torch.Tensor):
        return np.asarray(out)
    if out.device.type != "cuda":
        return out.numpy()
    host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host.copy_(out, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(out.device))
    event.synchronize()
    return host.numpy()


class DeviceGuard:
    __slots__ = ("kernel", "devices", "_deadline_s", "_t0", "_fault",
                 "_fault_consumed", "_fetched", "_board")

    def __init__(self, kernel: str, devices: list[str] | None = None,
                 deadline_s: float | None = None):
        self.kernel = kernel
        self.devices = devices
        self._deadline_s = deadline_s
        self._t0 = 0.0
        self._fault: tuple | None = None
        self._fault_consumed = False
        self._fetched = False
        self._board = None

    # -- lifecycle ----------------------------------------------------------

    def __enter__(self) -> "DeviceGuard":
        if self.devices is None:
            self.devices = [default_device_id()]
        p0 = _PERF()
        board = self._board = get_health_board()
        board.tick()
        for dev in self.devices:
            if not board.admits(dev):
                board.add_overhead(_PERF() - p0)
                raise DeviceQuarantinedError(
                    f"device {dev} is {board.state(dev)}; dispatch of "
                    f"{self.kernel!r} refused", kernel=self.kernel,
                    device=dev)
        if self._deadline_s is None:
            if all(d.startswith("cpu") for d in self.devices):
                # on the CPU the plain program runs inside the dispatch,
                # on the calling thread: its wall is host work under
                # whatever else the host runs, and there is no device
                # that could hang, so no wall bounds it (an explicit
                # deadline_s and injected hangs still apply)
                self._deadline_s = float("inf")
            else:
                self._deadline_s = get_deadline_model().deadline_for(
                    self.kernel)
        inj = get_injector()
        self._fault = inj.draw(self.kernel, self.devices) \
            if inj is not None else None
        # time.monotonic read at call time: virtual inside chaos
        self._t0 = time.monotonic()
        board.note_guard_entered(_PERF() - p0)
        return self

    def fetch(self, out_dev, event=None):
        """Bounded fetch: the sanctioned device->host transfer for a
        guarded dispatch.  Accepts one tensor or a tuple/list of them;
        with ``event`` (a CUDA event or None), ``out_dev`` is a host copy
        already in flight, which the event's end completes."""
        self._fetched = True
        self._raise_pending(at_fetch=True)
        try:
            if event is not None:
                event.synchronize()
            if isinstance(out_dev, (tuple, list)):
                out = tuple(host_copy(o) for o in out_dev)
            else:
                out = host_copy(out_dev)
        except Exception as e:  # noqa: BLE001 — classified below
            kind = "oom" if is_resource_exhausted(e) else "error"
            self._record_fault(kind)
            cls = DeviceResourceExhausted if kind == "oom" \
                else DeviceFaultError
            raise cls(f"device fetch of {self.kernel!r} failed: {e}",
                      kernel=self.kernel,
                      device=self.devices[0]) from e
        self._check_deadline()
        if self._fault is not None and self._fault[0] == "corrupt":
            self._fault_consumed = True
            self._record_fault("corrupt", device=self._fault[1])
            inj = get_injector()
            if inj is not None:
                if isinstance(out, tuple):
                    out = (inj.corrupt(out[0]),) + out[1:]
                else:
                    out = inj.corrupt(out)
        return out

    def __exit__(self, et, ev, tb) -> bool:
        p0 = _PERF()
        board = self._board
        if et is not None:
            if isinstance(ev, DeviceFaultError):
                return False          # already recorded and typed
            if is_resource_exhausted(ev):
                self._record_fault("oom")
                raise DeviceResourceExhausted(
                    f"device dispatch of {self.kernel!r} exhausted "
                    f"resources: {ev}", kernel=self.kernel,
                    device=self.devices[0]) from ev
            if is_device_error(ev):
                self._record_fault("error")
                raise DeviceFaultError(
                    f"device dispatch of {self.kernel!r} failed: {ev}",
                    kernel=self.kernel, device=self.devices[0],
                    kind="error") from ev
            # host-side exception (a shape check, a packing bug): not a
            # device fault — pass through untouched
            return False
        if self._fault is not None and not self._fault_consumed:
            # fetch-free site: simulate the drawn fault at the exit
            # edge (corrupt downgrades to error — there is no host
            # copy to corrupt)
            self._raise_pending(at_fetch=False)
        if not self._fetched:
            self._check_deadline()
        for dev in self.devices:
            board.record_success(dev)
        board.add_overhead(_PERF() - p0)
        return False

    # -- internals ----------------------------------------------------------

    def _check_deadline(self) -> None:
        elapsed = time.monotonic() - self._t0
        if elapsed > self._deadline_s:
            self._record_fault("deadline")
            metrics.DEVICE_DEADLINE_EXCEEDED.labels(self.kernel).inc()
            raise DispatchDeadlineExceeded(
                f"dispatch of {self.kernel!r} blew its deadline "
                f"({elapsed:.3f}s > {self._deadline_s:.3f}s)",
                kernel=self.kernel, device=self.devices[0],
                deadline_s=self._deadline_s, elapsed_s=elapsed)

    def _raise_pending(self, *, at_fetch: bool) -> None:
        if self._fault is None or self._fault_consumed:
            return
        kind, victim = self._fault
        if kind == "corrupt" and at_fetch:
            return                    # applied to the fetched copy
        self._fault_consumed = True
        if kind == "hang":
            self._record_fault("deadline", device=victim)
            metrics.DEVICE_DEADLINE_EXCEEDED.labels(self.kernel).inc()
            raise DispatchDeadlineExceeded(
                f"injected hang: dispatch of {self.kernel!r} never "
                f"completed within {self._deadline_s:.3f}s",
                kernel=self.kernel, device=victim,
                deadline_s=self._deadline_s, elapsed_s=self._deadline_s)
        if kind == "oom":
            self._record_fault("oom", device=victim)
            raise DeviceResourceExhausted(
                f"injected RESOURCE_EXHAUSTED on {self.kernel!r}",
                kernel=self.kernel, device=victim)
        # "error", and "corrupt" on a fetch-free site
        self._record_fault("error", device=victim)
        raise DeviceFaultError(
            f"injected device fault on {self.kernel!r}",
            kernel=self.kernel, device=victim, kind="error")

    def _record_fault(self, kind: str, device: str | None = None) -> None:
        dev = device if device is not None else self.devices[0]
        metrics.ERRORS.labels("device", kind).inc()
        self._board.record_fault(dev, kind=kind, kernel=self.kernel)


def device_guard(kernel: str, devices: list[str] | None = None,
                 deadline_s: float | None = None) -> DeviceGuard:
    """The dispatch-site entry point (see module docstring)."""
    return DeviceGuard(kernel, devices=devices, deadline_s=deadline_s)
