"""The serving loop: a persistent device-resident solve service (port of
``karpenter_tpu/serving/service.py``).

``ServingLoop`` keeps the packed problem state on the device (a
``ResidentBuffer``: the resident store's mirror and invalidation rules)
and uploads each submitted window's padded word delta through pinned
staging.  One kick per window (``serving/kernels.serve_window``) applies
the delta and solves; the result waits in the output ring, whose copy to
the host runs while later windows are kicked, and ``result()`` decodes
it on the classic path's decode (``PendingSolve``).

Routing, counted in ``stats()``; no window is lost or solved twice:

1. the ring (rebuild / delta / hit) — eligible windows;
2. classic dispatch on the card — ineligible windows (preferences,
   stochastic, affinity, flat, empty: ``classic_windows``) and windows
   that find the output ring full (``backpressured``), which leave the
   mirror untouched so the next admitted delta takes up their churn;
3. host failover — a ``DeviceFaultError`` at the kick or the fetch
   invalidates the ring and re-solves the window through the classic
   path of ``self.solver`` (``host_failovers``,
   ``SERVING_WINDOWS{host_failover}``); any other failure of the kick
   invalidates, leaves an ``ERRORS{solver, serving_fallback}`` sample and
   re-solves the same way.  The classic re-solve runs the card's FFD
   kernel, never a plain version; if it fails too, the window raises.

Each kick runs inside ``device_guard("serving-kick")`` and each fetch
inside ``device_guard("serving-fetch")`` (``guard.fetch`` waits for the
copy the kick started), each in a sampled profiler bracket; the kick is
noted in ``obs.devtel`` with the reference's signature (the ring's
windows and invalidations are not resident-store windows, and are not
noted as such, as in the reference).  A fetch
that fails other than with a ``DeviceFaultError`` invalidates the ring
and raises.

``ShardedServingLoop`` does the same for the sharded service: each
window is a kick of ``ShardedSolveService._kick_window`` (the stacked
state advances there; a host-routed window comes back finished), and up
to ``capacity`` fetches wait, so window t's copy to the host runs while
window t + 1 is kicked.  For a service on the CPU a ``DeviceFaultError``
at the kick or the fetch re-solves the window on the service's host
route (``solve_window_host``, ``host_failovers``), as the reference's;
for one on the card it raises (``device.holds_card``: the port moves no
window off the card).  ``ServingLoop.track_generation`` invalidates the
ring when the catalog's generation moves, and both loops' ``drain``
fetches every window still in flight (shutdown, the chaos harness).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from karpenter_tpu_torch import obs
from karpenter_tpu_torch.device import holds_card
from karpenter_tpu_torch.faulttol import DeviceFaultError, device_guard
from karpenter_tpu_torch.obs.devtel import get_devtel
from karpenter_tpu_torch.obs.prof import get_profiler
from karpenter_tpu_torch.resident.delta import empty_delta, pad_delta
from karpenter_tpu_torch.resident.store import ResidentBuffer, plan_update
from karpenter_tpu_torch.serving import RING_SLOTS
from karpenter_tpu_torch.serving.oracle import RingOracle
from karpenter_tpu_torch.serving.ring import OutputRing, OutputSlot, Staging
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("serving.service")


class ServingPending:
    """One ring-fed window in flight: ``result()`` claims its output slot,
    waits for the copy, and decodes."""

    __slots__ = ("_loop", "_seq", "_done")

    def __init__(self, loop: "ServingLoop", seq: int):
        self._loop = loop
        self._seq = seq
        self._done = None

    def result(self):
        if self._done is None:
            self._done = self._loop._finish(self._seq)
        return self._done


class ServingLoop:
    """The serving service of one ``TorchSolver`` (when
    ``serving_enabled``), on the solver's device."""

    def __init__(self, solver, capacity: int = RING_SLOTS):
        self.solver = solver
        self.capacity = capacity
        self.staging = Staging(capacity, solver.device)
        self.output = OutputRing(capacity)
        self.buf = ResidentBuffer("serving")
        self.oracle = RingOracle()
        self.windows = 0             # everything submitted
        self.ring_windows = 0        # admitted to the ring (the seq)
        self.classic_windows = 0     # ineligible or backpressured
        self.backpressured = 0       # a ring full -> classic dispatch
        self.rebuilds = 0
        self.invalidations = 0
        self.kicks = 0
        self.fetched = 0
        self.overlapped = 0          # fetched after a later kick
        self.host_failovers = 0      # a device fault -> classic re-solve
        self.last_mode = ""
        self.last_reason = ""

    # -- state ---------------------------------------------------------------

    def invalidate(self, reason: str = "") -> None:
        """The device state, mirror and replay die together; kicked
        output slots stay fetchable."""
        self.buf.invalidate(reason)
        self.oracle.reset()
        self.invalidations += 1
        self.last_reason = reason

    def track_generation(self, catalog) -> None:
        """A warm ring whose generation stamp no longer matches the
        catalog dies now, not at the next admit: the ring either serves
        from current state or holds none at all."""
        if self.buf.dev is None or self.buf.generation is None:
            return
        gen = (catalog.uid, catalog.generation,
               catalog.availability_generation)
        if self.buf.generation != gen:
            self.invalidate("generation")

    @property
    def overlap_fraction(self) -> float:
        return self.overlapped / self.fetched if self.fetched else 0.0

    def stats(self) -> dict:
        return {
            "windows": self.windows,
            "ring_windows": self.ring_windows,
            "classic_windows": self.classic_windows,
            "backpressured": self.backpressured,
            "rebuilds": self.rebuilds,
            "invalidations": self.invalidations,
            "kicks": self.kicks,
            "fetched": self.fetched,
            "overlapped": self.overlapped,
            "overlap_fraction": self.overlap_fraction,
            "host_failovers": self.host_failovers,
            "output_occupancy": self.output.occupancy,
            "capacity": self.capacity,
            "buffer": dict(self.buf.stats),
            "last_mode": self.last_mode,
            "last_reason": self.last_reason,
        }

    def snapshot_state(self) -> dict | None:
        """Mirror, fetched device state and oracle replay; None when
        cold."""
        if self.buf.mirror is None or self.buf.dev is None:
            return None
        return {
            "generation": self.buf.generation,
            "mirror": self.buf.mirror.copy(),
            "device": self.buf.dev[:-1].cpu().numpy(),
            "oracle": None if self.oracle.mirror is None
            else self.oracle.mirror.copy(),
            "seq": self.oracle.last_seq,
        }

    # -- submission ----------------------------------------------------------

    def submit(self, problem):
        """Route one window: the ring when eligible and there is room,
        classic dispatch otherwise.  Returns a handle with ``result()``."""
        self.windows += 1
        if not self._eligible(problem):
            return self._classic(problem, "classic")
        prep = self.solver._prepare(problem)
        if prep.route not in ("ffd", "resident"):
            return self._classic(problem, "classic")
        if self.output.full:
            # the window falls back to classic dispatch untouched (the
            # mirror unchanged: the next admitted delta takes its churn)
            self.backpressured += 1
            metrics.SERVING_BACKPRESSURE.inc()
            return self._classic(problem, "backpressure")
        return self._admit(problem, prep)

    def serve(self, problems, depth: int = 2):
        """Yield Plans in submit order, keeping ``depth`` windows in
        flight, so that each fetch overlaps a later window's kick."""
        pending = deque()
        for problem in problems:
            pending.append(self.submit(problem))
            while len(pending) >= max(1, depth):
                yield pending.popleft().result()
        while pending:
            yield pending.popleft().result()

    def drain(self) -> dict:
        """Fetch every kicked output slot (shutdown, the fault ladder).
        Returns {seq: Plan}."""
        return {slot.seq: self._finish(slot.seq)
                for slot in self.output.pending()}

    # -- internals -----------------------------------------------------------

    def _eligible(self, problem) -> bool:
        from karpenter_tpu_torch.solver.flat import flat_viable

        return (problem.num_groups > 0 and problem.pref_rows is None
                and problem.group_var is None
                and getattr(problem, "aff", None) is None
                and not flat_viable(problem, self.solver.options))

    def _classic(self, problem, mode: str):
        self.classic_windows += 1
        self.last_mode = mode
        metrics.SERVING_WINDOWS.labels(mode).inc()
        return self.solver.solve_encoded_async(problem)

    def _admit(self, problem, prep):
        """Delta-encode against the mirror (the resident ladder), upload
        the pair, kick.  A failure invalidates the ring and re-solves the
        window on the classic path (:meth:`_failover`)."""
        catalog = prep.catalog
        generation = (catalog.uid, catalog.generation,
                      catalog.availability_generation)
        flat = prep.packed.reshape(-1)
        reason, idx = plan_update(self.buf, flat, generation)
        try:
            if reason:
                mode, words, h2d = "rebuild", int(flat.size), int(flat.nbytes)
                didx, dval = empty_delta(flat.size)
                self.buf.rebuild(flat, self.solver.device, generation)
                self.rebuilds += 1
                self.last_reason = reason
            elif idx.size == 0:
                mode, words, h2d = "hit", 0, 0
                didx, dval = pad_delta(idx, flat[idx], flat.size)
                self.buf.stats["hit"] += 1
            else:
                didx, dval = pad_delta(idx, flat[idx], flat.size)
                mode, words = "delta", int(idx.size)
                h2d = int(didx.nbytes + dval.nbytes)
                self.buf.mirror[idx] = flat[idx]
                self.buf.stats["delta"] += 1
            metrics.SERVING_WINDOWS.labels(mode).inc()
            pair = self.staging.upload(didx, dval)
            seq = self.ring_windows
            if mode == "rebuild":
                self.oracle.rebuild(seq, flat)
            else:
                self.oracle.apply(seq, didx, dval)
            self.ring_windows += 1
            self.last_mode = mode
            return self._kick(problem, prep, seq, mode, words, h2d, *pair)
        except DeviceFaultError as e:
            # the state (and anything the ring held) can no longer be
            # trusted: fail the window over to the classic path
            self._failover(f"device_fault:{e.kind}", "kick")
        except Exception as e:  # noqa: BLE001 — degrade, never fail
            self.invalidate("dispatch_error")
            metrics.ERRORS.labels("solver", "serving_fallback").inc()
            log.warning("serving kick failed; classic fallback engaged",
                        error=str(e)[:300])
        return self.solver.solve_encoded_async(problem)

    def _failover(self, reason: str, phase: str) -> None:
        """The host failover's bookkeeping: invalidate, count, log."""
        self.invalidate(reason)
        self.host_failovers += 1
        metrics.SERVING_WINDOWS.labels("host_failover").inc()
        log.warning(f"serving {phase} faulted; host failover engaged",
                    reason=reason)

    def _kick(self, problem, prep, seq: int, mode: str, words: int,
              h2d: int, didx, dval) -> ServingPending:
        """Run one loop iteration on the uploaded pair and park the result
        in the output ring."""
        from karpenter_tpu_torch.serving.kernels import serve_window
        from karpenter_tpu_torch.solver.torch_backend import (
            clamp_output_opts,
        )

        prep.K, prep.dense16, prep.coo16 = clamp_output_opts(
            prep.K0, prep.dense16_ok, prep.G_pad, prep.N)
        off_alloc, off_price, off_rank = self.solver.device_offerings(
            prep.catalog, prep.O_pad)
        rs = self.solver.options.right_size
        get_devtel().note_dispatch(
            "serving-kick",
            (prep.G_pad, prep.O_pad, prep.U_pad, prep.N, prep.K,
             prep.dense16, prep.coo16, rs, mode == "rebuild"),
            h2d_bytes=h2d, donated=mode != "rebuild")
        t0 = obs.now()
        with device_guard("serving-kick", devices=self.solver.device_ids):
            with get_profiler().sampled("serving-kick") as probe:
                self.buf.dev, out = serve_window(
                    self.buf.dev, didx, dval, off_alloc, off_price,
                    off_rank, G=prep.G_pad, O=prep.O_pad, U=prep.U_pad,
                    N=prep.N, right_size=rs, compact=prep.K,
                    dense16=prep.dense16, coo16=prep.coo16)
                # fetch=False: the new state stays resident and the
                # result's copy is the serving-fetch site's to account
                probe.dispatched(self.buf.dev, fetch=False)
        oseq = self.output.push(OutputSlot(
            seq=-1, dev=out, prep=prep, problem=problem, mode=mode,
            t_disp=t0, t_issued=obs.now(), kick_seq=self.kicks))
        self.kicks += 1
        metrics.SERVING_RING_OCCUPANCY.set(float(self.output.occupancy))
        obs.instant("serving.kick", seq=seq, mode=mode, words=words,
                    h2d_bytes=h2d)
        return ServingPending(self, oseq)

    def _finish(self, seq: int):
        """Claim and fetch one output slot and decode it on the classic
        decode (COO growth and node escalation re-dispatch as a single
        window would).  A ``DeviceFaultError`` fails the window over to
        the classic path; any other failed fetch invalidates the ring and
        raises."""
        from karpenter_tpu_torch.solver.torch_backend import PendingSolve

        slot = self.output.take(seq)
        if slot is None:
            raise KeyError(f"serving output slot {seq} already fetched or "
                           f"out of window")
        self.fetched += 1
        if self.kicks > slot.kick_seq + 1:
            self.overlapped += 1
        metrics.SERVING_OVERLAP.set(self.overlap_fraction)
        t0 = obs.now()
        try:
            with device_guard("serving-fetch",
                              devices=self.solver.device_ids) as guard:
                with get_profiler().sampled("serving-fetch") as probe:
                    probe.dispatched(slot.dev)
                # the words the guard hands back are the ones decoded
                # (an injected corruption lands in them)
                out_np = guard.fetch(slot.host, event=slot.event)
        except DeviceFaultError as e:
            self._failover(f"device_fault:{e.kind}", "fetch")
            return self.solver.solve_encoded_async(slot.problem).result()
        except Exception:
            self.invalidate("fetch_error")
            raise
        metrics.SERVING_RING_OCCUPANCY.set(float(self.output.occupancy))
        obs.record("serving.fetch", t0, obs.now(), seq=slot.seq,
                   mode=slot.mode)
        pend = PendingSolve(
            self.solver, slot.problem, prep=slot.prep,
            host=torch.from_numpy(np.ascontiguousarray(out_np)),
            t_disp=slot.t_disp, t_issued=slot.t_issued,
            path=f"serving-{self.solver.device.type}")
        return pend.result()


class ShardedServingPending:
    """One sharded serving window in flight: ``result()`` fetches and
    decodes it (once); ``done`` is the plan of a window that needed no
    fetch (host-routed or failed over at the kick).  A failed fetch
    raises, and raises the same error again on every later call."""

    __slots__ = ("_loop", "_kick", "_done", "_error")

    def __init__(self, loop: "ShardedServingLoop", kick, done=None):
        self._loop = loop
        self._kick = kick
        self._done = done
        self._error = None

    def result(self):
        if self._error is not None:
            raise self._error
        if self._done is None:
            try:
                self._done = self._loop._finish(self)
            except Exception as err:
                self._error = err
                raise
        return self._done


class ShardedServingLoop:
    """Deferred fetches over one sharded service: a kick per submitted
    window, at most ``capacity`` windows kicked and not fetched (the
    oldest is fetched first when the ring is full).  For a service on
    the CPU a ``DeviceFaultError`` at the kick or the fetch re-solves the
    window on the service's host route (``host_failovers``); on the card
    it raises, as any other failure does, the service having invalidated
    its state."""

    def __init__(self, service, capacity: int = 2):
        self.service = service
        self.capacity = max(1, capacity)
        self._inflight: deque = deque()
        self.windows = 0
        self.kicks = 0
        self.fetched = 0
        self.overlapped = 0          # fetched after a later kick
        self.host_failovers = 0

    @property
    def overlap_fraction(self) -> float:
        return self.overlapped / self.fetched if self.fetched else 0.0

    def submit(self, catalog, nodepool=None, pods=None):
        """Kick one sharded window; returns its deferred handle."""
        from karpenter_tpu_torch.sharded.types import ShardedPlan

        while len(self._inflight) >= self.capacity:
            self._inflight[0].result()
        self.windows += 1
        try:
            kick = self.service._kick_window(catalog, nodepool, pods)
        except DeviceFaultError:
            if holds_card(self.service):
                raise
            self._failover("kick")
            plan = self.service.solve_window_host(catalog, nodepool, pods)
            return ShardedServingPending(self, None, done=plan)
        if isinstance(kick, ShardedPlan):
            # a host-routed (pref/sto/aff) window: already decoded
            metrics.SERVING_WINDOWS.labels("classic").inc()
            return ShardedServingPending(self, None, done=kick)
        self.kicks += 1
        pend = ShardedServingPending(self, (kick, self.kicks))
        self._inflight.append(pend)
        metrics.SERVING_WINDOWS.labels(kick.delta.mode).inc()
        metrics.SERVING_RING_OCCUPANCY.set(float(len(self._inflight)))
        return pend

    def drain(self) -> list:
        """Fetch every window still in flight (shutdown, end of stream)."""
        out = []
        while self._inflight:
            out.append(self._inflight[0].result())
        return out

    def _finish(self, pend: ShardedServingPending):
        """Fetch one window.  It leaves the ring and is counted as fetched
        before the fetch, as the reference counts it, so a fetch that
        faults over to the host route counts too."""
        kick, kick_seq = pend._kick
        self._inflight.remove(pend)
        self.fetched += 1
        if self.kicks > kick_seq:
            self.overlapped += 1
        metrics.SERVING_OVERLAP.set(self.overlap_fraction)
        try:
            plan = self.service._fetch_window(kick)
        except DeviceFaultError:
            if holds_card(self.service):
                raise
            self._failover("fetch")
            # the same routed and encoded window, so ownership and shard
            # membership are identical: no window lost
            plan = self.service.solve_window_host(
                kick.catalog, kick.nodepool, window=kick.window)
        metrics.SERVING_RING_OCCUPANCY.set(float(len(self._inflight)))
        return plan

    def _failover(self, phase: str) -> None:
        self.host_failovers += 1
        metrics.SERVING_WINDOWS.labels("host_failover").inc()
        log.warning(f"sharded serving {phase} faulted; host failover "
                    f"engaged")

    def stats(self) -> dict:
        return {
            "windows": self.windows,
            "kicks": self.kicks,
            "fetched": self.fetched,
            "overlapped": self.overlapped,
            "overlap_fraction": self.overlap_fraction,
            "host_failovers": self.host_failovers,
            "inflight": len(self._inflight),
            "capacity": self.capacity,
        }


def serving_loop_of(solver):
    """The solver's ServingLoop, or None."""
    return getattr(solver, "serving", None)


__all__ = ["ServingLoop", "ServingPending", "ShardedServingLoop",
           "ShardedServingPending", "serving_loop_of"]
