"""ChaosCloud: seeded fault injection over any cloud client.

Wraps a cloud client (FakeCloud, stub, fake IKS — anything exposing the
``list_/get_/create_/delete_/update_`` surface) and injects faults drawn
from one seeded ``random.Random`` stream according to a declarative
:class:`~karpenter_tpu_torch.chaos.profile.ChaosProfile`:

- typed errors from the ``cloud/errors.py`` taxonomy (429 with
  Retry-After, 5xx, timeouts, spurious not-found);
- injected latency, paid in virtual-clock seconds;
- *partial* list responses (a random subset, order preserved);
- mid-create failures AFTER the instance exists server-side — the
  response is "lost", a Karpenter-tagged instance leaks with no claim
  (the orphan-cleanup path);
- per-tick storms via the wrapped fake's simulation hooks: spot
  preemption waves, metadata health degradation, and (type, zone)
  capacity blackouts, so ``controllers/faults.py`` sees real
  ``status_reason``/``health_state`` flips.

Single-threaded by contract (the harness drives everything through the
deterministic ``sync()`` path): one rng stream + one call order =
one fault schedule per (profile, seed).
"""

from __future__ import annotations

import random
from collections.abc import Callable

from karpenter_tpu_torch.chaos.profile import ChaosProfile
from karpenter_tpu_torch.chaos.trace import EventTrace
from karpenter_tpu_torch.cloud.errors import CloudError

# the wrapped API surface; simulation/test hooks (preempt_*, fail_*,
# degrade_*) and introspection (quota_status, instance_count) pass
# through unwrapped
_API_PREFIXES = ("list_", "get_", "create_", "delete_", "update_")


def make_error(kind: str, method: str, rng: random.Random) -> CloudError:
    """Materialize one taxonomy kind into a typed CloudError."""
    if kind == "rate_limited":
        return CloudError(f"injected rate limit on {method}", 429,
                          retry_after=float(rng.choice((1, 2, 5, 10))),
                          operation=method)
    if kind == "internal":
        return CloudError(f"injected internal error on {method}", 500,
                          operation=method)
    if kind == "unavailable":
        return CloudError(f"injected service unavailable on {method}", 503,
                          operation=method)
    if kind == "timeout":
        return CloudError(f"injected timeout on {method}", 408,
                          operation=method)
    if kind == "conflict":
        return CloudError(f"injected conflict on {method}", 409,
                          operation=method)
    if kind == "not_found":
        return CloudError(f"injected not-found on {method}", 404,
                          operation=method)
    raise ValueError(f"unknown chaos error kind {kind!r}")


class ChaosCloud:
    """Fault-injecting proxy; ``inner`` is the ground-truth client."""

    def __init__(self, inner, profile: ChaosProfile,
                 rng: random.Random | None = None, clock=None,
                 trace: EventTrace | None = None):
        self.inner = inner
        self.profile = profile
        self.rng = rng or random.Random(0)
        self.clock = clock
        self.trace = trace if trace is not None else EventTrace()
        self.armed = False
        # (profile_name, zone) -> ticks remaining in a capacity blackout
        self._blackouts: dict[tuple[str, str], int] = {}

    # -- arming --------------------------------------------------------------

    def arm(self) -> None:
        self.armed = True

    def disarm(self) -> None:
        """Stop injecting and lift standing storms (quiesce phase)."""
        self.armed = False
        for key in list(self._blackouts):
            self._lift_blackout(key)

    # -- proxy ---------------------------------------------------------------

    def __getattr__(self, name: str):
        attr = getattr(self.inner, name)
        if callable(attr) and name.startswith(_API_PREFIXES):
            return self._wrap(name, attr)
        return attr

    def _wrap(self, method: str, fn: Callable):
        def call(*args, **kwargs):
            if not self.armed:
                return fn(*args, **kwargs)
            p = self.profile
            span = p.latency_for(method)
            if span is not None and self.clock is not None:
                self.clock.advance(self.rng.uniform(*span))
            rate = p.rate_for(method)
            if rate > 0 and self.rng.random() < rate:
                kinds = [k for k, _ in p.error_kinds]
                weights = [w for _, w in p.error_kinds]
                kind = self.rng.choices(kinds, weights=weights, k=1)[0]
                err = make_error(kind, method, self.rng)
                self.trace.add("fault", method=method, error=kind,
                               status=err.status_code)
                raise err
            if method == "create_instance" and p.create_leak_rate > 0 \
                    and self.rng.random() < p.create_leak_rate:
                inst = fn(*args, **kwargs)   # the create SUCCEEDED...
                self.trace.add("fault", method=method, error="leaked_create",
                               profile=inst.profile, zone=inst.zone)
                # ...but the response is lost: the caller sees a 500 and
                # cannot clean up an instance id it never learned
                raise CloudError(
                    "injected connection reset: create response lost", 500,
                    operation=method)
            result = fn(*args, **kwargs)
            if method.startswith("list_") and isinstance(result, list) \
                    and len(result) > 1 and p.partial_list_rate > 0 \
                    and self.rng.random() < p.partial_list_rate:
                keep = self.rng.randint(1, len(result) - 1)
                idx = sorted(self.rng.sample(range(len(result)), keep))
                self.trace.add("fault", method=method, error="partial_list",
                               dropped=len(result) - keep)
                result = [result[i] for i in idx]
            return result
        return call

    # -- per-tick storms ------------------------------------------------------

    def tick(self) -> None:
        """One scenario round of storms against the wrapped fake's
        simulation hooks.  No-ops per feature when the inner client does
        not expose the matching hook."""
        if not self.armed:
            return
        p = self.profile
        if p.preempt_storm_rate > 0 and hasattr(self.inner, "preempt_spot_instance") \
                and self.rng.random() < p.preempt_storm_rate:
            hit = 0
            for inst in self.inner.list_instances():
                if inst.capacity_type == "spot" and inst.status == "running" \
                        and self.rng.random() < p.preempt_storm_frac:
                    self.inner.preempt_spot_instance(inst.id)
                    hit += 1
            if hit:
                self.trace.add("storm", storm="spot_preemption", instances=hit)
        if p.degrade_rate > 0 and hasattr(self.inner, "degrade_instance") \
                and self.rng.random() < p.degrade_rate:
            running = [i for i in self.inner.list_instances()
                       if i.status == "running" and i.health_state == "ok"]
            if running:
                victim = running[self.rng.randrange(len(running))]
                state = self.rng.choice(("degraded", "faulted"))
                self.inner.degrade_instance(victim.id, state)
                self.trace.add("storm", storm="health_degradation",
                               state=state, profile=victim.profile,
                               zone=victim.zone)
        # age standing blackouts BEFORE arming new ones, so a blackout
        # armed this tick survives the full capacity_blackout_rounds
        # (aging last would decrement it immediately: rounds=1 would be
        # a no-op nothing ever observes)
        for key in list(self._blackouts):
            self._blackouts[key] -= 1
            if self._blackouts[key] <= 0:
                self._lift_blackout(key)
        if p.capacity_blackout_rate > 0 \
                and hasattr(self.inner, "capacity_limits") \
                and self.rng.random() < p.capacity_blackout_rate:
            profiles = [pr.name for pr in self.inner.profiles]
            zones = list(self.inner.zone_names)
            key = (self.rng.choice(profiles), self.rng.choice(zones))
            if key not in self._blackouts:
                self.inner.capacity_limits[key] = 0
            self._blackouts[key] = p.capacity_blackout_rounds
            self.trace.add("storm", storm="capacity_blackout",
                           profile=key[0], zone=key[1],
                           rounds=p.capacity_blackout_rounds)

    def _lift_blackout(self, key: tuple[str, str]) -> None:
        self._blackouts.pop(key, None)
        limits = getattr(self.inner, "capacity_limits", None)
        if limits is not None and limits.get(key) == 0:
            del limits[key]
            self.trace.add("storm", storm="capacity_restored",
                           profile=key[0], zone=key[1])
