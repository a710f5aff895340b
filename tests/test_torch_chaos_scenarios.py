"""The port's chaos scenarios against the reference's, on the CPU.

Every profile of the matrix runs at seed 1 through both harnesses (the
port's with ``device="cpu"``): the event traces hash to the same digest
and the invariant verdicts are the same, message for message, in the
same order.  The fixture profiles fail in both alike, with the same
replay command up to the package name.  The crash matrix runs two
crashpoints and ``run_soak`` the short day against the reference.  The
reference's sharded plane runs on a one-device mesh, as the port's holds
every shard on one card.  On the card a device fault raises out of the
scenario; that path is shown here by making the sharded wrapper, and the
harness's last serving rung, treat their planes as on the card.  Claim
names and bootstrap tokens come from counters
restarted before each side (``fixed_ids``).  The full matrix (4 seeds x
10 rounds) and the production day are ``slow``.
"""

from __future__ import annotations

import dataclasses
import re
import secrets
import tempfile
import uuid
from pathlib import Path

import pytest

import karpenter_tpu.chaos.crash as j_crash
import karpenter_tpu.chaos.runner as j_runner
import karpenter_tpu.chaos.soak as j_soak
from karpenter_tpu.chaos.profile import FIXTURE_PROFILES as J_FIXTURES
from karpenter_tpu.chaos.profile import PROFILES as J_PROFILES

import karpenter_tpu_torch.chaos.crash as t_crash
import karpenter_tpu_torch.chaos.runner as t_runner
import karpenter_tpu_torch.chaos.soak as t_soak
from karpenter_tpu_torch.chaos.__main__ import main as chaos_main
from karpenter_tpu_torch.chaos.profile import FIXTURE_PROFILES, PROFILES
from karpenter_tpu_torch.faulttol import DeviceFaultError

from tests.test_torch_provisioner import FixedIds

ROUNDS = 4


@pytest.fixture(autouse=True)
def one_device_mesh(monkeypatch):
    """The reference's sharded plane on one device, as the port holds
    every shard on one card (the tests' JAX has eight CPU devices, and a
    wider mesh would name more devices in the fault trace)."""
    import jax

    import karpenter_tpu.sharded as j_sharded
    from karpenter_tpu.parallel.mesh import shard_mesh

    wide = j_sharded.ShardedSolveService

    def narrow(num_shards, **kw):
        kw.setdefault("mesh", shard_mesh(num_shards,
                                         devices=jax.devices()[:1]))
        return wide(num_shards, **kw)

    monkeypatch.setattr(j_sharded, "ShardedSolveService", narrow)


@pytest.fixture
def fixed_ids(monkeypatch):
    ids = FixedIds()
    monkeypatch.setattr(uuid, "uuid4", ids.uuid4)
    monkeypatch.setattr(secrets, "token_hex", ids.token_hex)
    return ids


def unported(text: str) -> str:
    """A replay command or report with the port's package name read as
    the reference's (the one string allowed to differ), and a stale
    orphan's age masked: an instance stamped by a dataclass default
    carries real wall time (``chaos/clock.py``), so that age moves with
    the host's load, in the reference's own reruns too."""
    return ORPHAN_AGE.sub(r"\1<age>s", text.replace("karpenter_tpu_torch",
                                                    "karpenter_tpu"))


# the no-stale-orphan message's age field (chaos/invariants.py)
ORPHAN_AGE = re.compile(r"(untracked for )\d+s")


def verdicts(res):
    return [(v.invariant, unported(v.render())) for v in res.violations]


def both(fixed_ids, name, seed=1, rounds=ROUNDS):
    fixed_ids.reset()
    ref = j_runner.run_scenario(name, seed, rounds=rounds)
    fixed_ids.reset()
    port = t_runner.run_scenario(name, seed, rounds=rounds, device="cpu")
    return ref, port


def test_profile_registries_name_the_same_scenarios():
    assert list(PROFILES) == list(J_PROFILES)
    assert list(FIXTURE_PROFILES) == list(J_FIXTURES)


@pytest.mark.parametrize("name", list(J_PROFILES))
def test_profile_gives_the_reference_digest_and_verdicts(fixed_ids, name):
    ref, port = both(fixed_ids, name)
    assert port.digest == ref.digest
    assert verdicts(port) == verdicts(ref)
    assert len(port.trace) == len(ref.trace)
    assert unported(port.replay) == ref.replay


@pytest.mark.parametrize("name", ["broken-fixture",
                                  "broken-affinity-fixture", "broken-ring"])
def test_fixture_fails_alike_with_the_replay_command(fixed_ids, name):
    ref, port = both(fixed_ids, name, rounds=5)
    assert not ref.ok and not port.ok
    assert port.digest == ref.digest
    assert verdicts(port) == verdicts(ref)
    assert port.replay == (f"python -m karpenter_tpu_torch.chaos "
                           f"--profile {name} --seed 1 --rounds 5")
    assert unported(port.render_failure()) == unported(ref.render_failure())


def test_run_matrix_reports_a_fixture_failure_alike(fixed_ids, tmp_path):
    lines = {}
    for k, mod in (("j", j_runner), ("t", t_runner)):
        fixed_ids.reset()
        out: list[str] = []
        kw = {"device": "cpu"} if mod is t_runner else {}
        results, failures = mod.run_matrix(
            ["broken-fixture"], seeds=(1,), rounds=5,
            verify_determinism=True, trace_dir=str(tmp_path / k),
            echo=out.append, **kw)
        assert failures and not results[0].ok
        assert (tmp_path / k / "broken-fixture-seed1.jsonl").exists()
        lines[k] = [ln.replace(str(tmp_path / k), "<dir>") for ln in out]
    assert [unported(ln) for ln in lines["t"]] == \
        [unported(ln) for ln in lines["j"]]


@pytest.mark.parametrize("crashpoint", ["actuate.mid_create",
                                        "preempt.mid_evict"])
def test_crash_cells_recover_as_the_reference(fixed_ids, monkeypatch,
                                              crashpoint):
    made: list[str] = []
    real = tempfile.mkdtemp

    def mkdtemp(*a, **k):
        made.append(real(*a, **k))
        return made[-1]

    monkeypatch.setattr(tempfile, "mkdtemp", mkdtemp)
    fixed_ids.reset()
    ref = j_crash.run_crash_scenario(crashpoint, 1, rounds=6)
    fixed_ids.reset()
    port = t_crash.run_crash_scenario(crashpoint, 1, rounds=6,
                                      device="cpu")
    assert port.digest == ref.digest
    assert (port.crashes, port.restarts) == (ref.crashes, ref.restarts)
    assert verdicts(port) == verdicts(ref)
    assert unported(port.replay) == ref.replay
    assert port.crashes > 0
    # every cell removed its journal directory
    assert len(made) == 2 and not any(Path(d).exists() for d in made)


def seg_view(seg: dict) -> tuple:
    """A soak segment's record without its bundle path."""
    return (seg["segment"], seg["rounds"], seg["chaos_violations"],
            seg["resolved_so_far"], seg["open_records"])


def test_short_soak_day_matches_the_reference(fixed_ids, tmp_path):
    out = {}
    for k, mod in (("j", j_soak), ("t", t_soak)):
        fixed_ids.reset()
        kw = {"device": "cpu"} if mod is t_soak else {}
        res = mod.run_soak(mod.SHORT_DAY, seed=1,
                           report_dir=str(tmp_path / k / "report"),
                           triage_dir=str(tmp_path / k / "triage"),
                           echo=lambda *_: None, **kw)
        out[k] = res
    ref, port = out["j"], out["t"]
    assert port.ok == ref.ok
    assert port.chaos_violations == ref.chaos_violations == 0
    assert port.gate_proven and ref.gate_proven
    assert [r.spec.name for r in port.report.burned] == \
        [r.spec.name for r in ref.report.burned]
    assert port.summary["resolved"] == ref.summary["resolved"] > 0
    assert [seg_view(s) for s in port.segments] == \
        [seg_view(s) for s in ref.segments]


def test_harness_meant_for_the_card_raises_without_one(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device requested"):
        t_runner.ChaosHarness(PROFILES["calm"], 1)
    assert chaos_main(["--profile", "calm", "--seed", "1", "--rounds", "1",
                       "--device", "cpu"]) == 0


def on_the_card(monkeypatch):
    """The sharded wrapper treats its service as one on the card: its
    device fault raises instead of degrading to the host route."""
    import karpenter_tpu_torch.sharded.degraded as sd

    monkeypatch.setattr(sd, "holds_card", lambda obj: True)


def test_device_fault_on_the_card_raises_out_of_the_scenario(
        fixed_ids, monkeypatch, capsys):
    """device-fault with its plane on the card: the first injected fault
    the sharded wrapper sees raises out of ``run_scenario`` (counted
    once by the guard, no host plan), and the CLI reports the scenario
    as failed with its replay command."""
    from karpenter_tpu_torch.utils import metrics

    on_the_card(monkeypatch)
    before = metrics.ERRORS.samples()
    with pytest.raises(DeviceFaultError):
        t_runner.run_scenario("device-fault", 1, rounds=10, device="cpu")
    moved = {k: v - before.get(k, 0.0)
             for k, v in metrics.ERRORS.samples().items()
             if v != before.get(k, 0.0)}
    assert sum(v for (c, _), v in moved.items() if c == "device") == 1
    assert not any(k.startswith("degraded_") or k.endswith("_fallback")
                   for _, k in moved)
    capsys.readouterr()
    assert chaos_main(["--profile", "device-fault", "--seed", "1",
                       "--rounds", "10", "--device", "cpu"]) == 1
    printed = capsys.readouterr().out
    assert "CHAOS DEVICE FAULT scenario=device-fault seed=1" in printed
    assert ("replay: python -m karpenter_tpu_torch.chaos --profile "
            "device-fault --seed 1 --rounds 10") in printed


def fetch_ladder_faults(monkeypatch, inject_mod):
    """The injector faults every serving fetch and the classic re-solve
    that fails it over, so a window escapes the loop's own ladder and
    reaches the harness's last rung."""
    def draw(self, kernel, candidates):
        if not self.armed or not candidates:
            return None
        hit = kernel == "serving-fetch" or (
            kernel == "scan" and getattr(self, "_last", None) ==
            "serving-fetch")
        self._last = kernel
        if not hit:
            return None
        self.injected += 1
        return "error", candidates[0]

    monkeypatch.setattr(inject_mod.FaultyDeviceInjector, "draw", draw)


def test_serving_window_past_the_ladder_raises_on_the_card(
        fixed_ids, monkeypatch):
    """serving-storm with every fetch and its classic re-solve faulted.
    On the CPU the window completes on the host oracle, as in the
    reference, with the same digest.  With the serving solver on the
    card the fault raises out of ``run_scenario``: the guard counted
    each fault once, and no window went to the host oracle."""
    import karpenter_tpu.faulttol.inject as j_inject
    import karpenter_tpu_torch.faulttol.inject as t_inject
    from karpenter_tpu_torch.faulttol import get_injector
    from karpenter_tpu_torch.utils import metrics

    fetch_ladder_faults(monkeypatch, j_inject)
    fetch_ladder_faults(monkeypatch, t_inject)
    ref, port = both(fixed_ids, "serving-storm")
    assert port.digest == ref.digest
    assert port.trace.of_kind("serving")[-1]["host_oracle"] > 0

    monkeypatch.setattr(t_runner, "holds_card", lambda obj: True)
    before = metrics.ERRORS.samples()
    fixed_ids.reset()
    harness = t_runner.ChaosHarness(PROFILES["serving-storm"], 1,
                                    rounds=ROUNDS, device="cpu")
    with pytest.raises(DeviceFaultError) as err:
        harness.run()
    assert err.value.kernel == "scan"
    moved = {k: v - before.get(k, 0.0)
             for k, v in metrics.ERRORS.samples().items()
             if v != before.get(k, 0.0) and k[0] == "device"}
    assert moved == {("device", "error"): get_injector().injected}
    assert get_injector().injected == 2
    assert harness.serving_probe.host_oracle == 0


def test_serving_storm_without_faults_keeps_the_ring_busy(fixed_ids):
    """serving-storm with its device faults taken out (the profile the
    card runs): every window comes back and the ring carries most of
    them, as in the reference."""
    out = {}
    for k, runner in (("j", j_runner), ("t", t_runner)):
        prof = dataclasses.replace(
            runner.get_profile("serving-storm"), device_fault_rates={})
        fixed_ids.reset()
        kw = {"device": "cpu"} if runner is t_runner else {}
        out[k] = runner.run_scenario(prof, 1, rounds=ROUNDS, **kw)
    assert out["t"].digest == out["j"].digest
    assert out["t"].ok and out["j"].ok
    last = out["t"].trace.of_kind("serving")[-1]
    assert last["ring"] > 0 and last["failover"] == 0


@pytest.mark.slow
def test_full_matrix_equals_the_reference(fixed_ids):
    for name in list(J_PROFILES) + list(J_FIXTURES):
        for seed in (1, 2, 3, 4):
            ref, port = both(fixed_ids, name, seed=seed, rounds=10)
            assert port.digest == ref.digest, (name, seed)
            assert verdicts(port) == verdicts(ref), (name, seed)


@pytest.mark.slow
def test_production_day_equals_the_reference(fixed_ids, tmp_path):
    out = {}
    for k, mod in (("j", j_soak), ("t", t_soak)):
        fixed_ids.reset()
        kw = {"device": "cpu"} if mod is t_soak else {}
        out[k] = mod.run_soak(mod.PRODUCTION_DAY, seed=1,
                              report_dir=str(tmp_path / k),
                              triage_dir=str(tmp_path / k / "triage"),
                              echo=lambda *_: None, **kw)
    assert out["t"].ok and out["j"].ok
    assert [seg_view(s) for s in out["t"].segments] == \
        [seg_view(s) for s in out["j"].segments]
    assert out["t"].summary["resolved"] == out["j"].summary["resolved"]
