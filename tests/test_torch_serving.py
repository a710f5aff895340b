"""The serving loop of the port against the reference's.

The output ring keeps FIFO order through wrap-around, refuses a push
when full without starting a copy, and takes slots out of order; the
staging uploads each pair as a copy of its own, in rotation;
``apply_ring`` scatters as ``apply_ring_np`` and the reference's
``apply_ring`` do at every ``DELTA_BUCKETS`` rung; ``serve_window``
returns the reference's ``serve_window`` words over a churn stream (cost
word included); the port's own parity checks
(``raw_parity_violations``, ``plan_parity_violations``) come back empty
over 8 seeds and ``ring_state_violations`` catches a corrupted state;
``serve_stream`` plans equal ``JaxSolver(serving="on")``'s.  Backpressured
and ineligible windows go to the classic dispatch and are counted; a
failing kick raises and invalidates the ring.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from karpenter_tpu.resident.delta import pad_delta as j_pad_delta
from karpenter_tpu.serving import kernels as j_kernels
from karpenter_tpu.serving.validate import _churn_stream as j_churn
from karpenter_tpu.solver import JaxSolver, SolverOptions, encode

import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.apis.requirements as t_req
from karpenter_tpu_torch.resident.delta import DELTA_BUCKETS, pad_delta
from karpenter_tpu_torch.resident.kernels import new_state
from karpenter_tpu_torch.serving import RING_SLOTS, serving_enabled
from karpenter_tpu_torch.serving import kernels as t_kernels
from karpenter_tpu_torch.serving.oracle import (
    RingOracle, apply_ring_np, serve_window_np,
)
from karpenter_tpu_torch.serving.ring import OutputRing, OutputSlot, Staging
from karpenter_tpu_torch.serving.service import serving_loop_of
from karpenter_tpu_torch.serving.validate import (
    _churn_stream as t_churn, plan_parity_violations, raw_parity_violations,
    ring_state_violations,
)
from karpenter_tpu_torch.solver import (
    SolverOptions as TSolverOptions, TorchSolver,
)
from karpenter_tpu_torch.solver import encode as t_encode
from tests.test_torch_packed import assert_words_equal
from tests.test_torch_solver import assert_plans_equal


def _pair(n, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 100, n).astype(np.int32),
            rng.randint(-5, 5, n).astype(np.int32))


# -- rings --------------------------------------------------------------------


def _slot(k):
    return OutputSlot(seq=-1, dev=torch.full((4,), k), prep=None,
                      problem=None, mode="delta")


def test_output_ring_fifo_and_wrap_around():
    ring = OutputRing(3)
    for k in range(7):
        seq = ring.push(_slot(k))
        slot = ring.take(seq)
        assert (seq, slot.seq, int(slot.host[0])) == (k, k, k)
    assert (ring.head, ring.tail) == (7, 7)
    for k in range(3):
        ring.push(_slot(k))
    assert ring.full and [ring.take(s).seq for s in (7, 8, 9)] == [7, 8, 9]
    assert ring.take(10) is None and ring.occupancy == 0


def test_full_push_fetches_nothing(monkeypatch):
    from karpenter_tpu_torch.solver import torch_backend

    ring = OutputRing(2)
    fetches = []
    real = torch_backend.start_fetch

    def counting(dev):
        fetches.append(int(dev[0]))
        return real(dev)

    monkeypatch.setattr(torch_backend, "start_fetch", counting)
    assert ring.push(_slot(0)) == 0 and ring.push(_slot(1)) == 1
    assert ring.push(_slot(2)) is None
    assert fetches == [0, 1] and ring.occupancy == 2


def test_staging_uploads_copies_in_rotation():
    staging = Staging(3, device="cpu")
    for k in range(7):
        didx, dval = _pair(64 if k % 2 else 128, k)
        d_idx, d_val = staging.upload(didx, dval)
        assert d_idx.dtype == d_val.dtype == torch.int32
        want = torch.from_numpy(dval.copy())
        dval += 1                               # the host pair is reused
        assert torch.equal(d_idx, torch.from_numpy(didx))
        assert torch.equal(d_val, want)
    assert staging.uploads == 7 and staging.device.type == "cpu"
    with pytest.raises(ValueError, match="slot"):
        Staging(0, device="cpu")


def test_output_ring_out_of_order_take():
    ring = OutputRing(3)
    for k in range(3):
        assert ring.push(_slot(k)) == k
    assert ring.push(_slot(3)) is None
    slot = ring.take(1)
    assert slot.seq == 1 and int(slot.host[0]) == 1 and slot.event is None
    assert ring.head == 0 and ring.take(1) is None
    assert ring.take(0).seq == 0 and ring.head == 2
    assert ring.take(2).seq == 2 and ring.head == 3 and not ring.full
    assert ring.take(5) is None


# -- programs -----------------------------------------------------------------


@pytest.mark.parametrize("rung", DELTA_BUCKETS)
def test_apply_ring_matches_numpy_and_reference(rung):
    rng = np.random.RandomState(rung + 1)
    L = 2 * rung + 3
    flat = rng.randint(-1000, 1000, L).astype(np.int32)
    n = rung // 2 + 1 if rung > DELTA_BUCKETS[0] else 3
    idx = np.sort(rng.choice(L, n, replace=False))
    didx, dval = pad_delta(idx, rng.randint(-9, 9, n).astype(np.int32), L)
    want = apply_ring_np(flat, didx, dval)
    ref = np.asarray(j_kernels.apply_ring(jnp.asarray(flat), didx, dval))
    got = t_kernels.apply_ring(new_state(flat, "cpu"),
                               torch.from_numpy(didx), torch.from_numpy(dval))
    np.testing.assert_array_equal(ref, want)
    np.testing.assert_array_equal(got[:-1].numpy(), want)


def test_apply_ring_rejects_off_rung_slots():
    state = new_state(np.zeros(10, np.int32), "cpu")
    with pytest.raises(ValueError, match="DELTA_BUCKETS"):
        t_kernels.apply_ring(state, torch.zeros(63, dtype=torch.int32),
                             torch.zeros(63, dtype=torch.int32))


def test_serve_window_matches_reference_words():
    """The reference's churn stream: each window's delta through both
    ``serve_window``s; the port's equals ``serve_window_np`` with the
    port's classic solve, too."""
    from karpenter_tpu_torch.solver.packed import solve_packed_torch

    js = JaxSolver(SolverOptions(backend="jax", use_pallas="off"))
    t = torch.from_numpy
    for seed in range(2):
        seqs, catalog = j_churn(48, 6, 5, 40 + seed)
        jstate = tstate = mirror = None
        for pods in seqs:
            prep = js._prepare(encode(pods, catalog))
            flat = prep.packed.reshape(-1)
            kw = dict(G=prep.G_pad, O=prep.O_pad, U=prep.U_pad, N=prep.N)
            cat = [np.array(x) for x in js._device_offerings(catalog,
                                                             prep.O_pad)]
            if mirror is None or mirror.shape != flat.shape:
                mirror, jstate = flat.copy(), jnp.asarray(flat)
                tstate = new_state(flat, "cpu")
                base = flat.copy()
                idx = np.empty(0, np.int64)
            else:
                idx = np.nonzero(mirror != flat)[0]
                base = mirror.copy()
                mirror[idx] = flat[idx]
            didx, dval = j_pad_delta(idx, flat[idx], flat.size)
            jstate, ref = j_kernels.serve_window(jstate, didx, dval, *cat,
                                                 **kw)
            tstate, got = t_kernels.serve_window(
                tstate, t(didx), t(dval), *(t(x) for x in cat), **kw)
            assert_words_equal(np.asarray(ref), got.numpy(), kw["G"],
                               kw["N"])
            _, twin = serve_window_np(
                base, didx, dval, lambda s: solve_packed_torch(
                    t(s), *(t(x) for x in cat), **kw).numpy())
            np.testing.assert_array_equal(twin, got.numpy())


def test_raw_parity_violations_empty_over_8_seeds():
    assert raw_parity_violations(seeds=8, device="cpu") == []


def test_plan_parity_violations_empty_over_8_seeds():
    assert plan_parity_violations(seeds=8, device="cpu") == []


def _serving_solver(**kw):
    return TorchSolver(TSolverOptions(serving="on", **kw), device="cpu")


def test_ring_state_violations_is_falsifiable():
    seqs, catalog = t_churn(48, 6, 3, 2)
    solver = _serving_solver()
    list(solver.serve_stream(t_encode(p, catalog) for p in seqs))
    loop = serving_loop_of(solver)
    assert ring_state_violations(loop, catalog) == []
    loop.buf.dev[3] += 1                       # the device state drifts
    got = ring_state_violations(loop)
    assert any("mirror diverged" in v for v in got)
    assert any("oracle replay diverged" in v for v in got)
    loop.buf.dev[3] -= 1
    loop.oracle.mirror = None                  # a slot bypassed the replay
    assert any("cold" in v for v in ring_state_violations(loop))
    catalog.generation += 1                    # a missed invalidation
    assert "generation" in ring_state_violations(loop, catalog)[0]


def test_oracle_refuses_replays_out_of_order():
    oracle = RingOracle()
    with pytest.raises(AssertionError, match="before any rebuild"):
        oracle.apply(0, *pad_delta(np.zeros(0, np.int64),
                                   np.zeros(0, np.int32), 4))
    oracle.rebuild(0, np.zeros(4, np.int32))
    with pytest.raises(AssertionError, match="out of order"):
        oracle.rebuild(0, np.zeros(4, np.int32))
    with pytest.raises(AssertionError, match="rung"):
        oracle.apply(1, np.full(3, 4, np.int32), np.zeros(3, np.int32))
    assert oracle.diverges(np.zeros(4, np.int32)) == 0


@pytest.mark.parametrize("seed", range(2))
def test_serve_stream_plans_match_jax(seed):
    jseqs, jcat = j_churn(64, 6, 5, 60 + seed)
    tseqs, tcat = t_churn(64, 6, 5, 60 + seed)
    jon = JaxSolver(SolverOptions(backend="jax", use_pallas="off",
                                  serving="on"))
    on = _serving_solver()
    jplans = list(jon.serve_stream([encode(p, jcat) for p in jseqs]))
    tplans = list(on.serve_stream([t_encode(p, tcat) for p in tseqs]))
    for jp, tp_ in zip(jplans, tplans):
        assert_plans_equal(jp, tp_)
    assert on.last_stats["path"] == "serving-cpu"
    st, jst = on.serving.stats(), jon.serving.stats()
    for k in ("windows", "ring_windows", "classic_windows", "rebuilds",
              "kicks", "fetched", "overlapped"):
        assert st[k] == jst[k], k
    assert st["buffer"]["delta"] >= 1


def test_backpressure_and_ineligible_windows_go_classic():
    seqs, catalog = t_churn(48, 6, 4, 3)
    solver = _serving_solver()
    loop = solver.serving
    loop.output = OutputRing(1)
    loop.capacity = 1
    off = TorchSolver(TSolverOptions(serving="off"), device="cpu")
    problems = [t_encode(p, catalog) for p in seqs]
    pending = [loop.submit(p) for p in problems[:3]]
    assert loop.backpressured == 2 and loop.ring_windows == 1
    for h, p in zip(pending, problems):
        assert_plans_equal(off.solve_encoded(p), h.result())
    pref = [t_pod.PodSpec("p", preferred_requirements=((50, t_req.Requirement(
        t_req.LABEL_ZONE, t_req.Operator.IN, ("us-south-1",))),))]
    h = loop.submit(t_encode(pref, catalog))
    assert h.result().nodes and solver.last_stats["path"] == "pref-cpu"
    st = loop.stats()
    assert (st["windows"], st["classic_windows"], st["backpressured"],
            st["ring_windows"]) == (4, 3, 2, 1)
    assert loop.last_mode == "classic"


def test_failing_kick_raises_and_invalidates(monkeypatch):
    seqs, catalog = t_churn(48, 6, 3, 5)
    solver = _serving_solver()
    loop = solver.serving
    loop.submit(t_encode(seqs[0], catalog)).result()

    def broken(*a, **k):
        raise RuntimeError("serving kick failed")

    monkeypatch.setattr(t_kernels, "serve_window", broken)
    solver.last_stats = {}
    with pytest.raises(RuntimeError, match="serving kick failed"):
        loop.submit(t_encode(seqs[1], catalog))
    assert loop.invalidations == 1 and loop.buf.dev is None
    assert loop.output.occupancy == 0 and loop.oracle.mirror is None
    assert loop.classic_windows == 0 and solver.last_stats == {}
    monkeypatch.undo()
    loop.submit(t_encode(seqs[1], catalog)).result()
    assert loop.last_mode == "rebuild" and loop.last_reason == "dispatch_error"
    assert ring_state_violations(loop, catalog) == []


def test_serving_gate_and_default_capacity(monkeypatch):
    monkeypatch.delenv("KARPENTER_ENABLE_SERVING", raising=False)
    assert not serving_enabled(TSolverOptions())
    monkeypatch.setenv("KARPENTER_ENABLE_SERVING", "yes")
    assert serving_enabled(TSolverOptions())
    assert not serving_enabled(TSolverOptions(serving="off"))
    loop = TorchSolver(TSolverOptions(), device="cpu").serving
    assert loop.capacity == RING_SLOTS and loop.staging.device.type == "cpu"
    plain = TorchSolver(TSolverOptions(serving="off"), device="cpu")
    assert plain.serving is None and serving_loop_of(plain) is None
