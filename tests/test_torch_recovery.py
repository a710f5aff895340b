"""The port's crash-recovery plane against the reference's, on the CPU.

``recovery/{crashpoints,journal,reconciler}.py`` of
``karpenter_tpu_torch`` are copies of the reference's modules.  Each
call script runs through both packages: the journal files they write
are compared record for record (timestamps aside), and so are the
``RecoveryReport``s of ``Reconciler.recover`` (its timings aside), the
fake clouds and the nominations.  The provisioner cases crash a
``Provisioner`` at ``provision.pre_nominate`` and at the actuator's
crashpoints mid-plan, then recover with a new ``Provisioner`` and a
``Reconciler``: every pod must end nominated once, with no leaked VNI,
volume or instance.
"""

from __future__ import annotations

import json
import re

import pytest

from test_torch_provisioner import (  # noqa: F401 — fixtures
    SIDES, add_pods, claims_by_pods, fixed_ids, make_rig, new_provisioner,
    permissive_breaker, ready_nodeclass,
)


_STAMP = re.compile(r'"t":[0-9.e+-]+')


def records(path):
    """The journal file's records without their timestamps."""
    out = []
    with open(path, encoding="utf-8") as fh:
        for line in fh:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                out.append(("torn", _STAMP.sub('"t":*', line.strip())))
                continue
            rec.pop("t", None)
            out.append(rec)
    return out


def intents_view(intents):
    return sorted((i.id, i.kind, json.dumps(i.payload, sort_keys=True),
                   json.dumps(i.notes, sort_keys=True), i.outcome)
                  for i in intents)


def report_view(report):
    d = report.to_dict()
    for k in ("replay_s", "fence_s", "duration_s"):
        d.pop(k)
    return d, sorted(report.preempted_keys), dict(report.gang_admitted), \
        dict(report.gang_parked)


def cloud_view(cloud):
    return {"vnis": sorted(cloud.vnis), "volumes": sorted(cloud.volumes),
            "instances": sorted((i.id, i.name, i.profile, i.zone,
                                 i.capacity_type, i.vni_id,
                                 tuple(i.volume_ids),
                                 tuple(sorted(i.tags.items())))
                                for i in cloud.list_instances())}


def pods_view(cluster):
    return {k: (p.nominated_node, p.bound_node, p.enqueued_at == 0.0)
            for k, p in sorted(cluster._collections["pods"].items())}


def per_side(tmp_path, fixed_ids, script):
    """``script(m, path)`` once per package, each with its own journal
    path and the id counters restarted; the two outcomes."""
    outs = []
    for m in SIDES:
        fixed_ids.reset()
        path = str(tmp_path / f"{m.pkg}.jsonl")
        outs.append(script(m, path))
    assert outs[0] == outs[1]
    return outs[0]


# -- the journal --------------------------------------------------------------

def test_journal_write_ahead_crash_failure_ok_and_state(tmp_path, fixed_ids):
    """The intent is on disk before the block runs; a crash leaves it
    open with its notes and the next id past it; a clean failure and an
    ``ok`` exception close it; state is newest-wins with tombstones."""
    def script(m, path):
        J, crash = m.journal.IntentJournal, m.crash.SimulatedCrash
        j = J(path, owner="t")
        with j.intent("node_create", node="n1") as intent:
            on_disk = intents_view(m.journal.read_journal(path)[0])
        with pytest.raises(crash):
            with j.intent("node_create", node="n2") as i2:
                i2.note("vni", id="vni-9")
                raise crash("actuate.mid_create", 1)
        with pytest.raises(m.errors.CloudError):
            with j.intent("node_create", node="n3"):
                raise m.errors.CloudError("quota", 403)
        with pytest.raises(m.errors.NodeClaimNotFoundError):
            with j.intent("claim_delete", claim="c1",
                          ok=(m.errors.NodeClaimNotFoundError,)):
                raise m.errors.NodeClaimNotFoundError("c1")
        for k, v in (("nom/a", "c1"), ("nom/a", "c2"), ("nom/b", "c3"),
                     ("nom/b", None), ("nom/zz", None)):
            j.state(k, v)
        keys = (intent.idem_key("vni"), i2.idem_key("inst"))
        j.close()
        j2 = J(path, owner="t")
        opens = intents_view(j2.open_intents())
        with j2.intent("eviction", pods=[]) as i3:
            next_id = i3.id
        j2.close()
        return on_disk, opens, next_id, keys, j2.state_map(), \
            records(path), j2.stats()["records"]

    on_disk, opens, next_id, keys, state, _, _ = per_side(
        tmp_path, fixed_ids, script)
    assert len(on_disk) == 1 and on_disk[0][4] == ""
    assert len(opens) == 1 and next_id == "t-000005"
    assert keys == ("t-000001/vni", "t-000002/inst")
    assert state == {"nom/a": "c2"}


def test_journal_torn_line_compaction_and_seq(tmp_path, fixed_ids):
    """A torn final line is skipped and appended past; compaction bounds
    the file, keeps the open intent with its notes and the seq mark, so
    no id is reused."""
    def script(m, path):
        J, crash = m.journal.IntentJournal, m.crash.SimulatedCrash
        j = J(path, owner="t", max_records=80)
        for i in range(200):
            with j.intent("eviction", pods=[f"p{i}"]):
                pass
        compactions = j.stats()["compactions"]
        with pytest.raises(crash):
            with j.intent("node_create", node="keep") as intent:
                intent.note("vni", id="v1")
                raise crash("journal.append", 1)
        j.compact()
        j.close()
        with open(path, "a", encoding="utf-8") as fh:
            fh.write('{"rec":"intent","id":"t-00')
        intents, state, n, seq = m.journal.read_journal(path)
        j2 = J(path, owner="t")
        j2.state("k", 1)
        with j2.intent("node_create", node="n2") as i2:
            new_id = i2.id
        j2.close()
        return compactions, intents_view(intents), n, seq, new_id, \
            j2.state_map(), records(path)

    compactions, intents, n, seq, new_id, state, _ = per_side(
        tmp_path, fixed_ids, script)
    assert compactions >= 1 and seq == 201 and new_id == "t-000202"
    assert [i[0] for i in intents] == ["t-000201"] and state == {"k": 1}


def test_journal_compaction_is_amortized_over_a_large_state(tmp_path):
    """A live state larger than ``max_records`` (an operator nominating
    more pods than that): the port compacts when the file doubles its
    live set, the reference on every append past ``max_records``.  The
    state read back and the records on disk are the same."""
    out = []
    for m in SIDES:
        path = str(tmp_path / f"{m.pkg}.jsonl")
        j = m.journal.IntentJournal(path, owner="t", max_records=64,
                                    fsync=False)
        for i in range(400):
            j.state(f"nom/p{i}", f"c{i % 7}")
        compactions = j.stats()["compactions"]
        j.close()
        _, state, _, _ = m.journal.read_journal(path)
        reread = m.journal.IntentJournal(path, owner="t").state_map()
        out.append((compactions, state, reread))
    (ref_n, ref_state, ref_map), (n, state, reread) = out
    assert state == ref_state == reread == ref_map
    assert len(state) == 400
    assert ref_n == 400 - 64 and n == 3       # at 65, 130 and 260 records


def test_null_journal_and_idempotency_switch(tmp_path, fixed_ids):
    def script(m, path):
        nj = m.journal.NULL_JOURNAL
        assert isinstance(nj, m.journal.NullJournal)
        with nj.intent("node_create", node="x") as intent:
            key = intent.idem_key("vni")
            intent.note("vni", id="v")
        nj.state("k", 1)
        j = m.journal.IntentJournal(path, owner="t", idempotency=False)
        with j.intent("node_create", node="n1") as i2:
            off = i2.idem_key("inst")
        j.close()
        return key, nj.state_map(), nj.stats(), off, records(path)

    key, state, stats, off, _ = per_side(tmp_path, fixed_ids, script)
    assert key == off == "" and state == {} and stats == {"enabled": False}


def test_crashpoint_catalog_and_schedule():
    out = []
    for m in SIDES:
        inj = m.crash.CrashInjector("actuate.post_create", seed=7)
        with pytest.raises(ValueError):
            m.crash.CrashInjector("not.a.point", 1)
        assert issubclass(m.crash.SimulatedCrash, BaseException)
        assert not issubclass(m.crash.SimulatedCrash, Exception)
        out.append((m.crash.CRASHPOINTS, sorted(inj.crash_hits)))
    assert out[0] == out[1]


# -- the actuator's journal ---------------------------------------------------

def actuator_rig(m, path, quota=100000, idempotency=True, pods=()):
    cloud = m.fake.FakeCloud(instance_quota=quota)
    r = make_rig(m, cloud=cloud, provisioner=False,
                 journal=m.journal.IntentJournal(
                     path, owner="t", idempotency=idempotency))
    r.journal = r.actuator.journal
    for key in pods:
        r.cluster.add_pod(m.pod.PodSpec(key.split("/", 1)[1],
                                        requests=m.pod.ResourceRequests(
                                            500, 1024, 0, 1)))
    r.catalog = m.arrays.CatalogArrays.build(r.itp.list())
    r.pricing.close()
    return r


def planned(r, pods=("default/p1",)):
    return r.m.types.PlannedNode(
        instance_type=r.catalog.type_names[0], zone="us-south-1",
        capacity_type="on-demand", price=1.0, pod_names=list(pods))


@pytest.mark.parametrize("case", ["success", "failure", "mid_create",
                                  "delete"])
def test_actuator_journaling(tmp_path, fixed_ids, case):
    """A create closes its intent ok (noting every stage, the claim's
    pods as state, the intent id as a tag); a failed create closes it
    failed after its cleanup; a crash mid-create leaves it open with the
    VNI noted; a delete closes its intent ok and tombstones the pods."""
    def script(m, path):
        r = actuator_rig(m, path, quota=0 if case == "failure" else 100000)
        nc = r.cluster.get_nodeclass("default")
        if case == "failure":
            with pytest.raises(m.errors.CloudError):
                r.actuator.create_node(planned(r), nc, r.catalog)
        elif case == "mid_create":
            inj = m.crash.CrashInjector("actuate.mid_create", seed=1,
                                        first_hit_range=(1, 1),
                                        max_crashes=1)
            with m.crash.installed(inj), pytest.raises(
                    m.crash.SimulatedCrash):
                r.actuator.create_node(planned(r), nc, r.catalog)
        else:
            claim = r.actuator.create_node(planned(r), nc, r.catalog)
            if case == "delete":
                with pytest.raises(m.errors.NodeClaimNotFoundError):
                    r.actuator.delete_node(claim)
        opens = intents_view(r.journal.open_intents())
        r.journal.close()
        intents, state, _, _ = m.journal.read_journal(r.journal.path)
        return opens, intents_view(intents), state, cloud_view(r.cloud), \
            records(r.journal.path)

    opens, intents, state, cloud, _ = per_side(tmp_path, fixed_ids, script)
    outcomes = [i[4] for i in intents]
    if case == "mid_create":
        assert len(opens) == 1 and cloud["vnis"] and not cloud["instances"]
    else:
        assert opens == [] and set(outcomes) == (
            {"failed"} if case == "failure" else {"ok"})
    # the claim's pods ride the state until its delete tombstones them
    assert bool(state) == (case == "success")


# -- the reconciler -----------------------------------------------------------

def crash_create(m, path, crashpoint, add_pods=True, idempotency=True,
                 first=1):
    pods = ("default/p1",)
    r = actuator_rig(m, path, idempotency=idempotency,
                     pods=pods if add_pods else ())
    inj = m.crash.CrashInjector(crashpoint, seed=1,
                                first_hit_range=(first, first),
                                max_crashes=1)
    with m.crash.installed(inj), pytest.raises(m.crash.SimulatedCrash):
        r.actuator.create_node(planned(r, pods),
                               r.cluster.get_nodeclass("default"),
                               r.catalog)
    r.journal.close()
    r.journal = m.journal.IntentJournal(path, owner="t",
                                        idempotency=idempotency)
    return r


def recover(r):
    report = r.m.reconciler.Reconciler(r.journal, r.cloud,
                                       r.cluster).recover()
    out = (report_view(report), cloud_view(r.cloud), pods_view(r.cluster),
           claims_by_pods(r), intents_view(r.journal.open_intents()),
           r.journal.state_map())
    r.journal.close()
    return out


CREATE_CASES = [("finish", "actuate.pre_rpc"),
                ("finish", "actuate.mid_create"),
                ("finish", "actuate.post_create"),
                ("fence", "actuate.mid_create"),
                ("fence", "actuate.post_create"),
                ("committed", "journal.append"),
                ("broken_idempotency", "actuate.post_create")]


@pytest.mark.parametrize("case,crashpoint", CREATE_CASES,
                         ids=[f"{a}-{b}" for a, b in CREATE_CASES])
def test_reconciler_node_create(tmp_path, fixed_ids, case, crashpoint):
    """The fence-or-finish table for a crashed create: pods still
    waiting -> the create replays on its idempotency keys (never a
    duplicate) and the pods nominate; nobody waiting -> the half-built
    resources are deleted; a committed create (crash on its done record,
    the 6th append) closes and renominates; with the keys off the replay
    duplicates."""
    def script(m, path):
        r = crash_create(m, path, crashpoint, add_pods=case != "fence",
                         idempotency=case != "broken_idempotency",
                         first=6 if case == "committed" else 1)
        before = cloud_view(r.cloud)
        return before, recover(r)

    before, (report, cloud, pods, claims, opens, state) = per_side(
        tmp_path, fixed_ids, script)
    assert report[0]["replayed"] == 1 and opens == []
    if case == "fence":
        assert report[0]["fenced"] == 1
        assert cloud == {"vnis": [], "volumes": [], "instances": []}
    elif case == "broken_idempotency":
        assert len(cloud["instances"]) == 2
    else:
        assert report[0]["finished"] == 1 and len(cloud["instances"]) == 1
        assert set(cloud["vnis"]) == {cloud["instances"][0][5]}
        assert pods["default/p1"][0] == next(iter(claims.values()))[0]


OTHER_KINDS = ["eviction", "gang_live", "gang_dead", "state_rebuild",
               "claim_delete"]


@pytest.mark.parametrize("case", OTHER_KINDS)
def test_reconciler_other_intents_and_state(tmp_path, fixed_ids, case):
    def script(m, path):
        cloud, cluster = m.fake.FakeCloud(), m.cluster.ClusterState()
        req = m.pod.ResourceRequests(100, 100)
        NodeClaim, crash = m.nodeclaim.NodeClaim, m.crash.SimulatedCrash
        j = m.journal.IntentJournal(path, owner="t")
        if case == "eviction":
            for n in ("v1", "v2"):
                cluster.add_pod(m.pod.PodSpec(n, requests=req))
            cluster.get("pods", "default/v1").nominated_node = "old"
            with pytest.raises(crash):
                with j.intent("eviction",
                              pods=["default/v1", "default/v2"]) as i:
                    i.note("evicted:default/v1", pod="default/v1")
                    raise crash("preempt.mid_evict", 1)
        elif case in ("gang_live", "gang_dead"):
            claim = "claim-live" if case == "gang_live" else "claim-gone"
            for n in ("g1", "g2"):
                cluster.add_pod(m.pod.PodSpec(n, requests=req))
            if case == "gang_live":
                cluster.add_nodeclaim(NodeClaim(name=claim, launched=True))
            cluster.get("pods", "default/g1").nominated_node = claim
            with pytest.raises(crash):
                with j.intent("gang_placement", gang="g", claim=claim,
                              pods=["default/g1", "default/g2"]):
                    raise crash("journal.append", 1)
        elif case == "state_rebuild":
            cluster.add_nodeclaim(NodeClaim(name="c1", launched=True))
            for n in ("a", "b", "c"):
                cluster.add_pod(m.pod.PodSpec(n, requests=req))
            cluster.bind_pod("default/b", "c1")
            for k, v in (("nom/default/a", "c1"), ("nom/default/b", "c1"),
                         ("nom/default/gone", "c1"),
                         ("claimpods/c1", ["default/c"]),
                         ("preempted/default/a", 1),
                         ("preempted/default/b", 1),
                         ("gang/admitted/gg", 123.5),
                         ("gang/first_seen/hh", 99.0)):
                j.state(k, v)
        else:
            inst = cloud.create_instance(
                name="n", profile=cloud.profiles[0].name, zone="us-south-1",
                subnet_id="subnet-11", image_id="img-1")
            cluster.add_nodeclaim(NodeClaim(
                name="c1", provider_id=m.nodeclaim.provider_id(
                    "us-south", inst.id), launched=True,
                finalizers=[m.constants.CLAIM_FINALIZER]))
            with pytest.raises(crash):
                with j.intent("claim_delete", claim="c1", instance=inst.id):
                    raise crash("journal.append", 1)
        j.close()
        r = type("R", (), {})()
        r.m, r.cloud, r.cluster = m, cloud, cluster
        r.journal = m.journal.IntentJournal(path, owner="t")
        return recover(r)

    report, cloud, pods, _, opens, state = per_side(tmp_path, fixed_ids,
                                                    script)
    assert opens == []
    if case == "state_rebuild":
        assert pods["default/a"][0] == pods["default/c"][0] == "c1"
        assert "nom/default/b" not in state and report[1] == ["default/a"]
    elif case == "claim_delete":
        assert report[0]["finished"] == 1 and cloud["instances"] == []
    elif case == "gang_live":
        assert pods["default/g2"][0] == "claim-live"
    elif case == "gang_dead":
        assert pods["default/g1"][0] == ""
    else:
        assert report[1] == ["default/v1"] and pods["default/v1"][2]


# -- the provisioner's crash --------------------------------------------------

PROV_CRASHES = [("provision.pre_nominate", 1), ("actuate.post_create", 2),
                ("actuate.mid_create", 2)]


@pytest.mark.parametrize("crashpoint,first", PROV_CRASHES,
                         ids=[c for c, _ in PROV_CRASHES])
def test_provisioner_crash_then_recover(tmp_path, fixed_ids, crashpoint,
                                        first):
    """A ``Provisioner`` dies at a crashpoint (``SimulatedCrash`` is a
    ``BaseException``: it passes the actuator's per-node loop and the
    solver wrapper); a new ``Provisioner`` and ``Reconciler.recover()``
    on the same journal, cloud and cluster leave every pod nominated
    once, onto a live claim, with no leaked VNI, volume or instance."""
    def script(m, path):
        journal = m.journal.IntentJournal(path, owner="t")
        r = make_rig(m, journal=journal)
        r.actuator.breaker = permissive_breaker(m)
        add_pods(r, 40, "w", cpu=1500, mem=3072)
        inj = m.crash.CrashInjector(crashpoint, seed=1,
                                    first_hit_range=(first, first),
                                    max_crashes=1)
        with m.crash.installed(inj), pytest.raises(m.crash.SimulatedCrash):
            r.prov.provision_once()
        nominated_at_crash = sum(bool(p.nominated_node)
                                 for p in r.cluster.pending_pods())
        journal.close()
        # the restart: a new journal handle, actuator and provisioner
        j2 = m.journal.IntentJournal(path, owner="t")
        r.actuator = m.actuator.Actuator(r.cloud, r.cluster,
                                         unavailable=r.unavail, journal=j2)
        r.actuator.breaker = permissive_breaker(m)
        r.prov.stop()
        r.prov = new_provisioner(m, r.cluster, r.itp, r.actuator,
                                 journal=j2)
        report = m.reconciler.Reconciler(j2, r.cloud, r.cluster).recover()
        plans = r.prov.provision_once()
        claims = {c.name for c in r.cluster.nodeclaims() if not c.deleted}
        pods = r.cluster.pending_pods()
        assert all(p.nominated_node in claims for p in pods)
        cloud = cloud_view(r.cloud)
        used = {i[5] for i in cloud["instances"]}
        vols = {v for i in cloud["instances"] for v in i[6]}
        assert set(cloud["vnis"]) == used and set(cloud["volumes"]) == vols
        assert len(cloud["instances"]) == len(claims)
        out = (nominated_at_crash, report_view(report),
               [len(p.nodes) for p in plans], pods_view(r.cluster),
               claims_by_pods(r), cloud, j2.state_map())
        j2.close()
        r.close()
        return out

    at_crash, report, plans, *_ = per_side(tmp_path, fixed_ids, script)
    assert report[0]["replayed"] == (0 if crashpoint ==
                                     "provision.pre_nominate" else 1)
    if crashpoint == "provision.pre_nominate":
        assert at_crash == 0 and report[0]["nominations_restored"] == 40
        assert plans == []
