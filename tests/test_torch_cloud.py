"""The port's catalog half of the cloud layer against the reference.

``karpenter_tpu_torch.cloud`` (errors, retry, profile, resources, fake),
``apis/nodeclass.py`` and the instance-type provider of
``catalog/instancetype.py`` are copies of the reference's modules; each
test here runs both packages on the same call script and compares what
comes back: error classes, backoff waits (an injected ``sleep`` and
``rng``, nothing sleeps for real), profiles and prices, validation
error lists, and the listed instance types field for field.
"""

import dataclasses
import random

import pytest

from karpenter_tpu.apis import nodeclass as j_nc
from karpenter_tpu.catalog import instancetype as j_it
from karpenter_tpu.catalog.pricing import PricingProvider as JPricing
from karpenter_tpu.catalog.unavailable import UnavailableOfferings as JUnavail
from karpenter_tpu.cloud import errors as j_err
from karpenter_tpu.cloud import fake as j_fake
from karpenter_tpu.cloud import retry as j_retry
from karpenter_tpu_torch.apis import nodeclass as t_nc
from karpenter_tpu_torch.catalog import instancetype as t_it
from karpenter_tpu_torch.catalog.pricing import PricingProvider as TPricing
from karpenter_tpu_torch.catalog.unavailable import (
    UnavailableOfferings as TUnavail,
)
from karpenter_tpu_torch.cloud import errors as t_err
from karpenter_tpu_torch.cloud import fake as t_fake
from karpenter_tpu_torch.cloud import retry as t_retry

PAIRS = (
    (j_err, j_retry, j_fake, j_nc, j_it, JPricing, JUnavail),
    (t_err, t_retry, t_fake, t_nc, t_it, TPricing, TUnavail),
)


# -- errors ------------------------------------------------------------------

def _error_menu(err):
    return [
        ValueError("instance i-1 not found"),
        RuntimeError("no such subnet"),
        RuntimeError("Rate limit exceeded"),
        RuntimeError("429 too many requests"),
        TimeoutError("read timed out"),
        RuntimeError("context deadline exceeded"),
        RuntimeError("quota exhausted for vCPU"),
        RuntimeError("insufficient capacity in zone"),
        RuntimeError("profile out of stock"),
        PermissionError("Forbidden"),
        RuntimeError("invalid token"),
        RuntimeError("boom"),
        err.CloudError("typed", status_code=429, retry_after=2.5),
        err.CloudError("typed", status_code=409),
        err.CloudError("typed", status_code=503, retryable=False),
        err.CloudError("typed", code="custom"),
        err.not_found("instance", "i-9"),
    ]


def _error_view(err, e):
    p = err.parse_error(e, operation="op")
    return (type(p).__name__, p.message, p.status_code, p.code, p.retryable,
            p.retry_after, p.operation, err.is_retryable(e),
            err.is_rate_limit(p), err.is_not_found(p), err.is_timeout(p),
            err.is_capacity(p), err.is_quota(p), err.is_auth(p), repr(p))


def test_error_classification_matches_reference():
    views = [[_error_view(err, e) for e in _error_menu(err)]
             for err, *_ in PAIRS]
    assert views[0] == views[1]
    # the predicates on an untyped error
    for err, *_ in PAIRS:
        assert err.is_retryable(RuntimeError("timed out"))
        assert not err.is_rate_limit(RuntimeError("rate limit"))
        assert str(err.NodeClaimNotFoundError("c1")) == \
            "nodeclaim 'c1': instance not found"


# -- retry -------------------------------------------------------------------

def _retry_script(err, retry, failures, config_kw, budget=None, seed=5):
    """Run ``retry_with_backoff`` over a function that raises
    ``failures`` in turn and then returns 7: (result or error text,
    attempts, waits)."""
    waits, calls = [], []
    script = list(failures)

    def fn():
        calls.append(1)
        if script:
            raise script.pop(0)
        return 7

    try:
        out = retry.retry_with_backoff(
            fn, retry.RetryConfig(**config_kw), sleep=waits.append,
            operation="op", rng=random.Random(seed), budget=budget)
    except Exception as e:  # noqa: BLE001 — the outcome is compared
        out = f"{type(e).__name__}: {e}"
    return out, len(calls), waits


@pytest.mark.parametrize("case", [
    "jitter", "geometric", "retry_after", "non_retryable", "exhausted",
    "budget"])
def test_retry_waits_match_reference(case):
    def failures(err):
        flaky = [RuntimeError("timed out")] * 4
        return {
            "jitter": flaky,
            "geometric": flaky,
            "retry_after": [err.CloudError("slow down", 429,
                                           retry_after=3.25)] * 2 + flaky,
            "non_retryable": [RuntimeError("timed out"),
                              err.CloudError("bad", 400)],
            "exhausted": [RuntimeError("internal error")] * 12,
            "budget": flaky,
        }[case]

    kw = {"geometric": {"jitter": False},
          "exhausted": {"steps": 4, "cap": 2.0}}.get(case, {})
    budget = 3.5 if case == "budget" else None
    outs = [_retry_script(err, retry, failures(err), kw, budget)
            for err, retry, *_ in PAIRS]
    assert outs[0] == outs[1]
    out, attempts, waits = outs[1]
    if case == "geometric":
        assert waits == [1.0, 2.0, 4.0, 8.0] and out == 7
    if case == "retry_after":
        assert waits[:2] == [3.25, 3.25]
    if case == "budget":
        # the first wait fits a 3.5 s budget on the real clock; the
        # injected sleep spends none of it, so every wait is checked
        # against the same remainder and the first one over it raises
        assert all(w < 3.5 for w in waits) and attempts == len(waits) + 1
    if case == "exhausted":
        assert attempts == 4 and out.startswith("RuntimeError")


# -- profiles, prices and the fake cloud --------------------------------------

def test_profiles_and_prices_match_reference():
    for count in (1, 7, 30, 61, 500):
        for families in (("bx2", "cx2", "mx2"), ("gx3", "bx2", "cx2", "mx2"),
                         ("ux2d",)):
            jp = j_fake.generate_profiles(count, families=families)
            tp = t_fake.generate_profiles(count, families=families)
            assert [dataclasses.astuple(p) for p in jp] == \
                [dataclasses.astuple(p) for p in tp]
            assert [j_fake.profile_price(p) for p in jp] == \
                [t_fake.profile_price(p) for p in tp]


def test_fake_cloud_catalog_calls_match_reference():
    clouds = [fake.FakeCloud(profiles=fake.generate_profiles(40),
                             region="eu-de")
              for _, _, fake, *_ in PAIRS]
    j, t = clouds
    assert j.list_zones() == t.list_zones() == ["eu-de-1", "eu-de-2",
                                                "eu-de-3"]
    assert [dataclasses.astuple(p) for p in j.list_instance_profiles()] == \
        [dataclasses.astuple(p) for p in t.list_instance_profiles()]
    names = [p.name for p in t.profiles]
    assert [j.get_pricing(n) for n in names] == \
        [t.get_pricing(n) for n in names]
    # an unknown profile is the same typed 404, a one-shot injected error
    # fires once, and the call log records both sides alike
    for c, (err, *_rest) in zip(clouds, PAIRS):
        with pytest.raises(err.CloudError) as ei:
            c.get_pricing("nope-1x1")
        assert ei.value.status_code == 404
        c.recorder.inject_error("list_zones", RuntimeError("flaky"))
        with pytest.raises(RuntimeError, match="flaky"):
            c.list_zones()
        assert c.list_zones() == ["eu-de-1", "eu-de-2", "eu-de-3"]
    assert {k: len(v) for k, v in j.recorder.calls.items()} == \
        {k: len(v) for k, v in t.recorder.calls.items()}


def _resource_view(obj):
    return {k: v for k, v in dataclasses.asdict(obj).items()
            if not k.endswith("_at")}


def test_fake_cloud_instance_lifecycle_matches_reference():
    views = []
    for _, _, fake, *_ in PAIRS:
        c = fake.FakeCloud(profiles=fake.generate_profiles(12))
        a = c.create_instance("n1", "bx2-2x8", "us-south-1", "subnet-11",
                              "img-1", idempotency_key="k1")
        again = c.create_instance("n1", "bx2-2x8", "us-south-1",
                                  "subnet-11", "img-1", idempotency_key="k1")
        b = c.create_instance("n2", "cx2-4x8", "us-south-2", "subnet-21",
                              "img-1", capacity_type="spot")
        c.preempt_spot_instance(b.id)
        c.delete_instance(a.id)
        views.append((_resource_view(a), again.id == a.id,
                      sorted(_resource_view(i)["id"]
                             for i in c.list_instances()),
                      [_resource_view(i)["status"]
                       for i in c.list_instances()],
                      c.quota_status(), c.instance_count(),
                      [_resource_view(s) for s in c.list_subnets()]))
    assert views[0] == views[1]


# -- NodeClass ---------------------------------------------------------------

SPECS = [
    {"metadata": {"name": "ok"},
     "spec": {"region": "us-south", "instanceProfile": "bx2-4x16",
              "image": "img-1"}},
    {"metadata": {"name": "auto"},
     "spec": {"region": "us-south", "zone": "us-south-2",
              "instanceRequirements": {"architecture": "amd64", "minCPU": 4,
                                       "minMemoryGiB": 8,
                                       "maxHourlyPrice": 1.5},
              "imageSelector": {"os": "ubuntu", "majorVersion": "24"},
              "kubelet": {"maxPods": 64,
                          "kubeReserved": {"cpu": "200m"}},
              "placementStrategy": {"zoneBalance": "CostOptimized"}}},
    {"metadata": {"name": "empty"}, "spec": {}},
    {"metadata": {"name": "both"},
     "spec": {"region": "us-south", "instanceProfile": "bx2-4x16",
              "instanceRequirements": {"minCPU": 2}, "image": "i",
              "imageSelector": {"os": "rhel"}, "zone": "eu-de-1",
              "subnet": "net-1", "securityGroups": ["", "sg ok"],
              "sshKeys": ["k!"], "vpc": "v/1",
              "bootstrapMode": "iks-api"}},
    {"metadata": {"name": "ranges"},
     "spec": {"region": "us-south", "instanceProfile": "bx2-4x16",
              "image": "img-1", "kubelet": {"maxPods": 5000},
              "placementStrategy": {
                  "zoneBalance": "Random",
                  "subnetSelection": {"minimumAvailableIPs": -1}},
              "blockDeviceMappings": [
                  {"rootVolume": True, "volume": {"capacityGB": 5}},
                  {"rootVolume": True, "volume": {"capacityGB": 20000}}],
              "loadBalancerIntegration": {
                  "enabled": True,
                  "targetGroups": [{"poolName": "p", "port": 0}]}}},
    {"metadata": {"name": "arch"},
     "spec": {"region": "us-south", "image": "img-1",
              "instanceRequirements": {"architecture": "sparc",
                                       "minCPU": -1},
              "bootstrapMode": "magic"}},
]

BAD_DOCS = [
    {"metadata": {"name": "x"}, "spec": {"regio": "us-south"}},
    {"metadata": {"name": "x"},
     "spec": {"instanceRequirements": {"minCPUs": 2}}},
    {"metadata": {"name": "x"}, "spec": {"kubelet": {"maxpods": 2}}},
    {"metadata": {"name": "x"},
     "spec": {"blockDeviceMappings": [{"volume": {"size": 1}}]}},
    {"metadata": "nope", "spec": {}},
    {"metadata": {"name": "x"},
     "spec": {"loadBalancerIntegration": {"targetGroups": [
         {"port": 1, "healthCheck": {"proto": "tcp"}}]}}},
]


def test_nodeclass_validation_matches_reference():
    for doc in SPECS:
        j = j_nc.nodeclass_from_dict(doc)
        t = t_nc.nodeclass_from_dict(doc)
        assert dataclasses.asdict(j.spec) == dataclasses.asdict(t.spec)
        assert j.validate() == t.validate(), doc["metadata"]["name"]
        assert j.spec_hash() == t.spec_hash()
    assert t_nc.nodeclass_from_dict(SPECS[0]).validate() == []
    assert len(t_nc.nodeclass_from_dict(SPECS[3]).validate()) >= 8
    for doc in BAD_DOCS:
        errs = []
        for nc in (j_nc, t_nc):
            with pytest.raises(nc.ValidationError) as ei:
                nc.nodeclass_from_dict(doc)
            errs.append(str(ei.value))
        assert errs[0] == errs[1]


def test_nodeclass_status_conditions_match_reference():
    out = []
    for nc in (j_nc, t_nc):
        st = nc.NodeClassStatus()
        st.set_condition("Ready", "False", "Init", now=1.0)
        st.set_condition("Ready", "False", "Still", now=2.0)
        st.set_condition("Ready", "True", "Done", now=3.0)
        st.set_condition("Validated", "True", now=4.0)
        out.append(([dataclasses.astuple(c) for c in st.conditions],
                    st.is_ready()))
    assert out[0] == out[1]
    assert out[1][0][0] == ("Ready", "True", "Done", "", 3.0)


# -- the instance-type provider ------------------------------------------------

def _type_view(it):
    return (it.name, it.cpu_milli, it.memory_mib, it.gpu, it.pods,
            it.architecture, it.family, it.size, it.overhead_cpu_milli,
            it.overhead_memory_mib, it.torus, it.torus_dims,
            it.allocatable_cpu_milli, it.allocatable_memory_mib,
            [dataclasses.astuple(o) for o in it.offerings],
            it.label_values(),
            None if it.cheapest_offering() is None
            else dataclasses.astuple(it.cheapest_offering()))


KUBELETS = {
    "none": None,
    "reserved": {"maxPods": 48, "kubeReserved": {"cpu": "250m",
                                                 "memory": "2Gi"},
                 "systemReserved": {"cpu": "0.5", "memory": "512Mi"},
                 "evictionHard": {"memory.available": "1Gi"}},
    "malformed": {"kubeReserved": {"cpu": "lots", "memory": "2Gi"},
                  "systemReserved": {"memory": "??"},
                  "evictionHard": {"memory.available": "x"}},
}


def _nodeclass(nc, kubelet):
    spec = {"region": "us-south", "instanceProfile": "bx2-4x16",
            "image": "img-1"}
    if kubelet is not None:
        spec["kubelet"] = kubelet
    return nc.nodeclass_from_dict({"metadata": {"name": "nc"},
                                   "spec": spec})


@pytest.mark.parametrize("kubelet", sorted(KUBELETS))
def test_instance_type_provider_lists_field_equal(kubelet):
    views = []
    for _, _, fake, nc, it, pricing_cls, unavail_cls in PAIRS:
        cloud = fake.FakeCloud(profiles=fake.generate_profiles(
            45, families=("gx3", "bx2", "ux2d", "mx2")))
        pricing = pricing_cls(cloud)
        try:
            prov = it.InstanceTypeProvider(cloud, pricing)
            types = prov.list(_nodeclass(nc, KUBELETS[kubelet]))
            views.append(([_type_view(t) for t in types],
                          prov.zones(), prov.get("bx2-8x32") is not None,
                          it.compute_overhead(
                              _nodeclass(nc, KUBELETS[kubelet]).spec.kubelet)))
        finally:
            pricing.close()
    assert views[0] == views[1]
    types, zones, _, overhead = views[1]
    assert len(types) == 45 and zones == ["us-south-1", "us-south-2",
                                          "us-south-3"]
    if kubelet == "malformed":
        # each malformed quantity keeps its own default
        assert overhead == (100 + 100, 2048 + 1024 + 500)
    if kubelet == "reserved":
        assert overhead == (750, 2048 + 512 + 1024)
        assert {t[4] for t in types} == {48}


def test_provider_reapplies_blackouts_by_generation():
    """The provider's list() re-derives availability whenever the
    blackout set's generation changes, and returns the same objects
    while it does not; a TTL expiry restores the offering."""
    outs = []
    for _, _, fake, nc, it, pricing_cls, unavail_cls in PAIRS:
        clock = [0.0]
        unavail = unavail_cls(clock=lambda: clock[0])
        cloud = fake.FakeCloud(profiles=fake.generate_profiles(12))
        pricing = pricing_cls(cloud, clock=lambda: clock[0])
        try:
            prov = it.InstanceTypeProvider(cloud, pricing, unavail,
                                           clock=lambda: clock[0])
            first = prov.list()
            same = prov.list() is first
            unavail.mark_unavailable("bx2-4x16", "us-south-2", "spot",
                                     ttl=30.0)
            blacked = prov.list()
            steady = prov.list() is blacked
            clock[0] = 31.0
            restored = prov.list()
            prov.refresh()
            after_refresh = prov.list()
            calls = len(cloud.recorder.calls["list_instance_profiles"])
            outs.append((same, steady,
                         [[o.available for o in t.offerings] for t in blacked],
                         [[o.available for o in t.offerings]
                          for t in restored],
                         [_type_view(t) for t in after_refresh], calls))
        finally:
            pricing.close()
    assert outs[0] == outs[1]
    same, steady, blacked, restored, _, calls = outs[1]
    assert same and steady
    assert sum(not a for row in blacked for a in row) == 1
    assert all(a for row in restored for a in row)
    # one list for the prices, one per catalog build (first, after refresh)
    assert calls == 3


REQS = [
    {},
    {"architecture": "amd64", "min_cpu": 8},
    {"architecture": "arm64"},
    {"min_memory_gib": 64, "max_hourly_price": 2.0},
    {"gpu": True},
    {"max_hourly_price": 0.3},
]


def test_filter_and_score_match_reference():
    outs = []
    for _, _, fake, nc, it, pricing_cls, unavail_cls in PAIRS:
        cloud = fake.FakeCloud(profiles=fake.generate_profiles(
            40, families=("gx3", "bx2", "cx2", "mx2")))
        # a price-less type ranks by size (the score's fallback)
        pricing = pricing_cls(cloud)
        try:
            types = it.InstanceTypeProvider(cloud, pricing).list()
        finally:
            pricing.close()
        types[3].offerings[:] = [dataclasses.replace(o, price=0.0)
                                 for o in types[3].offerings]
        row = []
        for r in REQS:
            picked = it.filter_instance_types(
                types, nc.InstanceRequirements(**r))
            row.append([t.name for t in picked])
        row.append([it.instance_type_score(t, p) for t in types
                    for p in (0.0, 0.25, 3.0)])
        outs.append(row)
    assert outs[0] == outs[1]
    assert outs[1][0] and not outs[1][2]        # every type; no arm64
    assert all(n.startswith("gx3") for n in outs[1][4])
