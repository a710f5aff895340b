"""The port's HTTP server against the reference's, on the CPU.

Both packages' ``operator/server.py::MetricsServer`` are started on
127.0.0.1 port 0 in this process and asked the same requests after the
same script, over ``urllib``: the admission answers over the documents
of ``tests/test_admission.py`` (the bare document, the AdmissionReview
envelope, malformed bodies), the health and readiness probes, the
``/metrics`` family names in both expositions, the keys of every
``/debug/*`` payload and of ``/statusz``, the what-if endpoint's 200,
429, 503 and 500 answers, and the ``/debug/profile`` payload over a
window solved while the capture runs, with its single-flight 429.
Every test starts both packages from empty metric families, an empty
flight recorder, a fresh device profiler and a fresh watchdog, put back
after (``tests/test_torch_obs_parity.py::fresh``): the earlier tests of
the worker must not decide a payload's keys.

On the card a stacked what-if plan that faults raises out of
``PlanningService.evaluate``; the endpoint answers 500 with the error's
type and text where the reference (which plans on the host instead)
answers 200 or 503.  That answer is shown here with a service whose ``evaluate``
raises ``DeviceFaultError``.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

from test_torch_obs_parity import fresh  # noqa: F401 — autouse fixture
from test_torch_operator import OSIDES, same
from test_torch_provisioner import (  # noqa: F401 — fixture
    add_pods, fixed_ids, make_rig, run_both,
)
from test_torch_whatif_service import SIDES as WSIDES
from test_torch_whatif_service import (
    make_catalog, make_pods, make_service, seeded_ledger, without_walls,
)


@contextlib.contextmanager
def served(m, **kw):
    srv = m.server.MetricsServer(host="127.0.0.1", port=0, **kw).start()
    try:
        yield f"http://127.0.0.1:{srv.port}"
    finally:
        srv.stop()


def request(url, data=None, headers=None, method=None):
    """(status, content type, body) of one request; an HTTP error status
    is an answer, not an exception."""
    req = urllib.request.Request(url, data=data, headers=headers or {},
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=30) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers["Content-Type"], e.read()


def get_json(url):
    code, ctype, body = request(url)
    assert ctype == "application/json", (code, body[:200])
    return code, json.loads(body)


def keys(obj, depth=2):
    """The nested key structure of a payload, ``depth`` levels deep
    (lists read through their first item)."""
    if depth == 0:
        return None
    if isinstance(obj, dict):
        return {k: keys(v, depth - 1) for k, v in obj.items()}
    if isinstance(obj, list) and obj:
        return [keys(obj[0], depth - 1)]
    return type(obj).__name__


# -- admission ----------------------------------------------------------------

def doc(**spec):
    """``tests/test_admission.py::TestAdmissionEndpoint._doc``."""
    base = {"region": "us-south", "image": "img-1",
            "instanceProfile": "bx2-4x16", "vpc": "vpc-1"}
    base.update(spec)
    return {"metadata": {"name": "x"}, "spec": base}


HC = {"protocol": "http", "path": "/hz", "intervalSeconds": 30,
      "timeoutSeconds": 5, "maxRetries": 3}

ADMISSION = {
    "valid": doc(),
    "iks-without-cluster": doc(bootstrapMode="iks-api"),
    "review-bad-zone": {"apiVersion": "admission.k8s.io/v1",
                        "kind": "AdmissionReview",
                        "request": {"uid": "u-123",
                                    "object": doc(zone="eu-de-1")}},
    "review-valid": {"kind": "AdmissionReview",
                     "request": {"uid": "u-1", "object": doc()}},
    "unknown-field": {"metadata": {"name": "x"},
                      "spec": {"region": "us-south", "unknownThing": 1}},
    "health-check": {"metadata": {"name": "hc"}, "spec": {
        "region": "us-south", "instanceProfile": "bx2-4x16",
        "image": "img-1", "loadBalancerIntegration": {
            "enabled": True, "targetGroups": [{
                "loadBalancerID": "lb-1", "poolName": "web", "port": 443,
                "healthCheck": HC}]}}},
    "nested-not-a-dict": {"metadata": {"name": "x"},
                          "spec": {"region": "us-south", "kubelet": "big"}},
    "not-an-object": [1, 2],
    "not-json": b"{nope",
}


@pytest.mark.parametrize("name", sorted(ADMISSION))
def test_admission_answers_match_reference(name):
    """``POST /validate-nodeclass`` answers each document of
    ``tests/test_admission.py`` (and the malformed bodies) as the
    reference does: status, content type and body."""
    body = ADMISSION[name]
    data = body if isinstance(body, bytes) else json.dumps(body).encode()

    def script(m):
        with served(m) as base:
            code, ctype, out = request(
                f"{base}/validate-nodeclass", data=data,
                headers={"Content-Type": "application/json"},
                method="POST")
        return code, ctype, json.loads(out)

    code, _, out = same(script)
    if name == "valid":
        assert out == {"allowed": True, "errors": []}
    elif name == "not-json":
        assert code == 400
    elif name.startswith("review"):
        assert out["kind"] == "AdmissionReview"


# -- probes and /metrics ------------------------------------------------------

def test_probes_and_unknown_paths_match_reference():
    """``/healthz``, ``/readyz`` before and after the ready check turns,
    and 404 for an unknown GET and POST."""
    def script(m):
        ready = [False]
        with served(m, ready_check=lambda: ready[0]) as base:
            out = [request(f"{base}/healthz")[:2],
                   json.loads(request(f"{base}/healthz")[2])["status"],
                   request(f"{base}/readyz")]
            ready[0] = True
            out += [request(f"{base}/readyz"), request(f"{base}/nope"),
                    request(f"{base}/metrics2"),
                    request(f"{base}/debug/whatif/x")[0],
                    request(f"{base}/other", data=b"{}", method="POST")]
        return out

    out = same(script)
    assert out[2][0] == 503 and out[3][0] == 200 and out[4][0] == 404


def families(m, text: str) -> dict:
    """{family: kind} from the ``# TYPE`` lines of an exposition, for the
    families the package's ``utils/metrics.py`` defines (tests register
    throwaway families in a package's registry)."""
    defined = {f.name for f in vars(m.metrics).values()
               if isinstance(f, m.metrics._Metric)}
    out = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ", 3)
            if name in defined or f"{name}_total" in defined:
                out[name] = kind
    return out


@pytest.mark.parametrize("accept", ["text", "openmetrics"])
def test_metrics_families_match_reference(accept, fixed_ids):
    """``/metrics`` after one provisioning window: the same families of
    the same kinds, in the same content type, each exposition."""
    headers = {"Accept": "application/openmetrics-text; version=1.0.0"} \
        if accept == "openmetrics" else {}
    rigs_ = [make_rig(m) for m in OSIDES]
    for r in rigs_:
        r.ids = fixed_ids
    try:
        def script(r):
            add_pods(r, 20)
            r.prov.provision_once()
            with served(r.m) as base:
                code, ctype, body = request(f"{base}/metrics",
                                            headers=headers)
            return code, ctype, families(r.m, body.decode()), body.decode()

        (ca, ta, fa, body_a), (cb, tb, fb, body_b) = run_both(rigs_, script)
    finally:
        for r in rigs_:
            r.close()
    assert (ca, ta) == (cb, tb) and ca == 200
    assert fa == fb, ({k: v for k, v in fa.items() if fb.get(k) != v},
                      {k: v for k, v in fb.items() if fa.get(k) != v})
    assert 'karpenter_tpu_solve_duration_seconds_count{backend="torch"}' \
        in body_b
    if accept == "openmetrics":
        assert body_a.rstrip().endswith("# EOF")
        assert body_b.rstrip().endswith("# EOF")


# -- the debug surface --------------------------------------------------------

DEBUG = ("/debug/traces?limit=5", "/debug/traces?status=error&min_ms=x",
         "/debug/slo", "/debug/explain?limit=3",
         "/debug/explain?pod=default/pod-0", "/debug/telemetry",
         "/debug/risk", "/statusz")


def test_debug_payload_keys_match_reference(fixed_ids):
    """Every ``/debug/*`` payload and ``/statusz`` after one provisioning
    window with one unplaced pod: 200, JSON, the same keys two levels
    deep (the recorder, ledger and explain state each package's own),
    and the same explain verdicts."""
    from test_torch_controllers import own_state

    def script(m):
        r = make_rig(m)
        r.ids = fixed_ids
        fixed_ids.reset()
        out = {}
        try:
            with own_state(m.pkg):
                add_pods(r, 8)
                add_pods(r, 1, prefix="huge", cpu=10_000_000)
                r.prov.provision_once()
                with served(m, statusz=lambda: {"backend": "x"}) as base:
                    for path in DEBUG:
                        code, payload = get_json(base + path)
                        assert code == 200, path
                        out[path] = keys(payload)
                        if path.startswith("/debug/explain"):
                            out[path] = (out[path], payload["summary"],
                                         [e["reason"]
                                          for e in payload["pods"]])
        finally:
            r.close()
        return out

    out = same(script)
    assert out["/debug/explain?pod=default/pod-0"][2] == []
    assert out["/debug/explain?limit=3"][2]          # the huge pod


class StubWhatIf:
    """A planning service whose ``evaluate`` answers ``payload`` (None: a
    plan already in flight) or raises ``error``."""

    def __init__(self, payload=None, error=None):
        self.payload, self.error = payload, error

    def evaluate(self, horizon_hours=None, scenario_names=None):
        if self.error is not None:
            raise self.error
        return self.payload

    def recommendations(self, limit=None):
        return []


def whatif_stub(m, kind):
    if kind == "off":
        return None
    if kind == "busy":
        return StubWhatIf()
    if kind == "unresolved":
        return StubWhatIf({"error": "no catalog"})
    fault = importlib.import_module(f"{m.pkg}.faulttol")
    return StubWhatIf(error=fault.DeviceFaultError("scan faulted"))


@pytest.mark.parametrize("kind", ["off", "busy", "unresolved", "fault"])
def test_whatif_status_codes_match_reference(kind):
    """``/debug/whatif``: 503 while the plane is off or its inputs do not
    resolve, 429 while a plan is in flight, 500 when ``evaluate`` raises
    (the port's answer to a fault on the card), its text led by the
    error's type where the reference's is the text alone."""
    def script(m):
        with served(m, whatif=whatif_stub(m, kind)) as base:
            return get_json(f"{base}/debug/whatif?horizon=x&scenarios=a,b")

    ref, (code, payload) = (script(m) for m in OSIDES)
    assert code == {"off": 503, "busy": 429, "unresolved": 503,
                    "fault": 500}[kind]
    if kind == "fault":
        # the port's 500 leads with the error's type
        assert ref == (500, {"error": "scan faulted"})
        assert payload == {"error": "DeviceFaultError: scan faulted"}
    else:
        assert ref == (code, payload)


def test_whatif_plan_payload_matches_reference():
    """A real ``PlanningService`` behind the endpoint: 200, the payload
    (clock fields aside) and its registry equal to the reference's; the
    port's plan on the CPU."""
    def script(m, w):
        catalog = make_catalog(w)
        pods = make_pods(w, 24, seed=3)
        with w.obs.use_ledger(seeded_ledger(w, pods)):
            svc = make_service(w, catalog, pods)
            evaluate = svc.evaluate
            svc.evaluate = lambda **kw: evaluate(hour=9, **kw)
            with served(m, whatif=svc) as base:
                code, payload = get_json(
                    f"{base}/debug/whatif?horizon=6&scenarios=baseline,"
                    f"spot-storm")
        return code, without_walls(payload)

    ref, port = (script(m, w) for m, w in zip(OSIDES, WSIDES))
    assert ref == port
    code, payload = port
    assert code == 200 and payload["registry"] == []   # nothing recorded
    assert [s["scenario"] for s in payload["scenarios"]] == \
        ["baseline", "spot-storm"]


# -- /debug/profile -----------------------------------------------------------

def test_profile_capture_over_a_window_matches_reference(fixed_ids):
    """``/debug/profile`` taken while a window is solved: samples of the
    same kernels, the same payload keys and Chrome trace names; a second
    capture meanwhile answers 429."""
    rigs_ = [make_rig(m) for m in OSIDES]
    for r in rigs_:
        r.ids = fixed_ids
    try:
        def script(r):
            add_pods(r, 12, prefix="warm")
            r.prov.provision_once()          # shapes built before the capture
            out = {}
            prof = importlib.import_module(f"{r.m.pkg}.obs.prof")
            with served(r.m) as base:
                def capture():
                    out["first"] = get_json(
                        f"{base}/debug/profile?duration_s=3")

                t = threading.Thread(target=capture)
                t.start()
                end = time.monotonic() + 30
                while prof.get_profiler()._capture is None and \
                        time.monotonic() < end:
                    time.sleep(0.01)
                add_pods(r, 12)
                r.prov.provision_once()
                out["second"] = get_json(f"{base}/debug/profile?duration_s=1")
                t.join(timeout=60)
                assert not t.is_alive()
            code, payload = out["first"]
            samples = payload["samples"]
            return (code, out["second"][0], keys(payload, 1),
                    payload["duration_s"],
                    sorted({s["kernel"] for s in samples}),
                    sorted(payload["device_time"]),
                    sorted({e["name"] for e in payload["chrome"]
                            ["traceEvents"]}), bool(samples))

        a, b = run_both(rigs_, script)
    finally:
        for r in rigs_:
            r.close()
    assert a == b
    assert a[0] == 200 and a[1] == 429 and a[-1]


def test_profile_capture_with_no_window_holds_no_sample():
    """With no dispatch in flight a capture holds no sample (the port's
    device time comes from CUDA events around a dispatch); the duration
    clamps as the reference's."""
    def script(m):
        with served(m) as base:
            code, payload = get_json(f"{base}/debug/profile?duration_s=0")
        return code, payload["sample_count"], payload["duration_s"], \
            payload["device_time"]

    assert same(script)[:2] == (200, 0)

