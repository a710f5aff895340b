"""Metrics + health + admission HTTP server (port of
``karpenter_tpu/operator/server.py``).

The observability endpoint the deploy manifests scrape (§5.5 parity with
the reference's metrics service + probes): ``/metrics`` serves the
Prometheus text exposition from utils/metrics, ``/healthz`` liveness,
``/readyz`` readiness (operator started and controller manager live).

``POST /validate-nodeclass`` serves the SAME spec validation the
in-process admission path enforces, for out-of-process writers (ref
``ibmnodeclass_webhook.go`` — the reference registers a validation
webhook for exactly this).  Accepts either a Kubernetes AdmissionReview
envelope (returns the AdmissionReview response shape) or a bare
CRD-shaped NodeClass document (returns ``{"allowed", "errors"}``).

Debug surface (docs/design/observability.md):

- ``GET /debug/traces[?status=error&min_ms=10&limit=20&trace_id=N]`` —
  recent traces from the process flight recorder (karpenter_tpu_torch.obs),
  newest first, errors never evicted by successes; ``trace_id=`` is the
  exact-lookup fetch for ids printed by /debug/slo's worst-pod table;
- ``GET /debug/slo`` — live SLO evaluation over the placement ledger
  (worst-case pods with trace ids, burn state, device telemetry);
- ``GET /debug/explain[?pod=ns/name&limit=N]`` — per-pod placement
  explainability (karpenter_tpu_torch/explain): canonical unplaced reason,
  elimination bitmask, nearest-miss offering, reason summary;
- ``GET /debug/profile[?duration_s=N]`` — on-demand device-time
  capture (karpenter_tpu_torch/obs/prof.py): single-flight, duration-capped,
  returns per-dispatch dispatch/execute/fetch decomposition plus a
  Perfetto-loadable Chrome trace;
- ``GET /debug/risk`` — spot-interruption risk model
  (karpenter_tpu_torch/stochastic/risk.py): per-(type, zone) learned rates
  the solver prices into offering ranking, plus the ledger's raw
  labeled interruption/exposure history;
- ``GET /debug/telemetry`` — device telemetry words
  (karpenter_tpu_torch/obs/telemetry_words): the slot registry, per-plane
  solve-quality aggregates (fill/slack/placement/escalations), and
  the recorder's bounded per-window telemetry ring;
- ``GET /debug/whatif[?horizon=H&scenarios=a,b]`` — on-demand what-if
  evaluation (karpenter_tpu_torch/whatif): the standing scenario menu solved
  as one stacked dispatch, per-scenario outcomes + ranked capacity
  recommendations + the bounded audit registry; single-flight (429),
  503 while the plane is off;
- ``GET /statusz`` — uptime, build identity, last solve breakdown,
  ledger + recorder + device-telemetry snapshots, leader /
  circuit-breaker state (the operator wires its own extras in via the
  ``statusz`` callback).

stdlib http.server on a daemon thread — no extra dependencies.

On the card a ``/debug/profile`` sample carries the CUDA-event time of
its dispatch (``obs/prof.py``); a capture with no solve in flight holds
no sample, as the reference's.  One answer differs by design: a stacked
what-if plan that faults on the card raises out of
``PlanningService.evaluate`` (no host plan stands in for it), which
``/debug/whatif`` answers with 500 and the error's type and text (the
reference's 500 carries the text alone).
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse
from collections.abc import Callable

from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

log = get_logger("operator.server")


def _telemetry_summary() -> dict:
    """telemetry_words.summary() that never fails a statusz read."""
    try:
        from karpenter_tpu_torch.obs import telemetry_words

        return telemetry_words.summary()
    except Exception:  # noqa: BLE001 — debug surface
        return {}


def validate_nodeclass_document(doc: dict) -> list:
    """Shared webhook-side validation: parse the CRD-shaped dict and run
    the same ``validate()`` the in-process admission uses.  Returns the
    violation list (parse failures are violations too)."""
    from karpenter_tpu_torch.apis.nodeclass import ValidationError, nodeclass_from_dict

    if not isinstance(doc, dict):
        return [f"NodeClass document must be a JSON object, "
                f"got {type(doc).__name__}"]
    try:
        nc = nodeclass_from_dict(doc)
    except ValidationError as e:
        return [str(e)]
    except (TypeError, ValueError, KeyError, AttributeError) as e:
        # AttributeError covers non-dict nested fields ({"spec":
        # {"kubelet": "big"}}) — a malformed document is a denial, not a
        # dropped connection
        return [f"malformed NodeClass document: {e}"]
    return nc.validate()


def _admission_response(body) -> dict:
    """Handle both AdmissionReview and bare-object requests."""
    if not isinstance(body, dict):
        return {"allowed": False,
                "errors": [f"request body must be a JSON object, "
                           f"got {type(body).__name__}"]}
    if body.get("kind") == "AdmissionReview":
        request = body.get("request") or {}
        errs = validate_nodeclass_document(request.get("object") or {})
        return {
            "apiVersion": body.get("apiVersion",
                                   "admission.k8s.io/v1"),
            "kind": "AdmissionReview",
            "response": {
                "uid": request.get("uid", ""),
                "allowed": not errs,
                **({"status": {"code": 422,
                               "message": "; ".join(errs)}} if errs else {}),
            },
        }
    errs = validate_nodeclass_document(body)
    return {"allowed": not errs, "errors": errs}


class MetricsServer:
    """Serves /metrics, /healthz, /readyz, and /validate-nodeclass.

    With ``tls_cert``/``tls_key`` the listener speaks HTTPS — the webhook
    deployment runs a SECOND instance of this server on the webhook port
    with the serving certificate the ValidatingWebhookConfiguration's
    caBundle trusts (ref chart wiring around ibmnodeclass_webhook.go; the
    API server refuses to call plaintext webhooks)."""

    def __init__(self, host: str = "0.0.0.0", port: int = 8080,
                 ready_check: Callable[[], bool] | None = None,
                 tls_cert: str = "", tls_key: str = "",
                 statusz: Callable[[], dict] | None = None,
                 whatif=None):
        self._ready = ready_check or (lambda: True)
        # operator-supplied /statusz extras (backend, leader, breakers,
        # last solve); the server owns uptime + version
        self._statusz_extra = statusz
        # whatif PlanningService (karpenter_tpu_torch/whatif) — /debug/whatif
        # is 503 while the plane is off
        self._whatif = whatif
        self._started_at = time.time()
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (stdlib API)
                if self.path == "/metrics":
                    # content negotiation: an OpenMetrics scraper gets
                    # the exemplar-bearing exposition (trace_id
                    # exemplars on solve_phase / pod_placement /
                    # device_time buckets link into /debug/traces);
                    # the plain text render is unchanged
                    if "application/openmetrics-text" in \
                            (self.headers.get("Accept") or ""):
                        self._reply(
                            200, metrics.render_openmetrics().encode(),
                            "application/openmetrics-text; version=1.0.0; "
                            "charset=utf-8")
                    else:
                        self._reply(
                            200, metrics.render().encode(),
                            "text/plain; version=0.0.4; charset=utf-8")
                elif self.path.split("?", 1)[0] == "/debug/profile":
                    # single-flight + duration-capped: distinct status
                    # codes (429 busy), so it can't ride _json_endpoint
                    try:
                        code, payload = outer._debug_profile(self.path)
                    except Exception as e:  # noqa: BLE001 — debug surface
                        code, payload = 500, {"error": str(e)[:200]}
                    self._reply(code,
                                json.dumps(payload, default=str).encode(),
                                "application/json")
                elif self.path.split("?", 1)[0] == "/debug/traces":
                    self._json_endpoint(
                        lambda: outer._debug_traces(self.path))
                elif self.path.split("?", 1)[0] == "/debug/slo":
                    self._json_endpoint(outer._debug_slo)
                elif self.path.split("?", 1)[0] == "/debug/explain":
                    self._json_endpoint(
                        lambda: outer._debug_explain(self.path))
                elif self.path.split("?", 1)[0] == "/debug/risk":
                    self._json_endpoint(outer._debug_risk)
                elif self.path.split("?", 1)[0] == "/debug/telemetry":
                    self._json_endpoint(outer._debug_telemetry)
                elif self.path.split("?", 1)[0] == "/debug/whatif":
                    # single-flight (429 when a stacked evaluation is
                    # already in flight) — distinct status codes, so it
                    # can't ride _json_endpoint, same as /debug/profile
                    try:
                        code, payload = outer._debug_whatif(self.path)
                    except Exception as e:  # noqa: BLE001 — debug surface
                        # the error's type leads: on the card a faulted
                        # plan raises DeviceFaultError out of evaluate
                        code, payload = 500, {
                            "error": f"{type(e).__name__}: {e}"[:200]}
                    self._reply(code,
                                json.dumps(payload, default=str).encode(),
                                "application/json")
                elif self.path.split("?", 1)[0] == "/statusz":
                    self._json_endpoint(outer._statusz)
                elif self.path == "/healthz":
                    from karpenter_tpu_torch.version import get_version

                    self._reply(200, b'{"status":"ok","version":"'
                                + get_version().encode() + b'"}',
                                "application/json")
                elif self.path == "/readyz":
                    if outer._ready():
                        self._reply(200, b"ready", "text/plain")
                    else:
                        self._reply(503, b"not ready", "text/plain")
                else:
                    self._reply(404, b"not found", "text/plain")

            def do_POST(self):  # noqa: N802 (stdlib API)
                if self.path != "/validate-nodeclass":
                    self._reply(404, b"not found", "text/plain")
                    return
                length = int(self.headers.get("Content-Length") or 0)
                try:
                    body = json.loads(self.rfile.read(length)) if length \
                        else {}
                except json.JSONDecodeError:
                    self._reply(400, b'{"error": "invalid JSON"}',
                                "application/json")
                    return
                try:
                    out = json.dumps(_admission_response(body)).encode()
                except Exception as e:  # noqa: BLE001 — never drop the socket
                    out = json.dumps({"allowed": False,
                                      "errors": [f"webhook error: {e}"]}
                                     ).encode()
                self._reply(200, out, "application/json")

            def _json_endpoint(self, fn) -> None:
                """Debug-surface contract: 200 + JSON payload, or 500 +
                ``{"error"}`` — never an exception through the stdlib
                handler (which would drop the socket)."""
                try:
                    body = json.dumps(fn(), default=str).encode()
                    self._reply(200, body, "application/json")
                except Exception as e:  # noqa: BLE001 — debug surface
                    self._reply(500, json.dumps(
                        {"error": str(e)[:200]}).encode(),
                        "application/json")

            def _reply(self, status: int, body: bytes, ctype: str):
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt, *args):  # quiet the stdlib logger
                pass

        self.tls = bool(tls_cert and tls_key)
        if self.tls:
            import ssl

            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(certfile=tls_cert, keyfile=tls_key)

            class TLSServer(ThreadingHTTPServer):
                """TLS wrapped PER CONNECTION in the handler thread, with
                a socket timeout — wrapping the listener would run the
                handshake inside accept() on the serve_forever thread,
                letting one stalled client (port scan, plain-HTTP probe)
                block every subsequent admission call."""

                def finish_request(self, request, client_address):
                    request.settimeout(10.0)
                    try:
                        request = ctx.wrap_socket(request, server_side=True)
                    except Exception:  # noqa: BLE001 — bad handshake, drop
                        self.shutdown_request(request)
                        return
                    super().finish_request(request, client_address)

            self._server = TLSServer((host, port), Handler)
        else:
            self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: threading.Thread | None = None

    # -- debug endpoints ----------------------------------------------------

    def _debug_traces(self, path: str) -> dict:
        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.obs.export import debug_traces

        q = parse_qs(urlparse(path).query)

        def one(key, default, cast):
            try:
                return cast(q[key][0]) if key in q and q[key] else default
            except (TypeError, ValueError):
                return default

        return debug_traces(
            obs.get_recorder(),
            status=one("status", None, str),
            min_duration_ms=one("min_ms", 0.0, float),
            limit=one("limit", 50, int),
            trace_id=one("trace_id", None, int))

    def _debug_explain(self, path: str) -> dict:
        """Per-pod placement explainability (karpenter_tpu_torch/explain):
        canonical reason, raw elimination bits, the nearest-miss
        offering ("would fit if +2 CPU"), and the trace id of the window
        that decided — plus a reason-count summary.  ``?pod=ns/name``
        narrows to one pod; ``?limit=`` bounds the table."""
        from karpenter_tpu_torch.explain import get_registry

        q = parse_qs(urlparse(path).query)
        registry = get_registry()
        pod = q["pod"][0] if q.get("pod") else ""
        if pod:
            entry = registry.get(pod)
            return {"pods": [entry.to_dict()] if entry else [],
                    "summary": registry.summary()}
        try:
            limit = int(q["limit"][0]) if q.get("limit") else 100
        except (TypeError, ValueError):
            limit = 100
        return {
            "pods": [e.to_dict() for e in registry.entries(limit)],
            "summary": registry.summary(),
            "stamped_total": registry.stamped_total,
        }

    def _debug_risk(self) -> dict:
        """Spot-risk model surface (karpenter_tpu_torch/stochastic/risk.py):
        the per-(type, zone) interruption rates the solver prices,
        refreshed from the ledger's labeled lifecycle history at read
        time, plus the raw history itself — so an operator can see
        both what was observed and what is being priced."""
        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.stochastic.risk import refresh_from_ledger

        model = refresh_from_ledger(obs.get_ledger())
        hist = obs.get_ledger().interruption_history()
        return {
            "model": model.snapshot(),
            "history": {
                "interrupted": {f"{t}/{z}": n for (t, z), n
                                in sorted(hist["interrupted"].items())},
                "exposure": {f"{t}/{z}": n for (t, z), n
                             in sorted(hist["exposure"].items())},
            },
        }

    def _debug_telemetry(self) -> dict:
        """Device telemetry words (karpenter_tpu_torch/obs/telemetry_words,
        docs/design/observability.md): the slot registry, per-plane
        aggregates over the recorder's bounded telemetry ring, and the
        raw retained window entries — what the solver itself measured
        about every recent window, no host recomputation."""
        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.obs import telemetry_words

        payload = telemetry_words.summary()
        payload["ring"] = obs.get_recorder().telemetry()
        return payload

    def _debug_whatif(self, path: str) -> tuple[int, dict]:
        """On-demand what-if evaluation (karpenter_tpu_torch/whatif,
        docs/design/whatif.md): ``?horizon=`` overrides the planning
        horizon (virtual hours), ``?scenarios=a,b`` narrows the
        standing menu by name.  SINGLE-FLIGHT: a concurrent evaluation
        returns 429, never a double-launched stacked dispatch.  Also
        returns the bounded recommendation audit registry."""
        if self._whatif is None:
            return 503, {"error": "whatif plane disabled "
                                  "(KARPENTER_ENABLE_WHATIF)"}
        q = parse_qs(urlparse(path).query)

        def one(key, default, cast):
            try:
                return cast(q[key][0]) if key in q and q[key] else default
            except (TypeError, ValueError):
                return default

        horizon = one("horizon", None, int)
        names_raw = one("scenarios", "", str)
        names = [n for n in names_raw.split(",") if n] or None
        payload = self._whatif.evaluate(horizon_hours=horizon,
                                        scenario_names=names)
        if payload is None:
            return 429, {"error": "a whatif evaluation is already in "
                                  "flight (single-flight)"}
        if payload.get("error"):
            # a plane that cannot resolve its inputs is unavailable,
            # not healthy-with-an-error-field
            return 503, payload
        payload["registry"] = self._whatif.recommendations(32)
        return 200, payload

    def _debug_profile(self, path: str) -> tuple[int, dict]:
        """On-demand device-time capture (docs/design/profiling.md):
        force-samples every dispatch for ``?duration_s=`` (clamped to
        the profiler's cap), then returns the per-dispatch
        dispatch/execute/fetch decomposition, a per-kernel summary, and
        a Perfetto-loadable Chrome trace built through the existing
        export path.  Single-flight: a second concurrent capture gets
        429, never a second window."""
        from karpenter_tpu_torch.obs.export import dicts_to_chrome
        from karpenter_tpu_torch.obs.prof import (
            aggregate_samples, clamp_capture_duration, get_profiler,
            samples_to_span_dicts,
        )

        q = parse_qs(urlparse(path).query)
        raw = q["duration_s"][0] if q.get("duration_s") else 1.0
        duration_s = clamp_capture_duration(raw)
        prof = get_profiler()
        samples = prof.capture(duration_s)
        if samples is None:
            return 429, {"error": "a profile capture is already in "
                                  "flight (single-flight)"}
        return 200, {
            "duration_s": duration_s,
            "sample_count": len(samples),
            "samples": samples[:256],
            "device_time": aggregate_samples(samples),
            "profiler": prof.snapshot(),
            "chrome": dicts_to_chrome(samples_to_span_dicts(samples)),
        }

    def _debug_slo(self) -> dict:
        """Live SLO evaluation over the placement ledger: burn state per
        default SLO, the worst-case pod table (trace ids link into
        /debug/traces), and the device-telemetry snapshot
        (docs/design/observability.md)."""
        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.obs.slo import debug_slo_payload

        return debug_slo_payload(obs.get_ledger(),
                                 recorder=obs.get_recorder())

    def _statusz(self) -> dict:
        from karpenter_tpu_torch import obs
        from karpenter_tpu_torch.faulttol import get_health_board
        from karpenter_tpu_torch.obs.devtel import get_devtel
        from karpenter_tpu_torch.obs.prof import get_profiler
        from karpenter_tpu_torch.obs.watchdog import get_watchdog
        from karpenter_tpu_torch.version import get_version

        from karpenter_tpu_torch.explain import get_registry
        from karpenter_tpu_torch.stochastic.risk import get_risk_model

        ledger = obs.get_ledger()
        out = {
            "uptime_s": round(time.time() - self._started_at, 3),
            "version": get_version(),
            "ready": bool(self._ready()),
            "recorder": obs.get_recorder().stats(),
            "last_solve_phases_ms": obs.last_solve_breakdown(),
            "ledger": ledger.stats(),
            "pending_staleness_s": round(ledger.pending_staleness(), 6),
            "device_telemetry": get_devtel().snapshot(),
            # per-plane solver-quality aggregates from the device
            # telemetry words (/debug/telemetry has the raw ring)
            "solve_quality": _telemetry_summary(),
            "unplaced_reasons": get_registry().summary(),
            # device-profiling plane (docs/design/profiling.md): the
            # per-kernel dispatch/execute/fetch split, the profiler's
            # own overhead fraction (<1% gate), and watchdog state
            "profiler": get_profiler().snapshot(),
            "watchdog": get_watchdog().snapshot(),
            # spot-risk block (stochastic/risk.py): what the solver
            # currently prices per (type, zone) — /debug/risk has the
            # full history
            "risk": get_risk_model().snapshot(),
            # device-fault plane (docs/design/faulttol.md): per-device
            # health states, per-kernel dispatch deadlines, and the
            # guard's healthy-path overhead fraction (<1% gate)
            "device_health": get_health_board().snapshot(),
            # affinity plane (docs/design/affinity.md): the last encoded
            # window's armed edge/component census and the running tally
            # of spread-bound clamps at the decode choke point
            "affinity": {
                "edges": int(metrics.AFFINITY_EDGES.get()),
                "components": int(metrics.AFFINITY_COMPONENTS.get()),
                "spread_violations_avoided":
                    int(metrics.AFFINITY_SPREAD_AVOIDED.get()),
            },
            # serving loop (docs/design/serving.md): per-route window
            # tally, live ring occupancy, and the double-buffer overlap
            # fraction (0 = fully serialized single-shot behavior)
            "serving": {
                "windows": {mode: int(metrics.SERVING_WINDOWS
                                      .labels(mode).get())
                            for mode in ("hit", "delta", "rebuild",
                                         "classic", "backpressure",
                                         "host_failover")},
                "ring_occupancy": int(metrics.SERVING_RING_OCCUPANCY.get()),
                "backpressure_total":
                    int(metrics.SERVING_BACKPRESSURE.get()),
                "overlap_fraction":
                    round(float(metrics.SERVING_OVERLAP.get()), 4),
            },
        }
        if self._statusz_extra is not None:
            out.update(self._statusz_extra())
        return out

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="metrics-server", daemon=True)
        self._thread.start()
        log.info("metrics server listening", port=self.port)
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=2)
