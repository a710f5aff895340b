"""Trace export: JSONL span dumps + Chrome trace-event JSON (Perfetto).
(Copy of ``karpenter_tpu/obs/export.py``.)

Two wire formats:

- **JSONL** — one span per line, times as microsecond offsets from the
  recorder's anchor.  This is the chaos violation artifact and the
  ``/debug/traces`` payload's building block: grep-able, diff-able, and
  structurally deterministic for seeded chaos runs.
- **Chrome trace events** — ``{"traceEvents": [...]}`` with complete
  ("X") events per span and instant ("i") events for span events and
  loose instants.  Loads directly in Perfetto / chrome://tracing; each
  trace gets its own tid row so concurrent provisioning cycles stack
  instead of interleaving.
"""

from __future__ import annotations

import json
from pathlib import Path

from karpenter_tpu_torch.obs.trace import FlightRecorder, Span


def _us(t: float, anchor: float) -> float:
    return round((t - anchor) * 1e6, 1)


def span_to_dict(span: Span, anchor: float) -> dict:
    d = {
        "trace_id": span.trace_id,
        "span_id": span.span_id,
        "parent_id": span.parent_id,
        "name": span.name,
        "start_us": _us(span.start, anchor),
        "dur_us": round(span.duration_s * 1e6, 1),
        "status": span.status,
    }
    if span.error:
        d["error"] = span.error
    if span.attrs:
        d["attrs"] = {k: v if isinstance(v, (int, float, bool, str))
                      else str(v) for k, v in span.attrs.items()}
    if span.events:
        d["events"] = [{**e, "t": _us(e["t"], anchor)} for e in span.events]
    return d


def recorder_to_dicts(recorder: FlightRecorder) -> list[dict]:
    """Every retained span (traces newest-first, then loose instants) as
    JSON-safe dicts with anchor-relative times."""
    anchor = recorder.anchor_monotonic
    out: list[dict] = []
    for trace_id, status, _root, spans in recorder.traces():
        for sp in spans:
            d = span_to_dict(sp, anchor)
            d["trace_status"] = status
            out.append(d)
    for sp in recorder.instants():
        d = span_to_dict(sp, anchor)
        d["instant"] = True
        out.append(d)
    return out


def dump_jsonl(span_dicts: list[dict], path) -> Path:
    p = Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    with p.open("w") as f:
        for d in span_dicts:
            f.write(json.dumps(d, sort_keys=True, default=str) + "\n")
    return p


def load_jsonl(path) -> list[dict]:
    out = []
    for line in Path(path).read_text().splitlines():
        line = line.strip()
        if line:
            out.append(json.loads(line))
    return out


def dicts_to_chrome(span_dicts: list[dict]) -> dict:
    """Span dicts -> Chrome trace-event JSON (Perfetto-loadable)."""
    events = []
    tids: dict = {}
    for d in span_dicts:
        tid = tids.setdefault(d["trace_id"], len(tids) + 1)
        args = dict(d.get("attrs") or {})
        if d.get("error"):
            args["error"] = d["error"]
        args["status"] = d.get("status", "ok")
        if d.get("instant") or d["dur_us"] == 0:
            events.append({"name": d["name"], "ph": "i", "s": "t",
                           "ts": d["start_us"], "pid": 1, "tid": tid,
                           "cat": "karpenter_tpu", "args": args})
            continue
        events.append({"name": d["name"], "ph": "X", "ts": d["start_us"],
                       "dur": d["dur_us"], "pid": 1, "tid": tid,
                       "cat": "karpenter_tpu", "args": args})
        for ev in d.get("events") or []:
            events.append({"name": f'{d["name"]}:{ev.get("name", "event")}',
                           "ph": "i", "s": "t", "ts": ev["t"], "pid": 1,
                           "tid": tid, "cat": "karpenter_tpu",
                           "args": {k: v for k, v in ev.items()
                                    if k not in ("name", "t")}})
    events.append({"name": "process_name", "ph": "M", "pid": 1,
                   "args": {"name": "karpenter-tpu"}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def to_chrome(recorder: FlightRecorder) -> dict:
    return dicts_to_chrome(recorder_to_dicts(recorder))


def debug_traces(recorder: FlightRecorder, *, status: str | None = None,
                 min_duration_ms: float = 0.0, limit: int = 50,
                 trace_id: int | None = None) -> dict:
    """The ``/debug/traces`` payload: newest-first trace summaries with
    their spans, filterable by status and minimum root duration.
    ``trace_id`` is an exact lookup — the direct fetch for the trace ids
    the ledger's worst-K table and ``/debug/slo`` print (other filters
    are ignored for a pinpoint fetch)."""
    anchor = recorder.anchor_monotonic
    wall0 = recorder.anchor_wall
    traces = []
    for tid, tstatus, root, spans in recorder.traces():
        if trace_id is not None:
            if tid != trace_id:
                continue
        elif status and tstatus != status:
            continue
        dur_ms = root.duration_s * 1000.0
        if trace_id is None and dur_ms < min_duration_ms:
            continue
        traces.append({
            "trace_id": tid,
            "root": root.name,
            "status": tstatus,
            "start_unix": round(wall0 + (root.start - anchor), 6),
            "duration_ms": round(dur_ms, 3),
            "spans": [span_to_dict(s, anchor) for s in spans],
        })
        if len(traces) >= max(1, limit):
            break
    return {"traces": traces, "recorder": recorder.stats()}
