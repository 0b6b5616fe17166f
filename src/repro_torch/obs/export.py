"""Trace exporters: Chrome/Perfetto ``trace_event`` JSON + plain dicts.

``to_chrome_trace`` turns a tracer's event stream into the Trace Event
Format both ``chrome://tracing`` and https://ui.perfetto.dev consume:
one *process* per instance (pid = instance_id, control plane = pid 0 via
offset), one *thread* per request (tid = req_id) so a cluster drain
renders as per-engine tracks with per-request span rows.  Lifecycle
phases become "X" complete events (queued / prefill / decode), one-shot
kinds (preempt, evict, oom-fence, migrate-candidate, iteration) become
"i" instants.  Timestamps are microseconds, rebased to the earliest
event so traces start at t=0.

``events_to_dicts`` / ``events_from_dicts`` are the loss-free plain-dict
round-trip (the sim and tests use it); ``validate_chrome_trace`` is the
schema check the export test and CI artifact step run.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List

from repro_torch.obs.trace import EVENT_KINDS, Event

# kinds rendered as instant markers rather than span edges
_INSTANT_KINDS = ("preempt", "evict", "oom-fence", "migrate-candidate",
                  "iteration", "dispatch", "prefill-chunk", "decode")

# chrome://tracing rejects pid/tid < 0; shift so control plane (-1) = 0
_PID_OFF = 1


def _us(ts: float, t0: float) -> float:
    return (ts - t0) * 1e6


def to_chrome_trace(events: Iterable[Event], *, dropped: int = 0) -> dict:
    """Build a Trace Event Format dict (``{"traceEvents": [...]}``).

    Span construction per request: ``submit -> admit`` renders as a
    ``queued`` X-event on the submitting track; ``admit -> first-token``
    as ``prefill`` and ``first-token -> finish`` as ``decode`` on the
    executing instance's track (``admit -> finish`` collapses to one
    ``exec`` span when no first-token event was captured).  Requests
    still in flight at capture time get no span (no fabricated ends).
    """
    events = sorted(events, key=lambda e: e.ts)
    if not events:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    t0 = events[0].ts
    out: List[dict] = []
    pids_named: Dict[int, bool] = {}
    tids_named: Dict[tuple, bool] = {}

    def meta(pid: int, tid: int, agent: str, req_id: int):
        if pid not in pids_named:
            pids_named[pid] = True
            name = "control-plane" if pid == 0 else f"engine{pid - _PID_OFF}"
            out.append({"name": "process_name", "ph": "M", "pid": pid,
                        "args": {"name": name}})
        if (pid, tid) not in tids_named:
            tids_named[(pid, tid)] = True
            label = f"req{req_id}" + (f" [{agent}]" if agent else "")
            out.append({"name": "thread_name", "ph": "M", "pid": pid,
                        "tid": tid, "args": {"name": label}})

    def span(name: str, pid: int, tid: int, ts: float, dur: float,
             agent: str, req_id: int, args: dict):
        meta(pid, tid, agent, req_id)
        out.append({"name": name, "ph": "X", "pid": pid, "tid": tid,
                    "ts": _us(ts, t0), "dur": max(dur, 0.0) * 1e6,
                    "cat": "request", "args": args})

    # per-request lifecycle anchors
    sub: Dict[int, Event] = {}
    adm: Dict[int, Event] = {}
    ft: Dict[int, Event] = {}
    for e in events:
        if e.req_id < 0:
            continue
        if e.kind == "submit":
            sub.setdefault(e.req_id, e)
        elif e.kind == "admit":
            adm.setdefault(e.req_id, e)
        elif e.kind == "first-token":
            ft[e.req_id] = e
        elif e.kind == "finish":
            s, a = sub.get(e.req_id), adm.get(e.req_id)
            pid = e.instance_id + _PID_OFF
            args = {"msg_id": e.msg_id, **{k: v for k, v in e.data.items()
                                           if isinstance(v, (int, float, str))}}
            if s is not None:
                qend = a.ts if a is not None else e.ts
                span("queued", s.instance_id + _PID_OFF, e.req_id,
                     s.ts, qend - s.ts, e.agent or s.agent, e.req_id,
                     {"msg_id": s.msg_id})
            if a is not None:
                f = ft.get(e.req_id)
                if f is not None and a.ts <= f.ts <= e.ts:
                    span("prefill", pid, e.req_id, a.ts, f.ts - a.ts,
                         e.agent, e.req_id, {"cached": a.data.get("cached", 0)})
                    span("decode", pid, e.req_id, f.ts, e.ts - f.ts,
                         e.agent, e.req_id, args)
                else:
                    span("exec", pid, e.req_id, a.ts, e.ts - a.ts,
                         e.agent, e.req_id, args)
            ft.pop(e.req_id, None)

    # instants (markers) — rendered where they happened
    for e in events:
        if e.kind not in _INSTANT_KINDS:
            continue
        pid = e.instance_id + _PID_OFF
        tid = e.req_id if e.req_id >= 0 else 0
        meta(pid, tid, e.agent, e.req_id)
        out.append({"name": e.kind, "ph": "i", "pid": pid, "tid": tid,
                    "ts": _us(e.ts, t0), "s": "t", "cat": "marker",
                    "args": {k: v for k, v in e.data.items()
                             if isinstance(v, (int, float, str))}})

    trace = {"traceEvents": out, "displayTimeUnit": "ms"}
    if dropped:
        trace["otherData"] = {"dropped_events": dropped}
    return trace


def write_chrome_trace(path: str, events: Iterable[Event], *,
                       dropped: int = 0) -> dict:
    trace = to_chrome_trace(events, dropped=dropped)
    with open(path, "w") as f:
        json.dump(trace, f)
    return trace


def validate_chrome_trace(trace: dict) -> List[str]:
    """Schema check; returns a list of problems (empty = valid)."""
    errs: List[str] = []
    evs = trace.get("traceEvents")
    if not isinstance(evs, list):
        return ["traceEvents missing or not a list"]
    for i, e in enumerate(evs):
        ph = e.get("ph")
        if ph not in ("X", "i", "M"):
            errs.append(f"[{i}] bad ph {ph!r}")
            continue
        if not isinstance(e.get("pid"), int) or e["pid"] < 0:
            errs.append(f"[{i}] bad pid {e.get('pid')!r}")
        if ph == "M":
            if not e.get("args", {}).get("name"):
                errs.append(f"[{i}] metadata without args.name")
            continue
        if not isinstance(e.get("ts"), (int, float)) or e["ts"] < 0:
            errs.append(f"[{i}] bad ts {e.get('ts')!r}")
        if ph == "X" and (not isinstance(e.get("dur"), (int, float))
                          or e["dur"] < 0):
            errs.append(f"[{i}] X event with bad dur {e.get('dur')!r}")
        if not e.get("name"):
            errs.append(f"[{i}] unnamed event")
    return errs


# --------------------------------------------------------------- plain dicts
def events_to_dicts(events: Iterable[Event]) -> List[dict]:
    return [e._asdict() for e in events]


def events_from_dicts(dicts: Iterable[dict]) -> List[Event]:
    out = []
    for d in dicts:
        assert d["kind"] in EVENT_KINDS, f"unknown event kind {d['kind']!r}"
        out.append(Event(**d))
    return out
