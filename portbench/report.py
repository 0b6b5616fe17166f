"""The result line of a run, and the line of details before it."""
from __future__ import annotations

from portbench import measure, profiling


def build(cell, args, res, readers, kind: str, power_limit: str):
    rec = res.recorder
    e2e = dict(res.end_to_end, setup_s=res.setup_s)
    wf_in = e2e.pop("workflows")
    calls_in = e2e.pop("calls")
    ok = res.verdict.correct if res.verdict is not None else False
    metrics, missing = {}, []
    if args.trace:
        for m, mod in readers:
            v = mod.read(res)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            v = e2e.get(m["name"])
            if v is None:
                missing.append(m["name"])
            else:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": kind, "count": cell.chips,
              "memory_peak_bytes": int(res.memory_peak_bytes)}
    result = {"correct": bool(ok and not missing),
              "attempted": wf_in + res.failed, "failed": res.failed,
              "metrics": metrics, "device": device}
    if args.trace and rec.profile is not None:
        device["busy_s"] = rec.profile["busy_s"]
        device["window_s"] = rec.profile["window_s"]
        result["breakdown"] = profiling.breakdown(rec.profile)
    compared = dict(res.verdict.compared) if res.verdict is not None else {}
    compared["workflows_in_window"] = {"value": wf_in, "limit": 1}
    if missing:
        compared["missing_metrics"] = {"value": len(missing), "limit": 0}
        result["correct"] = False
    if wf_in < 1:
        result["correct"] = False
    result["compared"] = compared
    opened, closed = rec.at_open, rec.at_close
    details = {"portbench": {
        "cell": cell.name, "seed": args.seed, "seconds": args.seconds,
        "trace": args.trace, "card": kind, "power_limit": power_limit,
        "setup_s": res.setup_s, "window_s": res.window[1] - res.window[0],
        "drain_s": res.drain_s, "accounting": res.accounting,
        "end_to_end": e2e, "workflows_in_window": wf_in,
        "calls_in_window": calls_in, "workflows_submitted": res.submitted,
        "counters_in_window": {k: closed[k] - opened[k] for k in closed},
        "prompt_tokens_in_window_calls": int(sum(
            len(c.prompt) for c in res.calls
            if measure.inside(c.t_finish, res.window))),
        "iterations_in_window": _iteration_means(rec.iterations, res.window),
        "tracer_events": len(res.events),
        "gaps": res.verdict.gaps if res.verdict is not None else {},
        "missing": missing, "smi": res.smi}}
    return details, result


def _iteration_means(iterations, window) -> dict:
    """Traced runs: iterations in the window and what an average one
    computed (decode rows, their mean context, prefill chunk tokens)."""
    its = [it for it in iterations if measure.inside(it.t, window)]
    if not its:
        return {"count": 0}
    rows = sum(len(it.decode_ctx) for it in its)
    return {"count": len(its), "decode_rows": rows / len(its),
            "decode_context": sum(sum(it.decode_ctx) for it in its)
            / max(rows, 1),
            "prefill_tokens": sum(e - s for it in its for s, e in it.chunks)
            / len(its)}
