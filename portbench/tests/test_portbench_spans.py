"""The per-layer metrics read from the program's own spans: a traced run
of the tiny cell reads every one, the in-program dispatch time lies
inside the harness's, and a program without spans reads none."""
import dataclasses
import time

import pytest
import torch

from portbench import manifest, report
from portbench.harness import run_cell
from portbench.tests.tiny import SEED, tiny_cell

SPAN_METRICS = ("dispatch_span_ms", "dispatch_offcpu_share",
                "launch_host_ms", "plan_host_ms", "tick_host_ms")
CELL = "qwen3-1.7b.qa-sessions"


@pytest.fixture(scope="module")
def traced():
    cell = tiny_cell(CELL)
    torch.manual_seed(0)
    res = run_cell(cell, SEED, 2.5, True, "cpu", time.monotonic(),
                   check_registry=False, drain_s=20.0)
    readers = {m["name"]: (m, manifest.reader(m)) for m in cell.per_layer}
    return cell, res, readers


def test_span_metrics_read_in_a_traced_run(traced):
    cell, res, readers = traced
    assert set(SPAN_METRICS) <= set(readers)
    args = type("A", (), {"trace": 1, "seed": SEED, "seconds": 2.5})
    _, line = report.build(cell, args, res, list(readers.values()), "cpu",
                           "n/a")
    assert line["correct"]
    got = {m: line["metrics"][m]["value"] for m in SPAN_METRICS}
    assert all(v > 0 for k, v in got.items() if k != "dispatch_offcpu_share")
    assert 0.0 <= got["dispatch_offcpu_share"] <= 100.0
    # the span is inside the harness's wrapper of the same calls
    assert got["dispatch_span_ms"] <= line["metrics"]["dispatch_host_ms"][
        "value"]


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_span_metrics_read_nothing_without_spans(traced, name):
    """A program that records no spans (the parent of this benchmark's
    span metrics) gives no number, and no error."""
    _, res, readers = traced
    events = [e for e in res.events if e.kind != "span"]
    assert events
    assert readers[name][1].read(dataclasses.replace(res, events=events)) \
        is None
