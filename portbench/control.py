"""The readings that set the limits on the gap numbers, on the card.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 \\
        --seconds 15 [--precision float8_e4m3fn]

For each seed, one run of the cell at its own load (a short window,
traced off, no check of its own) and then, on the sample a benchmark run
compares and at its served positions, the reference's gap of every
served token (the program's reading) and of the token the reference
computed in the lower precision puts first (the control's reading).
Both go through ``check.verdict`` with the cell's limits: the program's
must come out correct, the control's not.  The control is the step below
the configuration's dtype: fp8 (e4m3) for bfloat16, bfloat16 for
float32.  Prints one JSON line per seed and one summary line.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT / "src", ROOT):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

LOWER = {"bfloat16": "float8_e4m3fn", "float32": "bfloat16"}


def readings(cell, seed: int, seconds: float, device,
             precision=None) -> dict:
    import torch
    from portbench import check, measure
    from portbench.harness import run_cell
    from portbench.weights import make_weights
    res = run_cell(cell, seed, seconds, False, device, time.monotonic(),
                   run_check=False)
    chk = cell.config["check"]
    calls = [c for c in res.calls if measure.inside(c.t_finish, res.window)]
    picked = check.sample(calls, seed, chk["min_tokens"], chk["max_calls"])
    weights = make_weights(res.arch, seed, device)
    t0 = time.monotonic()
    g = check.control_gaps(weights, res.arch, picked, device,
                           precision or LOWER[res.arch.dtype])
    ref_s = time.monotonic() - t0
    del weights
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    limits = {k: float(v) for k, v in chk["limits"].items()}
    program = check.verdict(res.accounting, g["served"], limits,
                            int(chk["min_tokens"]))
    control = check.verdict(check.NO_FAULT, g["control"], limits,
                            int(chk["min_tokens"]))
    return {"seed": seed, "calls": len(picked),
            "tokens": int(g["served"].size),
            "program_gap": float(g["served"].max()),
            "control_gap": float(g["control"].max()),
            "program_mean_gap": float(g["served"].mean()),
            "control_mean_gap": float(g["control"].mean()),
            "control_flips": int((g["control"] > 0).sum()),
            "program_flips": int((g["served"] > 0).sum()),
            "program_correct": program.correct,
            "control_correct": control.correct,
            "control_compared": control.compared,
            "reference_s": ref_s, "workflows": res.end_to_end["workflows"],
            "drain_s": res.drain_s}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=15.0)
    ap.add_argument("--precision", default=None)
    args = ap.parse_args(argv)
    import torch
    from portbench import manifest
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload, manifest.load_manifest())
    rows = []
    for seed in args.seeds:
        r = readings(cell, seed, args.seconds, torch.device("cuda", 0),
                     args.precision)
        rows.append(r)
        print(json.dumps(r), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({
        "workload": cell.name,
        "program_gap_max": max(r["program_gap"] for r in rows),
        "control_gap_min": min(r["control_gap"] for r in rows),
        "program_mean_gap_max": max(r["program_mean_gap"] for r in rows),
        "control_mean_gap_min": min(r["control_mean_gap"] for r in rows),
        "program_correct": all(r["program_correct"] for r in rows),
        "control_correct_any": any(r["control_correct"] for r in rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
