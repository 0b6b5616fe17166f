"""End-to-end driver at the paper's scale: co-located QA+RG+CG workloads
on a 4-instance shared-LLM fleet, comparing Kairos against Parrot and Ayo
with the production scheduling/dispatching code (paper §7.3), on the
discrete-event simulator.  It runs on the CPU and touches no device.

    PYTHONPATH=src python -m repro_torch.cluster_sim --rate 2.8
"""
import argparse
import sys

from repro_torch.sim import colocated_apps, run_policy


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--rate", type=float, default=2.8)
    ap.add_argument("--duration", type=float, default=150.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args(argv)

    apps = colocated_apps()
    print(f"co-located workload: {[a.name for a in apps]} @ {args.rate} wf/s\n")
    print(f"{'policy':14s} {'avg':>9s} {'p90':>9s} {'p95':>9s} {'p99':>9s} "
          f"{'preempt':>8s} {'queue%':>7s}")
    summaries = {}
    for pol in ("parrot", "ayo", "kairos", "w/o-priority", "w/o-packing"):
        r = run_policy(apps, pol, rate=args.rate, duration=args.duration,
                       seed=args.seed)
        s = r.summary()
        summaries[pol] = s
        print(f"{pol:14s} {s['avg']*1e3:8.1f}ms {s['p90']*1e3:8.1f}ms "
              f"{s['p95']*1e3:8.1f}ms {s['p99']*1e3:8.1f}ms "
              f"{int(s['preempted']):8d} {s['queueing_ratio']*100:6.1f}%")

    k, p, a = (summaries[x]["avg"] for x in ("kairos", "parrot", "ayo"))
    print(f"\nKairos vs Parrot: {(p-k)/p*100:+.1f}% avg "
          f"(paper co-located: -45.1%..-72.8%)")
    print(f"Kairos vs Ayo:    {(a-k)/a*100:+.1f}% avg (paper: -6.1%..-37.9%)")
    ok = k < p and k < a * 1.05
    print("\nCLUSTER-SIM", "OK" if ok else "UNEXPECTED ORDERING")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
