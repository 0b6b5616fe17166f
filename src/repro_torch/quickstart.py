"""Quickstart (paper Listing 1): a Question-Answer multi-agent app served
by Kairos over the port's paged-KV engine, on the CUDA card by default.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

Without ``--device`` it runs on the card and fails when there is none.
"""
import argparse
import sys

from repro_torch.agents import BaseAgent, Workflow
from repro_torch.serving import ServingConfig

# Each agent's fixed preamble is declared as a ``system_prompt``: with
# ``prefix_caching=True`` its KV is computed once per instance and shared
# across every call (see src/repro/serving/prefix_cache.py).
ROUTER_SYS = "You're a router assistant. Classify the incoming question into math or humanities."
MATH_SYS = "You're a math expert. Solve the problem step by step, showing your work."
HUM_SYS = "You're a humanities expert. Answer with historical and cultural context."


class Router(BaseAgent):
    system_prompt = ROUTER_SYS

    def _run_impl(self, input_data, metadata):
        q = input_data["question"]
        prompt = self.encode_prompt(q, length=12)
        result = self.generate(prompt, metadata, max_new_tokens=2)
        # route by content (synthetic: parity of the first generated token)
        next_agent = "MathAgent" if (result and result[0] % 2 == 0) else "HumanitiesAgent"
        return {"question": q}, next_agent


class MathAgent(BaseAgent):
    system_prompt = MATH_SYS

    def _run_impl(self, input_data, metadata):
        prompt = self.encode_prompt(input_data["question"], length=20)
        result = self.generate(prompt, metadata, max_new_tokens=10)
        return {"answer": result, "by": self.name}, None


class HumanitiesAgent(BaseAgent):
    system_prompt = HUM_SYS

    def _run_impl(self, input_data, metadata):
        prompt = self.encode_prompt(input_data["question"], length=28)
        result = self.generate(prompt, metadata, max_new_tokens=16)
        return {"answer": result, "by": self.name}, None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    # prefix_caching: shared-prefix KV reuse across agent calls (the knob
    # also teaches the dispatcher's memory ramps about the discount)
    wf = Workflow(app_name="QA", config=ServingConfig(
        n_instances=1, num_blocks=128, block_size=8, max_batch=4,
        prefix_caching=True), device=args.device)
    wf.add_engine("vllm-0", model="qwen3-1.7b")           # reduced variant
    wf.add_agent("Router", Router, use_model="qwen3-1.7b")
    wf.add_agent("MathAgent", MathAgent, use_model="qwen3-1.7b")
    wf.add_agent("HumanitiesAgent", HumanitiesAgent, use_model="qwen3-1.7b")

    questions = [f"question number {i}: what is {i}*{i+1}?" for i in range(6)]
    ids = [wf.submit_task("Router", {"question": q}) for q in questions]
    results = wf.run(timeout=180)

    print(f"\ncompleted {len(results)}/{len(ids)} workflows")
    for mid in ids:
        r = results.get(mid, {})
        print(f"  {mid}: answered_by={r.get('by')} tokens={len(r.get('answer', []))}")

    print("\nlearned agent profiles (output-length modes):")
    for a in wf.orch.profiler.agents():
        print(f"  {a:18s} out_len~{wf.orch.profiler.expected_output_len(a)} "
              f"exec~{wf.orch.profiler.expected_exec_time(a):.3f}s")
    wf.orch.refresh_priorities()
    print("\nworkflow-aware priorities (lower = scheduled first):")
    for k, v in sorted(wf.orch.priorities.scores.items(), key=lambda kv: kv[1]):
        print(f"  {k[1]:18s} {v:.3f}")

    pc = wf.prefix_cache_stats()
    print(f"\nprefix cache: {pc['prefill_tokens_saved']} of "
          f"{pc['prefill_tokens'] + pc['prefill_tokens_saved']} prompt tokens "
          f"served from shared KV ({pc['savings']:.0%} prefill saved)")
    ok = len(results) == len(ids)
    print("\nQUICKSTART", "OK" if ok else "INCOMPLETE")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
