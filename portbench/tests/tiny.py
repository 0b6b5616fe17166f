"""A cell of the manifest cut to a size the CPU runs in seconds: the
port's reduced widths (2 layers, d 256, 4 heads over 2, hd 64, vocab 512)
and a handful of sessions with short prompts and answers."""
from __future__ import annotations

import copy

from portbench import manifest

SEED = 2 ** 31 + 12345

# the manifest's cells, and one whose configuration and mix are kept under
# portbench/ for a later cell: the MoE under the agent loop
CELLS = ("qwen3-1.7b.qa-sessions", "qwen2-moe-a2.7b.agent-loop")
KEPT = {"qwen2-moe-a2.7b.agent-loop": ("qwen2-moe-a2.7b", "agent-loop")}


def full_cell(name: str) -> manifest.Cell:
    """``name`` at full size, from the manifest, or for a kept cell from
    a manifest that has it beside the others, metrics and all."""
    m = manifest.load_manifest()
    if name in KEPT and name not in {w["name"] for w in m["workloads"]}:
        config, mix = KEPT[name]
        m = copy.deepcopy(m)
        m["configs"].append({"name": config, "reduced": [],
                             "file": f"portbench/configs/{config}.json"})
        m["workloads"].append({"name": name, "config": config,
                               "traffic": mix, "chips": 1})
        for metric in m["per_layer"] + m["end_to_end"]:
            if "workloads" in metric:
                metric["workloads"].append(name)
    return manifest.cell(name, m)


# float32 at this size: the program reads ~1e-6 at the widest and ~0 on
# the mean.  bfloat16: the program reads 0-5.6e-3 at the widest and
# 0-5.1e-4 on the mean, the fp8 control 7.0e-2-4.1e-1 and 7.6e-3-5.5e-2
# (three seeds of each cell, on the ~20 served positions a tiny run
# checks; the bf16 control of float32 flips 0-1 of them)
TINY_LIMITS = {"float32": {"logit_gap": 1e-3, "mean_logit_gap": 1e-5},
               "bfloat16": {"logit_gap": 3e-2, "mean_logit_gap": 3e-3}}


def tiny_cell(name: str, dtype: str = "float32", sessions: int = 6):
    c = full_cell(name)
    cfg = copy.deepcopy(c.config)
    cfg.update(hidden_size=256, intermediate_size=512, num_hidden_layers=2,
               num_attention_heads=4, num_key_value_heads=2, head_dim=64,
               vocab_size=512, torch_dtype=dtype)
    if cfg.get("num_experts"):
        cfg.update(num_experts=4, num_experts_per_tok=2,
                   moe_intermediate_size=128,
                   shared_expert_intermediate_size=128,
                   moe_capacity_factor=2.0)
    cfg["serving"] = dict(cfg["serving"], num_blocks=2048, max_batch=8)
    cfg["warm_requests"] = 2
    cfg["check"] = dict(cfg["check"], min_tokens=16, max_calls=12,
                        limits={k: TINY_LIMITS[dtype][k]
                                for k in cfg["check"]["limits"]})
    t = copy.deepcopy(c.traffic)
    t.update(sessions=sessions, warmup_s=1.0, start_spread_s=0.5,
             think_s={"dist": "uniform", "lo": 0.01, "hi": 0.05},
             task_tokens={"dist": "uniform_int", "lo": 8, "hi": 32})
    t["system_prompts"] = {k: min(v, 64)
                           for k, v in t["system_prompts"].items()}
    if "max_context" in t:
        t["max_context"] = 400
    for st in t["stages"]:
        st["output"] = {"dist": "uniform_int", "lo": 2, "hi": 6}
        if "tool_tokens" in st:
            st["tool_tokens"] = {"dist": "uniform_int", "lo": 8, "hi": 24}
            st["tool_latency_s"] = {"dist": "uniform", "lo": 0.01,
                                    "hi": 0.05}
    c.config, c.traffic = cfg, t
    return c
