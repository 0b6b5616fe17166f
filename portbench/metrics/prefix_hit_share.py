"""Share of the window's prompt tokens served from the prefix cache:
tokens whose prefill was skipped over tokens skipped plus tokens
computed, from the engines' counters at the window's edges."""
UNIT = "%"
LAYER = "KV and prefix cache"
MOVES = "workflow_e2e_p50_s"


def read(res):
    a, b = res.recorder.at_open, res.recorder.at_close
    saved = b["prefill_tokens_saved"] - a["prefill_tokens_saved"]
    computed = b["prefill_tokens"] - a["prefill_tokens"]
    if saved + computed <= 0:
        return None
    return 100.0 * saved / (saved + computed)
