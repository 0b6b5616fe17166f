"""The port's legacy per-chunk path on the reduced qwen2-moe against the
JAX package's legacy path, in fp32, under every mix of
``tests/test_torch_moe.py`` (which holds the fused path): with MoE a
row's output depends on the rows it is batched with (capacity counts
them, padding included), so each path is held to its own reference.
A file of its own, so that each file of the two stays short.
"""
import pytest

from test_torch_moe import MIXES, check_mix, moe_models  # noqa: F401


@pytest.mark.parametrize("mix", list(MIXES))
def test_moe_legacy_engine_token_identical_to_jax(moe_models, mix):
    check_mix(moe_models, mix, fused=False)
