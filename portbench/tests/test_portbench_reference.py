"""The reference against the port at a tiny size on the CPU, on the
weights the benchmark makes: the port's whole-sequence prefill and the
reference give the same last-position logits in float32."""
import pytest
import torch

from portbench.harness import port_config
from portbench.reference.model import Forward
from portbench.reference.spec import arch_of
from portbench.tests.tiny import CELLS, SEED, full_cell, tiny_cell
from portbench.weights import count_params, make_weights



@pytest.mark.parametrize("name", CELLS)
def test_prefill_logits_match(name):
    from repro_torch.models import build_model
    cell = tiny_cell(name)
    arch = arch_of(cell.config)
    w = make_weights(arch, SEED, "cpu")
    model = build_model(port_config(cell.config, arch, check_registry=False))
    toks = torch.randint(0, arch.vocab, (1, 40),
                         generator=torch.Generator().manual_seed(1))
    port, _ = model.prefill(w, toks)
    ref = Forward(w, arch).logits(toks[0], torch.tensor([39]))
    scale = ref.abs().max()
    assert float((port.float() - ref).abs().max() / scale) < 1e-5


@pytest.mark.parametrize("name", CELLS)
def test_full_configs_match_the_port(name):
    """The configuration file states what the port's registry holds (but
    the norms' epsilon and the MoE capacity, which the file sets), at the
    published widths."""
    cell = full_cell(name)
    arch = arch_of(cell.config)
    cfg = port_config(cell.config, arch)      # raises on a difference
    assert cfg.num_layers == arch.layers and cfg.d_model == arch.d_model
    assert cfg.norm_eps == arch.eps == 1e-6
    if arch.moe is not None:
        # capacity(n) = n: no assignment drops
        from repro_torch.models.moe import capacity
        for n in (1, 8, 64, 576, 4096):
            assert capacity(n, cfg) == max(8, n)


def test_param_counts():
    q = arch_of(full_cell("qwen3-1.7b.qa-sessions").config)
    e = arch_of(full_cell("qwen2-moe-a2.7b.agent-loop").config)
    # norms and the router are counted as the port lays them out
    assert count_params(q) == 1_720_574_976
    assert abs(count_params(e) - 14_315_587_584) < 3_000_000


def test_weights_repeat_by_seed():
    cell = tiny_cell("qwen2-moe-a2.7b.agent-loop")
    arch = arch_of(cell.config)
    a, b = make_weights(arch, 7, "cpu"), make_weights(arch, 7, "cpu")
    c = make_weights(arch, 8, "cpu")
    assert torch.equal(a["layers"]["moe"]["w_up"], b["layers"]["moe"]["w_up"])
    assert not torch.equal(a["embed"], c["embed"])
