"""Operation and byte counts against hand counts at a small shape."""
from portbench import roofline
from portbench.reference.spec import MoE, Arch

A = Arch(layers=2, d_model=8, heads=4, kv_heads=2, head_dim=4, d_ff=16,
         vocab=10, eps=1e-6, rope_theta=1e4, qk_norm=True, tied=True,
         dtype="bfloat16")


def test_matrix_params_dense():
    attn = 8 * 4 * (4 + 2 * 2) + 4 * 4 * 8      # q, k, v; o
    ffn = 3 * 8 * 16
    assert A.matrix_params() == 2 * (attn + ffn)


def test_matrix_params_moe():
    m = Arch(**{**A.__dict__, "moe": MoE(num_experts=6, top_k=2, d_expert=4,
                                         d_shared=12, renormalize=True,
                                         capacity_factor=3.0)})
    attn = 8 * 4 * 8 + 16 * 8
    ffn = 2 * 3 * 8 * 4 + 3 * 8 * 12 + 8 * 6   # top-2, shared, router
    assert m.matrix_params() == 2 * (attn + ffn)


def test_paged_bytes():
    # two rows of context 3 and 5: K and V of 2 heads x 4 dims in 2 bytes,
    # and a query and an output of 4 heads x 4 dims
    kv = 2 * 2 * 4 * 2
    qo = 2 * 4 * 4 * 2
    assert roofline.paged_bytes(A, [3, 5]) == 3 * kv + qo + 5 * kv + qo


def test_ragged_cost():
    # one chunk of 3 tokens at positions 2, 3, 4: visible keys 3 + 4 + 5
    ops, by = roofline.ragged_cost(A, [(2, 5)])
    assert ops == 4 * 4 * 4 * (3 + 4 + 5)
    assert by == (5 * 2 * 2 * 4 + 2 * 3 * 4 * 4) * 2
    assert roofline.chunk_contexts_sum(2, 5) == 12


def test_step_flops_and_bound():
    f = roofline.step_flops(A, n_tokens=3, context_sum=12, sampled_rows=1)
    assert f == (3 * 2 * A.matrix_params() + 12 * 4 * 4 * 4 * 2
                 + 1 * 2 * 8 * 10)
    assert roofline.bound_s(989e12, 0) == 1.0
    assert roofline.bound_s(0, 3.35e12) == 1.0
