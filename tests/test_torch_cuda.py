"""The port's CUDA kernels and engine on the card.

Every test here needs an NVIDIA card: each carries the ``cuda`` marker and
skips without one.  The file imports no JAX (the machine with the card
has none), so on that machine it runs as

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` runs the same checks, and more, at full width.  The
input helpers below are shared with ``tests/test_torch_kernels.py``.
Tolerances: f32 2e-5, bf16 2e-2, as ``tests/test_kernels.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import serving
from repro_torch.configs import get_config
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ragged_attention import ragged_segment_attention
from repro_torch.kernels.ref import (
    paged_attention_ref,
    ragged_segment_attention_ref,
)
from repro_torch.models import LanguageModel

# the sweeps of tests/test_kernels.py
SHAPES = [
    # b, kv, g, hd, bs, nb_per_seq, n_pool
    (2, 2, 4, 64, 8, 3, 16),
    (1, 1, 8, 128, 16, 2, 8),
    (3, 4, 2, 64, 4, 5, 64),
    (2, 8, 1, 32, 8, 4, 64),
]

RAGGED_SWEEP = [
    # (seg_specs [(len, n_cached)...], kv, g, hd, bs, nb, n_pool)
    ([(6, 0), (3, 13), (1, 20)], 2, 4, 64, 8, 4, 40),
    ([(5, 3), (5, 11), (5, 19)], 1, 8, 128, 16, 2, 8),
    ([(7, 9)], 4, 2, 64, 4, 6, 32),
    ([(1, 0), (1, 7), (1, 15), (1, 30)], 8, 1, 32, 8, 4, 64),
]

TORCH_DTYPES = {"float32": (torch.float32, 2e-5),
                "bfloat16": (torch.bfloat16, 2e-2)}


def paged_case(seed, b, kv, g, hd, bs, nb, n_pool):
    """float32 numpy inputs: q, pools, unique block tables, context lens."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kv, g, hd), np.float32)
    kp = rng.standard_normal((n_pool, bs, kv, hd), np.float32)
    vp = rng.standard_normal((n_pool, bs, kv, hd), np.float32)
    bt = rng.permutation(n_pool)[:b * nb].reshape(b, nb).astype(np.int32)
    cl = rng.integers(1, nb * bs + 1, b).astype(np.int32)
    return q, kp, vp, bt, cl


def ragged_case(seed, seg_specs, kv, g, hd, bs, nb, n_pool):
    """Segments of (length, n_cached) tiled to a dense (S, L) block with
    padding rows at position 0."""
    rng = np.random.default_rng(seed)
    kp = rng.standard_normal((n_pool, bs, kv, hd), np.float32)
    vp = rng.standard_normal((n_pool, bs, kv, hd), np.float32)
    perm = rng.permutation(n_pool)
    s, lmax = len(seg_specs), max(n for n, _ in seg_specs)
    bt = np.stack([perm[i * nb:(i + 1) * nb] for i in range(s)]).astype(np.int32)
    pos = np.zeros((s, lmax), np.int32)
    for i, (n, c) in enumerate(seg_specs):
        pos[i, :n] = np.arange(c, c + n)
    q = rng.standard_normal((s, lmax, kv, g, hd), np.float32)
    return q, kp, vp, bt, pos


def to_torch(arrays, tdt, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=tdt)
            if a.dtype == np.float32 else torch.from_numpy(a).to(device)
            for a in arrays]


def assert_close(actual, expected, tol):
    np.testing.assert_allclose(np.asarray(actual, np.float32),
                               np.asarray(expected, np.float32),
                               rtol=tol, atol=tol)


def as_np(t: torch.Tensor) -> np.ndarray:
    return t.float().cpu().numpy()


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (chip_smoke.py runs these there)")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
def test_cuda_paged_kernel_matches_ref(cuda, dtype):
    tdt, tol = TORCH_DTYPES[dtype]
    for shape in SHAPES:
        args = to_torch(paged_case(42, *shape), tdt, cuda)
        assert_close(as_np(paged_attention(*args)),
                     as_np(paged_attention_ref(*args)), tol)
    q, kp, vp, bt, _ = to_torch(paged_case(0, *SHAPES[0]), tdt, cuda)
    zero = paged_attention(q, kp, vp, bt,
                           torch.zeros(len(q), dtype=torch.int32,
                                       device=cuda))
    assert not zero.any(), "cl = 0 gives zero rows"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(TORCH_DTYPES))
def test_cuda_ragged_kernel_matches_ref(cuda, dtype):
    tdt, tol = TORCH_DTYPES[dtype]
    for case in RAGGED_SWEEP:
        args = to_torch(ragged_case(11, *case), tdt, cuda)
        out = as_np(ragged_segment_attention(*args))
        assert not np.isnan(out).any()
        assert_close(out, as_np(ragged_segment_attention_ref(*args)), tol)


@pytest.mark.cuda
def test_cuda_kernels_never_read_past_the_bounds(cuda):
    """NaN past a sequence's context (decode) or past a segment's page
    bound (ragged) changes no bit of the kernels' output."""
    q, kp, vp, bt, _ = to_torch(paged_case(7, 1, 2, 2, 64, 8, 4, 32),
                                torch.float32, cuda)
    cl = torch.tensor([11], dtype=torch.int32, device=cuda)
    out = paged_attention(q, kp, vp, bt, cl)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[bt[0, 1], 3:] = float("nan")        # tokens 11.. of page 1
    vp2[bt[0, 2:].long()] = float("nan")
    assert torch.equal(out, paged_attention(q, kp2, vp2, bt, cl))

    q, kp, vp, bt, pos = to_torch(
        ragged_case(3, [(4, 6), (2, 0)], 2, 2, 64, 8, 4, 40), torch.float32,
        cuda)
    out = ragged_segment_attention(q, kp, vp, bt, pos)
    bt2 = bt.clone()
    bt2[0, 2:] = 39                 # bounds: page 1 and page 0
    bt2[1, 1:] = 39
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[39] = 1e4
    vp2[39] = float("nan")
    assert torch.equal(out, ragged_segment_attention(q, kp2, vp2, bt2, pos))


@pytest.mark.cuda
def test_cuda_engine_matches_ref_drain(cuda):
    """The engine on the CUDA kernels drains token-identically to the
    plain versions on the card (reduced qwen3-1.7b, fp32, chunked prefill,
    prefix cache and preemption), launching both kernels."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="float32")
    model = LanguageModel(cfg)
    params = model.init_params(torch.Generator(cuda).manual_seed(0), cuda)
    outs = {}
    for backend in ("ref", "cuda"):
        serving.reset_request_ids()
        runner = serving.PagedModelRunner(model, params, num_blocks=18,
                                          block_size=8, max_batch=4,
                                          backend=backend, device=cuda)
        eng = serving.LLMEngine(runner, max_batch=4, enable_prefix_cache=True,
                                prefill_chunk_tokens=8)
        rng = np.random.default_rng(3)
        system = rng.integers(0, 500, 8)
        for i in range(5):
            toks = np.concatenate([system, rng.integers(0, 500, 19 + i)])
            eng.submit(serving.Request(
                agent_name="a", msg_id=f"m{i}", prompt_len=len(toks),
                prompt_tokens=toks.astype(np.int32), max_new_tokens=10,
                arrival_time=float(i)))
        before = (paged_attention.launches, ragged_segment_attention.launches)
        done = eng.run_until_drained(4000)
        launched = (paged_attention.launches - before[0],
                    ragged_segment_attention.launches - before[1])
        assert len(done) == 5
        assert (min(launched) > 0) == (backend == "cuda")
        outs[backend] = sorted((r.msg_id, tuple(int(t) for t in
                                                r.output_tokens))
                               for r in done)
    assert outs["cuda"] == outs["ref"]
