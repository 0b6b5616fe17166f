"""The port's attention kernels against the JAX package's.

On the CPU the torch plain versions (``repro_torch.kernels.ref``) are held
against the JAX oracles (``repro.kernels.ref``) and the Pallas kernels in
interpret mode, on the sweeps of ``tests/test_kernels.py``, with inputs
made by numpy from a seed.  Tolerances: f32 2e-5, bf16 2e-2 (the two
frameworks round bf16 products at different points).  The CUDA kernels
themselves run only on the card: ``tests/test_torch_cuda.py`` (which also
holds the input helpers used here) and ``chip_smoke.py`` run them there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import paged_attention as pallas_paged
from repro.kernels.ragged_attention import (
    ragged_segment_attention as pallas_ragged,
)
from repro.kernels.ref import (
    chunked_prefill_attention_ref as jax_chunked_ref,
    paged_attention_ref as jax_paged_ref,
    ragged_segment_attention_ref as jax_ragged_ref,
)
from repro_torch.kernels import ops
from repro_torch.kernels.paged_attention import paged_attention
from repro_torch.kernels.ragged_attention import ragged_segment_attention
from repro_torch.kernels.ref import (
    chunked_prefill_attention_ref,
    paged_attention_ref,
    ragged_segment_attention_ref,
)
from test_torch_cuda import (
    RAGGED_SWEEP,
    SHAPES,
    as_np,
    assert_close,
    paged_case,
    ragged_case,
    to_torch,
)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def to_jax(arrays, jdt):
    return [jnp.asarray(a, jdt) if a.dtype == np.float32 else jnp.asarray(a)
            for a in arrays]


# =============================================================================
# plain versions against the JAX oracles and the Pallas kernels (CPU)
# =============================================================================


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_paged_ref_matches_jax(shape, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    case = paged_case(42, *shape)
    ours = as_np(paged_attention_ref(*to_torch(case, tdt)))
    jargs = to_jax(case, jdt)
    assert ours.shape == shape[:4]
    assert_close(ours, jax_paged_ref(*jargs), tol)
    assert_close(ours, pallas_paged(*jargs, interpret=True), tol)


@pytest.mark.parametrize("case", RAGGED_SWEEP)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_ragged_ref_matches_jax(case, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    arrays = ragged_case(11, *case)
    ours = as_np(ragged_segment_attention_ref(*to_torch(arrays, tdt)))
    jargs = to_jax(arrays, jdt)
    assert ours.shape == arrays[0].shape
    assert not np.isnan(ours).any()
    assert_close(ours, jax_ragged_ref(*jargs), tol)
    assert_close(ours, pallas_ragged(*jargs, interpret=True), tol)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_chunked_prefill_ref_matches_jax(dtype, window):
    """The dense causal (optionally sliding-window) oracle."""
    jdt, tdt, tol = DTYPES[dtype]
    rng = np.random.default_rng(4)
    arrays = (rng.standard_normal((2, 9, 2, 4, 64), np.float32),
              rng.standard_normal((2, 9, 2, 64), np.float32),
              rng.standard_normal((2, 9, 2, 64), np.float32))
    ours = as_np(chunked_prefill_attention_ref(*to_torch(arrays, tdt),
                                               window=window))
    assert ours.shape == arrays[0].shape
    assert_close(ours, jax_chunked_ref(*to_jax(arrays, jdt), window=window),
                 tol)


@pytest.mark.parametrize("case", RAGGED_SWEEP)
def test_flat_ref_lowering_equals_ref(case):
    args = to_torch(ragged_case(5, *case), torch.float32)
    assert_close(as_np(ops.ragged_segment_attention(*args, backend="flat_ref")),
                 as_np(ops.ragged_segment_attention(*args, backend="ref")),
                 2e-5)


def test_cpu_wrappers_compute_the_plain_version():
    """On CPU tensors the kernel wrappers run the plain versions and
    launch nothing."""
    before = (paged_attention.launches, ragged_segment_attention.launches)
    pargs = to_torch(paged_case(1, *SHAPES[0]), torch.float32)
    rargs = to_torch(ragged_case(1, *RAGGED_SWEEP[0]), torch.float32)
    assert torch.equal(paged_attention(*pargs), paged_attention_ref(*pargs))
    assert torch.equal(ragged_segment_attention(*rargs),
                       ragged_segment_attention_ref(*rargs))
    assert (paged_attention.launches,
            ragged_segment_attention.launches) == before


def test_single_token_context_attends_first_token():
    q, kp, vp, bt, _ = to_torch(paged_case(0, 1, 1, 2, 64, 8, 2, 8),
                                torch.float32)
    out = paged_attention_ref(q, kp, vp, bt, torch.ones(1, dtype=torch.int32))
    expect = vp[bt[0, 0], 0][None, :, None, :].expand_as(out)
    assert_close(as_np(out), as_np(expect), 1e-5)


def test_pages_past_context_or_bound_are_ignored():
    """Poisoning pages past a sequence's context (decode) or past a
    segment's page bound (ragged) cannot change the output.  The decode
    plain version gathers every table page and masks, so its poison is
    finite; the ragged one never gathers past the bound, so NaN works."""
    q, kp, vp, bt, _ = to_torch(paged_case(7, 1, 2, 2, 64, 8, 4, 32),
                                torch.float32)
    cl = torch.tensor([11], dtype=torch.int32)
    out = paged_attention_ref(q, kp, vp, bt, cl)
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[bt[0, 2]] = 1e4
    vp2[bt[0, 3]] = -1e4
    assert torch.equal(out, paged_attention_ref(q, kp2, vp2, bt, cl))

    q, kp, vp, bt, pos = to_torch(
        ragged_case(3, [(4, 6), (2, 0)], 2, 2, 64, 8, 4, 40), torch.float32)
    out = ragged_segment_attention_ref(q, kp, vp, bt, pos)
    bt2 = bt.clone()
    bt2[0, 2:] = 39                 # bounds: page 1 and page 0
    bt2[1, 1:] = 39
    kp2, vp2 = kp.clone(), vp.clone()
    kp2[39] = 1e4
    vp2[39] = float("nan")
    assert torch.equal(out, ragged_segment_attention_ref(q, kp2, vp2, bt2, pos))


# =============================================================================
# backend switch contract
# =============================================================================


@pytest.mark.parametrize("backend", ["cuda", "ref", "flat", "flat_ref"])
def test_empty_batches_are_noops(backend):
    kp = torch.zeros(4, 8, 2, 64)
    q = torch.zeros(0, 0, 2, 2, 64)
    tables = torch.zeros(0, 4, dtype=torch.int32)
    pos = torch.zeros(0, 0, dtype=torch.int32)
    assert ops.ragged_segment_attention(q, kp, kp, tables, pos,
                                        backend=backend) is q
    if backend in ops.PAGED_BACKENDS:
        qd = torch.zeros(0, 2, 2, 64)
        out = ops.paged_attention(qd, kp, kp, tables,
                                  torch.zeros(0, dtype=torch.int32),
                                  backend=backend)
        assert out.shape == (0, 2, 2, 64)
    # the decode wrapper itself returns an empty result for B == 0
    assert paged_attention(torch.zeros(0, 2, 2, 64), kp, kp, tables,
                           torch.zeros(0, dtype=torch.int32)).numel() == 0


def test_unknown_backend_raises():
    args = to_torch(ragged_case(0, *RAGGED_SWEEP[0]), torch.float32)
    with pytest.raises(ValueError):
        ops.ragged_segment_attention(*args, backend="pallas")
    pargs = to_torch(paged_case(0, *SHAPES[0]), torch.float32)
    with pytest.raises(ValueError):
        ops.paged_attention(*pargs, backend="flat")


def test_default_backend_follows_the_device():
    assert ops.default_backend("cpu") == "ref"
    assert ops.default_backend("cuda") == "cuda"


# =============================================================================
# the CUDA build and the launchers' operand checks (no card needed)
# =============================================================================


def test_missing_nvcc_raises(monkeypatch):
    """No compiler, no kernels: the build raises instead of falling back."""
    import torch.utils.cpp_extension as cpp_ext
    from repro_torch.kernels import build
    monkeypatch.setattr(cpp_ext, "CUDA_HOME", None)
    monkeypatch.setenv("PATH", "")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.find_nvcc()


@pytest.mark.parametrize("bad", ["head_dim", "table_dtype", "float_dtype",
                                 "mixed_dtypes", "non_contiguous"])
def test_launcher_operand_checks_reject(bad):
    from repro_torch.kernels import build
    q, kp, vp, bt, cl = to_torch(paged_case(0, *SHAPES[0]), torch.float32)
    if bad == "head_dim":
        q, kp = q[..., :48].contiguous(), kp[..., :48].contiguous()
    elif bad == "table_dtype":
        bt = bt.long()
    elif bad == "float_dtype":
        q, kp = q.half(), kp.half()
    elif bad == "mixed_dtypes":
        kp = kp.bfloat16()
    else:
        q = q.transpose(1, 2)
    with pytest.raises((ValueError, TypeError)):
        build.check_operands("paged_attention", (q, kp), (bt, cl))
        build.dtype_code(q)
