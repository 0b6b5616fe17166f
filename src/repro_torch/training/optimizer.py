"""Optimizers: Adam (<=34B models) and Adafactor (trillion-param MoE).

The JAX package's ``training/optimizer.py`` on nested dicts of tensors.
Functional, as there: an update takes (params, grads, state, step) and
returns new params and state, whose trees mirror the parameter tree leaf
for leaf (Adam's fp32 ``m`` / ``v``; Adafactor's factored ``vr`` / ``vc``,
a ``(1,)`` ``vr`` and a full ``vc`` for vectors).  ``step`` is a tensor,
and the bias corrections and Adafactor's ``beta`` are computed from it in
fp32, as the reference computes them.

``make_train_step`` donates its state, as the reference's callers jit the
step with ``donate_argnums=(0,)``: each leaf's new values are written into
the tensors it was given, so the old and new optimizer state never
coexist (at 1.7 B parameters Adam's moments alone are 13.8 GB).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import spmd


@dataclasses.dataclass(frozen=True)
class AdamConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    name: str = "adam"


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    name: str = "adafactor"


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts of one layout."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_leaves(tree) -> list:
    """The leaves of a nested dict, in the order :func:`tree_map` walks."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


def _apply(leaf_fn, params, grads, slots: tuple, donate: bool):
    """``leaf_fn(p, g, *slot leaves) -> (p2, *slots2)`` over the trees ->
    (new params, the new slot trees).  With ``donate`` each result is
    copied into the tensors passed in, leaf by leaf, and those are
    returned."""
    def leaf(p, g, *s):
        new = leaf_fn(p, g, *s)
        if not donate:
            return new
        for old, value in zip((p, *s), new):
            old.copy_(value)
        return (p, *s)

    out = tree_map(leaf, params, grads, *slots)
    return tuple(_pick(out, i) for i in range(1 + len(slots)))


def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]


def _step_t(step, device) -> torch.Tensor:
    """``(step + 1)`` as an fp32 scalar on ``device``."""
    return (torch.as_tensor(step, device=device) + 1).to(torch.float32)


def adam_init(params: dict) -> dict:
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def adam_update(cfg: AdamConfig, params: dict, grads: dict, state: dict,
                step, donate: bool = False):
    """-> (new params, {"m", "v"}); new params in each leaf's dtype."""
    t = _step_t(step, tree_leaves(params)[0].device)
    c1 = 1 - torch.pow(cfg.b1, t)
    c2 = 1 - torch.pow(cfg.b2, t)

    def upd(p, g, m, v):
        g = g.float()
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        mh = m2 / c1
        vh = v2 / c2
        delta = cfg.lr * mh / (torch.sqrt(vh) + cfg.eps)
        if cfg.weight_decay:
            delta = delta + cfg.lr * cfg.weight_decay * p.float()
        return (p.float() - delta).to(p.dtype), m2, v2

    new_params, m, v = _apply(upd, params, grads, (state["m"], state["v"]),
                              donate)
    return new_params, {"m": m, "v": v}


def adafactor_init(params: dict) -> dict:
    """Factored second moment: (row, col) factors over the last two dims
    of >=2D leaves (leading dims, the layer stack's included, stay batch
    dims), full for vectors."""
    def vr(p):
        shape = p.shape[:-1] if p.dim() >= 2 else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vc(p):
        shape = p.shape[:-2] + p.shape[-1:] if p.dim() >= 2 else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return {"vr": tree_map(vr, params), "vc": tree_map(vc, params)}


def adafactor_update(cfg: AdafactorConfig, params: dict, grads: dict,
                     state: dict, step, donate: bool = False):
    """-> (new params, {"vr", "vc"}); new params in each leaf's dtype."""
    t = _step_t(step, tree_leaves(params)[0].device)
    beta = 1.0 - t ** (-cfg.decay)

    def upd(p, g, vr, vc):
        g = g.float()
        g2 = torch.square(g) + cfg.eps
        if p.dim() >= 2:
            vr2 = beta * vr + (1 - beta) * g2.mean(dim=-1)
            vc2 = beta * vc + (1 - beta) * g2.mean(dim=-2)
            # on DTensors the factors take g's layout before their outer
            # product, which is as large as g
            lead = tuple(range(g.ndim - 2))
            vr_g = spmd.follow(vr2, g, (*lead, g.ndim - 2))
            vc_g = spmd.follow(vc2, g, (*lead, g.ndim - 1))
            denom = torch.clamp(vr_g.mean(dim=-1, keepdim=True), min=cfg.eps)
            vhat = vr_g[..., :, None] * vc_g[..., None, :] / denom[..., None]
        else:
            vr2, vc2 = vr, beta * vc + (1 - beta) * g2
            vhat = vc2
        update = g / torch.sqrt(vhat + cfg.eps)
        norm = torch.sqrt(torch.mean(torch.square(update)))
        update = update / torch.clamp(norm / cfg.clip_threshold, min=1.0)
        return (p.float() - cfg.lr * update).to(p.dtype), vr2, vc2

    new_params, vr, vc = _apply(upd, params, grads,
                                (state["vr"], state["vc"]), donate)
    return new_params, {"vr": vr, "vc": vc}


def make_optimizer(kind: str):
    """-> (config, init(params), update(params, grads, state, step,
    donate=False))."""
    if kind == "adam":
        cfg = AdamConfig()
        return cfg, adam_init, lambda p, g, s, t, donate=False: adam_update(
            cfg, p, g, s, t, donate)
    cfg = AdafactorConfig()
    return cfg, adafactor_init, lambda p, g, s, t, donate=False: (
        adafactor_update(cfg, p, g, s, t, donate))


def make_train_step(model, opt_kind: str = "adam"):
    """Returns (init_state(generator, device), train_step(state, batch) ->
    (state, metrics)).

    The state is {"params", "opt", "step"}: nested dicts of tensors and an
    int32 scalar.  ``train_step`` takes the gradient of ``model.loss``
    over every param leaf with ``torch.autograd.grad`` and updates under
    ``no_grad``; it donates ``state`` (updates its tensors in place and
    returns it).  The batch holds tensors on the params' device."""
    _, opt_init, opt_update = make_optimizer(opt_kind)

    def init_state(generator: torch.Generator, device=None) -> dict:
        device = resolve_device(device)
        params = model.init_params(generator, device)
        return {"params": params, "opt": opt_init(params),
                "step": torch.zeros((), dtype=torch.int32, device=device)}

    def train_step(state: dict, batch: dict):
        # aliases of the params that autograd tracks (no copy)
        tracked = tree_map(lambda p: p.detach().requires_grad_(),
                           state["params"])
        leaves = tree_leaves(tracked)
        loss, metrics = model.loss(tracked, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        del tracked, leaves
        it = iter(grads)
        grads = tree_map(lambda _: next(it), state["params"])
        with torch.no_grad():
            params, opt = opt_update(state["params"], grads, state["opt"],
                                     state["step"], donate=True)
            state.update(params=params, opt=opt)
            state["step"].add_(1)
        out = {"loss": loss.detach(),
               **{k: v.detach() for k, v in metrics.items()}}
        return state, out

    return init_state, train_step
