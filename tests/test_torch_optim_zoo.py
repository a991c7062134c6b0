"""The port's optimizers against the JAX factory (``train/optim.py``,
``train/optim_extra.py``, ``train/adahessian.py``): every name
``create_optimizer`` takes, and the ``lookahead_`` prefix, on identical
gradients (and, for adahessian, identical Hessian diagonals; its Hessian
step: ``tests/test_torch_adahessian.py``) for 7 steps (lookahead syncs
once, at the 6th), on a handful of leaves of the models' kinds and layouts: a patch
conv (torch OIHW, flax HWIO), a square and a non-square Dense kernel at
widths where Adafactor factors its second moment (both dimensions at least
128), a narrow one, a LayerNorm, a ``cls_token``, a 0-d ``temp`` and a
VQA head.

Tolerance: every parameter after every step within rtol 1e-5 and atol
1e-4 of the step's scale (lr times the head multiplier): optax takes the
bias corrections ``1 - b**t`` (and Nadam's schedule, RAdam's
rectification, Adafactor's decay) in float32, the port in float64, and
float32's ``1 - 0.999**t`` is off by up to 6e-5 / t of itself, 3e-5 / t of
an Adam-like step through the square root (``tests/test_torch_train.py``
holds 3 steps to 3e-5); over 7 steps that sums to 7.8e-5.  Adafactor's
row and column factors are applied in the other order on torch's
transposed kernels (the same product, rounded apart).  AdamP and SGDP are held
against the JAX factory on the same leaves in torch's layout: their
projection views a parameter by its first axis, the output channel in
torch's layout (the reference's view) and the input (or the kernel's
height) in flax's.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from torch import nn

from torch_port_util import jax_params_of, port_layout
from vqattack_tpu.train import optim as joptim
from vqattack_tpu_torch.checkpoint.convert import flax_leaves
from vqattack_tpu_torch.train import optim

LR = 1e-2
STEPS = 7
ATOL = 1e-4  # of a step (see the module's docstring)
TORCH_LAYOUT = ("adamp", "sgdp")


class ZooNet(nn.Module):
    """The leaves an optimizer meets in the models, by kind and layout."""

    def __init__(self, seed: int = 0):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, 128, 4, stride=4)
        self.query = nn.Linear(128, 128, bias=False)  # square
        self.intermediate = nn.Linear(128, 160)  # torch [160, 128], flax [128, 160]
        self.output = nn.Linear(128, 32, bias=False)  # second largest 32: not factored
        self.LayerNorm = nn.LayerNorm(128)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, 128))
        self.temp = nn.Parameter(torch.tensor(0.07))
        self.vqa_classifier = nn.Linear(32, 10)  # the head
        rng = np.random.default_rng(seed)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(torch.from_numpy(rng.normal(0, 0.05, p.shape).astype(np.float32)))
            self.LayerNorm.weight.add_(1.0)


def torch_layout_tree(model) -> dict:
    """The flax tree's paths with each leaf in the parameter's torch layout."""
    tree: dict = {}
    for _, path, _, p in flax_leaves(model):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = p.detach().numpy().copy()
    return {"params": tree}


def _layout_fns(model, torch_layout: bool):
    """(port params -> JAX tree, JAX tree -> arrays by port name)."""
    if torch_layout:
        return (lambda: torch_layout_tree(model),
                lambda tree: {n: np.asarray(_leaf(tree, path))
                              for n, path, _, _ in flax_leaves(model)})
    return lambda: jax_params_of(model), lambda tree: port_layout(model, tree)


def _leaf(tree, path):
    node = tree["params"]
    for p in path:
        node = node[p]
    return node


def run_both(opt, kw, grads_fn, torch_layout=False, steps=STEPS, seed=0):
    """``steps`` updates of ``opt`` through the JAX factory and the port's
    from the same ZooNet and the same gradients (``grads_fn(model, rng)``
    by port name, in torch's layout): yields ``(step, port params, JAX
    params by port name, the port's state)`` after each."""
    model = ZooNet(seed)
    to_jax, from_jax = _layout_fns(model, torch_layout)
    p_j = to_jax()
    sched = joptim.create_schedule("cosine", LR, total_steps=steps + 2, warmup_steps=2)
    tx = joptim.create_optimizer(p_j, opt, sched, weight_decay=0.1, **kw)
    j_state = tx.init(p_j)
    t_tx = optim.create_optimizer(model, opt, optim.create_schedule(
        "cosine", LR, total_steps=steps + 2, warmup_steps=2), weight_decay=0.1, **kw)
    t_params = optim.named_params(model)
    t_state = t_tx.init(t_params)
    paths = {n: path for n, path, _, _ in flax_leaves(model)}

    @jax.jit  # one program; eager, optax dispatches every leaf's update on its own
    def j_step(grads, state, p, hess):
        extra = {} if hess is None else {"hess_diag": hess}
        updates, state = tx.update(grads, state, p, **extra)
        return jax.tree_util.tree_map(lambda a, u: a + u, p, updates), state

    def jax_tree(by_name):  # arrays by port name (torch layout) -> the JAX tree
        tree = jax.tree_util.tree_map(np.zeros_like, p_j)
        for n, t in by_name.items():
            node = tree["params"]
            for key in paths[n][:-1]:
                node = node[key]
            node[paths[n][-1]] = (t.numpy() if torch_layout else
                                  _flax_layout(model, n, t.numpy()))
        return tree

    rng = np.random.default_rng(seed + 1)
    for step in range(steps):
        g = grads_fn(model, rng)
        hess = hessian_diagonals(model, rng) if t_tx.needs_hessian else None
        p_j, j_state = j_step(jax_tree(g), j_state, p_j, None if hess is None else jax_tree(hess))
        t_state = t_tx.step(t_params, g, t_state, hess)
        yield step, t_params, from_jax(p_j), t_state


def _flax_layout(model, name, value):
    transform = {n: t for n, _, t, _ in flax_leaves(model)}[name]
    if transform.perm is None:
        return value
    return np.ascontiguousarray(np.transpose(value, np.argsort(transform.perm)))


def random_grads(model, rng):
    """Normal(0, 0.1) gradients, one draw a leaf and step (the global norm
    about 25: clipping at 1 triggers)."""
    return {n: torch.from_numpy(rng.normal(0, 0.1, p.shape).astype(np.float32))
            for n, p in optim.named_params(model).items()}


def hessian_diagonals(model, rng):
    """AdaHessian's Hessian diagonals, ``|N(0, 1)| + 0.5``: the step divides
    by ``|h|`` (a conv kernel's averaged over its 4 x 4 block), and a block
    mean of signed draws near 0 would hand the two packages' means, rounded
    in other orders, to that division."""
    return {n: torch.from_numpy(np.asarray(np.abs(rng.normal(0, 1, p.shape)) + 0.5, np.float32))
            for n, p in optim.named_params(model).items()}


CASES = [(opt, {}) for opt in optim.OPTIMIZERS] + [
    ("lookahead_adamw", {}),
    ("lamb", {"head_lr_mult": 10.0, "grad_clip": 1.0}),
    ("lookahead_lion", {"head_lr_mult": 10.0, "grad_clip": 1.0}),
]


def channel_orthogonal_grads(model, rng):
    """Gradients orthogonal to the parameter in each output channel (torch
    rows) of every leaf of 2 or more dimensions: AdamP's and SGDP's channel
    projection fires in torch's layout."""
    out = {}
    for n, p in optim.named_params(model).items():
        g = rng.normal(0, 0.1, p.shape).astype(np.float32)
        if p.ndim > 1:
            rows, pr = g.reshape(p.shape[0], -1), p.detach().numpy().reshape(p.shape[0], -1)
            rows -= (rows * pr).sum(1, keepdims=True) / (pr * pr).sum(1, keepdims=True) * pr
        out[n] = torch.from_numpy(g)
    return out


def alternating_grads():
    """Channel-orthogonal gradients at even steps, random ones at odd: both
    of AdamP's and SGDP's branches."""
    step = iter(range(STEPS))

    def grads(model, rng):
        fn = channel_orthogonal_grads if next(step) % 2 == 0 else random_grads
        return fn(model, rng)

    return grads


@pytest.mark.parametrize("opt,kw", CASES, ids=[
    c[0] + ("-head-clip" if c[1] else "") for c in CASES])
def test_optimizers_match_the_jax_factory(opt, kw):
    """Every parameter after each of 7 steps, the port against the JAX
    factory on the same gradients (AdamP and SGDP in torch's layout, their
    projection firing at every other step); Adafactor factors the square
    and the non-square kernels and not the others."""
    scale = LR * kw.get("head_lr_mult", 1.0)
    torch_layout = opt in TORCH_LAYOUT
    grads_fn = alternating_grads() if torch_layout else random_grads
    for step, t_params, want, t_state in run_both(opt, kw, grads_fn, torch_layout):
        for name, p in t_params.items():
            np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=1e-5,
                                       atol=ATOL * scale, err_msg=f"{opt} step {step}: {name}")
    assert t_state["count"] == STEPS
    if opt == "adafactor":
        assert sorted(t_state["v_row"]) == ["intermediate.weight", "query.weight"]
        # torch's [160, 128]: the mean over the largest axis (160) is the row
        assert t_state["v_row"]["intermediate.weight"].shape == (128,)
        assert t_state["v_col"]["intermediate.weight"].shape == (160,)
    if opt.startswith("lookahead_"):
        assert t_state["inner"]["count"] == STEPS


@pytest.mark.parametrize("opt", TORCH_LAYOUT)
def test_adamp_and_sgdp_project_by_torch_output_channels(opt):
    """Gradients orthogonal to the parameter in each torch output channel
    (numpy, the projection's own test): the channel view fires in torch's
    layout, as the port takes it (and the zoo's case holds it against the
    JAX factory on torch's layout).  On flax's layout the JAX factory
    groups by the first axis of the flax leaf (a Dense kernel's input, a
    conv kernel's height), finds no channel match and falls back to the
    whole-layer projection (the reference-side divergence): after 3 steps
    its kernels differ from the port's."""
    model = ZooNet(0)
    grads = channel_orthogonal_grads(model, np.random.default_rng(3))

    def cos_max(g, p, rows):  # the projection's test on one view (adamp.py:28-40)
        g, p = g.reshape(rows, -1), p.reshape(rows, -1)
        cos = np.abs((g * p).sum(1)) / (np.linalg.norm(g, axis=1) + 1e-8) / (
            np.linalg.norm(p, axis=1) + 1e-8)
        return cos.max() / (0.1 / np.sqrt(p.shape[1]))  # < 1: the view fires

    for n, _, transform, p in flax_leaves(model):
        if p.ndim < 2 or n == "cls_token":  # [1, 1, 128]: one channel, the views agree
            continue
        t_p, t_g = p.detach().numpy(), grads[n].numpy()
        f_p, f_g = (np.transpose(a, np.argsort(transform.perm)) for a in (t_p, t_g))
        assert cos_max(t_g, t_p, t_p.shape[0]) < 1e-3, n  # torch channels: fires
        assert cos_max(f_g, f_p, f_p.shape[0]) > 1, n  # flax "channels": does not
        assert cos_max(f_g, f_p, 1) < 1e-3, n  # the whole layer: fires
    *_, (_, t_params, flax_want, _) = run_both(opt, {}, channel_orthogonal_grads, steps=3)
    moved = [n for n in ("query.weight", "intermediate.weight", "patch_embed.proj.weight")
             if not np.allclose(t_params[n].detach().numpy(), flax_want[n], rtol=1e-5,
                                atol=ATOL * LR)]
    assert moved == ["query.weight", "intermediate.weight", "patch_embed.proj.weight"]


def test_factored_dims_follow_optax():
    """Adafactor's choice of dimensions, the port's on torch shapes against
    optax's on the same shapes."""
    from optax._src.factorized import _factored_dims

    for shape in [(128, 128), (160, 128), (128, 160), (768, 3, 16, 16), (32, 128), (128,), (),
                  (1, 1, 128), (3129, 1536, 2)]:
        assert optim.factored_dims(shape) == _factored_dims(shape, True, 128), shape


def test_optimizer_refusals():
    model = ZooNet(0)
    params = optim.named_params(model)
    tx = optim.create_optimizer(model, "adahessian")
    with pytest.raises(ValueError, match="hess_diag"):
        tx.step(params, {n: torch.zeros_like(p) for n, p in params.items()}, tx.init(params))
    tx = optim.create_optimizer(model, "lion")
    with pytest.raises(ValueError, match="hess_diag"):
        tx.step(params, {n: torch.zeros_like(p) for n, p in params.items()}, tx.init(params),
                hess_diag={})
