"""AdaHessian on the port (``train/adahessian.py``, ``train/trainer.py``'s
``needs_hessian`` step, ``train/cli.py --opt adahessian``) against the JAX
package's, with the JAX draws injected (``JaxKey``): the Hutchinson
diagonal exact for a diagonal Hessian, ``grad_and_hessian_diag`` on a
small conv + dense loss, the spatial average of a conv kernel, one
``needs_hessian`` step of ``albef_vqa`` and of ``vlmo_vqa`` against JAX
``make_train_step(needs_hessian=True)``, the CLI's ``--opt lamb`` and
``--opt adahessian`` against the JAX CLI's losses, and the CLI's routing
(no fused LayerNorm, no flash) under adahessian.

Tolerances: the gradient and Hessian-vector product of the small loss
rtol 1e-5 (atol 1e-6 of the largest entry); in the train steps the loss
rtol 1e-5, ``grad_norm`` rtol 1e-4 (``tests/test_torch_train.py``), the
Hessian diagonal (read from AdaHessian's second moment after one step,
``nu = 0.001 h**2``) and the gradient (from the first moment) within
1e-3 of each entry plus 1e-5 of the leaf's largest or 1e-6 of the model's,
whichever is larger (float32 double backward against JAX's
forward-over-reverse, sums in other orders; a key projection's bias has a
gradient and a Hessian of rounding noise, the softmax being blind to it),
and each parameter within what those errors move the step ``lr g / (|h| +
eps)`` (``step_tolerance``); the CLIs' losses rtol 1e-5.
"""

from __future__ import annotations

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from test_torch_train import _albef_task, _cli_assets
from torch_port_util import JaxKey, jax_params_of, nchw, port_layout
from vqattack_tpu.train import adahessian as jadahessian
from vqattack_tpu.train import optim as joptim
from vqattack_tpu.train import trainer as jtrainer
from vqattack_tpu_torch.ops.attention import attention_impl
from vqattack_tpu_torch.train import adahessian, cli, optim, trainer

T = torch.from_numpy


class _Small(nn.Module):
    """A patch conv and a head: the conv kernel's z is the one whose layout
    matters (torch OIHW, flax HWIO)."""

    def __init__(self):
        super().__init__()
        self.patch_embed = nn.Module()
        self.patch_embed.proj = nn.Conv2d(3, 4, 4, stride=4)
        self.head = nn.Linear(16, 5)
        self.unused = nn.Linear(2, 2)
        rng = np.random.default_rng(0)
        with torch.no_grad():
            for p in self.parameters():
                p.copy_(T(rng.normal(0, 0.3, p.shape).astype(np.float32)))


def test_hutchinson_is_exact_for_a_diagonal_hessian():
    """``sum(a w**2) + sum(b**3) + <c, head>``: ``z * H z`` is ``2a``, ``6b``
    and 0 exactly (``z**2`` is 1), whatever z; an unused leaf 0."""
    model = _Small()
    rng = np.random.default_rng(1)
    a = T(rng.uniform(0.5, 2.0, (4, 3, 4, 4)).astype(np.float32))
    c = T(rng.normal(size=(5, 16)).astype(np.float32))

    def loss(m):
        return ((a * m.patch_embed.proj.weight ** 2).sum()
                + (m.patch_embed.proj.bias ** 3).sum() + (c * m.head.weight).sum())

    from vqattack_tpu_torch.rng import TorchKey

    grad, diag = adahessian.grad_and_hessian_diag(loss, model, TorchKey(3, "cpu"))
    for n, d in adahessian.hutchinson_diag(loss, model, TorchKey(4, "cpu")).items():
        assert torch.equal(d, diag[n]), n  # whatever z
    w, b = model.patch_embed.proj.weight.detach(), model.patch_embed.proj.bias.detach()
    assert torch.equal(diag["patch_embed.proj.weight"], 2 * a)
    torch.testing.assert_close(diag["patch_embed.proj.bias"], 6 * b, rtol=1e-6, atol=0)
    for n in ("head.weight", "head.bias", "unused.weight", "unused.bias"):
        assert not diag[n].any(), n
    torch.testing.assert_close(grad["patch_embed.proj.weight"], 2 * a * w)
    torch.testing.assert_close(grad["head.weight"], c)
    assert not grad["unused.weight"].any()


def _jax_small_loss(p, x, t):
    """The same loss on flax's layout: NHWC pixels, HWIO kernel."""
    q = p["params"]
    y = jax.lax.conv_general_dilated(x, q["patch_embed"]["proj"]["kernel"], (4, 4), "VALID",
                                     dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y = jnp.tanh(y + q["patch_embed"]["proj"]["bias"]).reshape(x.shape[0], -1)
    z = y @ q["head"]["kernel"] + q["head"]["bias"]
    return jnp.sum(jax.nn.softplus(z) * t)


def _small_loss(m, x, t):
    y = torch.tanh(m.patch_embed.proj(x)).permute(0, 2, 3, 1).reshape(x.shape[0], -1)
    return (nn.functional.softplus(m.head(y)) * t).sum()


def test_grad_and_hessian_diag_matches_jax_with_its_draws():
    """Two draws (the second from ``key.fold_in(1)``), each leaf's z from
    its own key in the flax tree's order at the flax leaf's shape: the
    gradient and the averaged diagonal against the JAX package's; and
    threefry's bits do not depend on the shape asked for, so a leaf's flat
    draw is its shaped one, raveled."""
    key = jax.random.key(5)
    for shape in [(4, 4, 3, 4), (16, 5), (5,), ()]:
        np.testing.assert_array_equal(
            np.asarray(jax.random.rademacher(key, shape, dtype=jnp.float32)).ravel(),
            np.asarray(jax.random.rademacher(key, (int(np.prod(shape)),), dtype=jnp.float32)))
    model = _Small()
    rng = np.random.default_rng(2)
    x = rng.uniform(-1, 1, (2, 8, 8, 3)).astype(np.float32)
    t = rng.uniform(0, 1, (2, 5)).astype(np.float32)
    params = jax_params_of(model)
    j_grad, j_diag = jax.jit(lambda p, k: jadahessian.grad_and_hessian_diag(
        _jax_small_loss, p, k, x, t, n_samples=2))(params, key)
    grad, diag = adahessian.grad_and_hessian_diag(_small_loss, model, JaxKey(key),
                                                  T(nchw(x)), T(t), n_samples=2)
    for got, want in ((grad, port_layout(model, j_grad)), (diag, port_layout(model, j_diag))):
        for n, w in want.items():
            np.testing.assert_allclose(got[n].numpy(), w, rtol=1e-5,
                                       atol=1e-6 * np.abs(w).max() + 1e-12, err_msg=n)
    assert np.abs(want["patch_embed.proj.weight"]).max() > 0


def test_spatial_average_is_over_the_kernels_h_and_w():
    rng = np.random.default_rng(3)
    hwio = rng.normal(size=(4, 4, 3, 6)).astype(np.float32)
    want = np.asarray(jadahessian._spatial_average(jnp.asarray(hwio))).transpose(3, 2, 0, 1)
    np.testing.assert_allclose(adahessian.spatial_average(T(hwio.transpose(3, 2, 0, 1))).numpy(),
                               want, rtol=1e-6)
    vec = T(rng.normal(size=(5,)).astype(np.float32))
    assert adahessian.spatial_average(vec) is vec


def step_tolerance(lr, g, dg, h, dh, wd_p):
    """How far the first AdaHessian step ``-lr (g / (|h| + eps) + wd p)``
    can move when ``g`` is off by ``dg`` and ``|h|`` by ``dh``:
    ``lr (dg + |g| dh / (|h| + eps)) / (|h| - dh + eps)``, plus rounding.
    Where ``|h|`` is under eps (a key projection's bias: its gradient and
    Hessian are rounding noise), the step is ``lr g / eps``, and the
    gradient's own noise bounds it."""
    lo = np.maximum(np.abs(h) - dh, 0.0) + 1e-8
    step = lr * np.abs(g) / (np.abs(h) + 1e-8)
    return (lr * (dg + np.abs(g) * dh / (np.abs(h) + 1e-8)) / lo
            + 1e-5 * (step + lr * np.abs(wd_p)))


def check_hessian_step(model, before, t_opt_state, t_metrics, j_state, j_metrics, lr, wd):
    """One AdaHessian step of the port against the JAX package's from the
    same parameters (``before``, by port name): the loss, ``grad_norm``,
    the gradient and the Hessian diagonal (from the moments after one
    step: ``mu = 0.1 g``, ``nu = 0.001 h**2``) and every parameter."""
    np.testing.assert_allclose(float(t_metrics["loss"]), float(j_metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(t_metrics["grad_norm"]), float(j_metrics["grad_norm"]),
                               rtol=1e-4)
    inner = [s for s in jax.tree_util.tree_leaves(
        j_state.opt_state, is_leaf=lambda s: hasattr(s, "nu")) if hasattr(s, "nu")][0]
    g_all = {n: m / 0.1 for n, m in port_layout(model, inner.mu).items()}
    h_all = {n: np.sqrt(v / 0.001) for n, v in port_layout(model, inner.nu).items()}
    g_floor = 1e-6 * max(float(np.abs(g).max()) for g in g_all.values())
    h_floor = 1e-6 * max(float(h.max()) for h in h_all.values())
    decay = optim.decay_mask(model)
    want = port_layout(model, j_state.params)
    reached = 0
    for name, p in optim.named_params(model).items():
        g, h = g_all[name], h_all[name]
        got_g = t_opt_state["mu"][name].numpy() / 0.1
        got_h = np.sqrt(t_opt_state["nu"][name].numpy() / 0.001)
        dg = 1e-3 * np.abs(g) + max(1e-5 * float(np.abs(g).max()), g_floor)
        np.testing.assert_array_less(np.abs(got_g - g), dg + 1e-12, err_msg=name)
        dh = 1e-3 * h + max(1e-5 * float(h.max()), h_floor)
        np.testing.assert_array_less(np.abs(got_h - h), dh + 1e-12, err_msg=name)
        tol = step_tolerance(lr, g, dg, h, dh, wd * before[name] * decay[name])
        np.testing.assert_array_less(np.abs(p.detach().numpy() - want[name]),
                                     tol + 1e-6 * np.abs(want[name]) + 1e-12, err_msg=name)
        reached += bool(h.max() > h_floor)
    assert reached > len(g_all) // 2


def test_hessian_step_matches_jax():
    """One ``needs_hessian`` AdaHessian step of ``albef_vqa`` from the same
    parameters on the same batch as JAX ``make_train_step(needs_hessian=
    True)``, z from the JAX draws of the same key (``check_hessian_step``;
    ``vlmo_vqa``'s step: ``test_cli_opt_matches_the_jax_cli``)."""
    rng = np.random.default_rng(4)
    params, model, batch, jloss, tloss = _albef_task(rng)
    lr, wd = 1e-3, 0.02
    key = jax.random.key(7)
    tx = joptim.create_optimizer(params, "adahessian", lr, weight_decay=wd)
    j_step = jtrainer.make_train_step(jloss, tx, donate=False, needs_hessian=True)
    j_state, j_metrics = jax.jit(lambda p: j_step(jtrainer.create_train_state(p, tx), batch,
                                                  key))(params)
    t_batch = {k: T(nchw(v) if k == "pixels" else v) for k, v in batch.items()}
    for k in ("text_ids", "text_mask", "answer_ids", "answer_mask"):
        t_batch[k] = t_batch[k].long()
    before = {n: p.detach().numpy().copy() for n, p in optim.named_params(model).items()}
    t_tx = optim.create_optimizer(model, "adahessian", lr, weight_decay=wd)
    state = trainer.create_train_state(model, t_tx)
    state, metrics = trainer.make_train_step(tloss, t_tx, needs_hessian=True)(
        state, t_batch, JaxKey(key))
    check_hessian_step(model, before, state.opt_state, metrics, j_state, j_metrics, lr, wd)


def _run_both_clis(tmp_path, monkeypatch, task, opt):
    """``--opt opt`` through both CLIs for 2 steps on the same tiny config
    (two VLMo blocks) and images, the JAX model starting from the port
    CLI's weights, each train transform's ``random.Random`` seeded alike
    and the port's keys replaced by the JAX CLI's: (JAX losses, port
    summary)."""
    from test_torch_pretrain import _SeededRandom, _shallow
    from vqattack_tpu import config as jcfg
    from vqattack_tpu.models.vlmo import VLMo as JVLMo
    from vqattack_tpu.train import cli as jcli
    from vqattack_tpu.utils.meters import MetricLogger
    from vqattack_tpu_torch import config as tcfg
    from vqattack_tpu_torch.models.vlmo import VLMo, init_vlmo_weights

    argv = ["--task", task, *_cli_assets(tmp_path), "--steps", "2", "--log-every", "1",
            "--opt", opt, "--image-size", "32"]
    argv[argv.index("--config") + 1] = str(tmp_path / "shallow.json")
    vocab = tcfg.load_config(str(tmp_path / "cfg.json")).vlmo.vocab_size
    cfg = _shallow(tcfg.tiny_test_config(vocab_size=vocab))
    tcfg.save_config(cfg, str(tmp_path / "shallow.json"))
    jcfg.save_config(_shallow(jcfg.tiny_test_config(vocab_size=vocab)),
                     str(tmp_path / "jshallow.json"))
    variables = jax_params_of(init_vlmo_weights(VLMo(cfg.vlmo), 0))
    monkeypatch.setattr(JVLMo, "init", lambda self, *a, **kw: variables)
    monkeypatch.setattr(random, "Random", _SeededRandom)
    monkeypatch.setattr("vqattack_tpu.utils.cache.enable_compile_cache", lambda *a: None)
    j_losses = []
    update = MetricLogger.update

    def logged(self, **kw):
        if "loss" in kw:
            j_losses.append(kw["loss"])
        return update(self, **kw)

    monkeypatch.setattr(MetricLogger, "update", logged)
    steps = {"jax": [], "port": []}

    def recording(make, rec, snapshot):
        def make_step(*a, **kw):
            step = make(*a, **kw)

            def run(state, batch, key):
                before = snapshot(state)
                state, metrics = step(state, batch, key)
                rec.append((before, snapshot(state), state, metrics))
                return state, metrics

            return run

        return make_step

    def port_snapshot(state):
        return ({n: p.detach().clone() for n, p in optim.named_params(state.model).items()},
                {k: {n: t.clone() for n, t in v.items()} if isinstance(v, dict) else v
                 for k, v in state.opt_state.items()})

    monkeypatch.setattr(jtrainer, "make_train_step",
                        recording(jtrainer.make_train_step, steps["jax"], lambda s: None))
    monkeypatch.setattr(trainer, "make_train_step",
                        recording(trainer.make_train_step, steps["port"], port_snapshot))
    j_argv = [a for i, a in enumerate(argv) if "--device" not in (a, argv[i - 1])]
    j_argv[j_argv.index("--config") + 1] = str(tmp_path / "jshallow.json")
    jcli.main(j_argv)
    monkeypatch.setattr(MetricLogger, "update", update)
    monkeypatch.setattr("vqattack_tpu_torch.rng.TorchKey",
                        lambda seed, device: JaxKey(jax.random.key(seed)))
    return j_losses, cli.main(argv), steps


@pytest.mark.parametrize("opt", ["lamb", "adahessian"])
def test_cli_opt_matches_the_jax_cli(tmp_path, monkeypatch, opt):
    """``--task vlmo_vqa --opt {lamb, adahessian}``, 2 steps through both
    CLIs: both losses (the second follows the first step's update); under
    adahessian also the first step as ``check_hessian_step`` holds it
    against the JAX CLI's ``make_train_step(needs_hessian=True)``."""
    j_losses, summary, steps = _run_both_clis(tmp_path, monkeypatch, "vlmo_vqa", opt)
    assert len(j_losses) == len(summary["losses"]) == 2
    np.testing.assert_allclose(summary["losses"], j_losses, rtol=1e-5)
    assert summary["losses"][1] != summary["losses"][0]
    if opt == "adahessian":
        (_, _, j_state, j_metrics), (before, (_, t_opt), t_state, t_metrics) = (
            steps["jax"][0], steps["port"][0])
        model = t_state.model
        first = {n: t.numpy() for n, t in before[0].items()}
        after = steps["port"][0][1][0]
        with torch.no_grad():  # the parameters after the first step, in the model
            for n, p in optim.named_params(model).items():
                p.copy_(after[n])
        check_hessian_step(model, first, t_opt, t_metrics, j_state, j_metrics, 1e-4, 0.02)


def test_cli_routes_no_kernel_under_adahessian(tmp_path, capsys):
    """On a CUDA config the ALBEF tasks take the fused LayerNorm, but under
    ``--opt adahessian`` (printed on a line of its own); the CLI refuses
    adahessian under the flash backend, naming xla, and the factory
    ``lookahead_adahessian``."""
    argv = ["--task", "albef_vqa", *_cli_assets(tmp_path)]
    parser = cli.build_argparser()
    cuda = torch.device("cuda")
    assert cli.resolve_config(parser.parse_args(argv), None, cuda).albef.vit.fused_ln
    args = parser.parse_args(argv + ["--opt", "adahessian"])
    assert not cli.resolve_config(args, None, cuda).albef.vit.fused_ln
    lines = capsys.readouterr().out.splitlines()
    assert any(line.startswith("--opt adahessian: the ViT keeps the plain LayerNorm")
               for line in lines)
    for opt in ("adahessian", "lookahead_adamw", "nadam"):  # the CPU keeps the plain one
        args = parser.parse_args(argv + ["--opt", opt])
        assert not cli.resolve_config(args, None, torch.device("cpu")).albef.vit.fused_ln
    with attention_impl("flash"), pytest.raises(SystemExit, match="xla"):
        cli.main(argv + ["--opt", "adahessian", "--steps", "1"])
    with pytest.raises(ValueError, match="lookahead_adahessian"):
        cli.main(argv + ["--opt", "lookahead_adahessian", "--steps", "1"])


def test_kernel_wrappers_refuse_a_second_backward(monkeypatch):
    """K2's and K3's autograd wrappers with their launches replaced by the
    plain versions (the kernels run only on the card): the first backward
    gives the plain version's gradients, a backward that builds a graph
    (``create_graph=True``, as a Hessian-vector product takes it) raises
    where it would have handed back gradients blind to the inputs.  The
    card's own check: ``tests/test_torch_cuda.py``."""
    from vqattack_tpu_torch.ops import attention, fused_ln

    rng = np.random.default_rng(5)

    def t(*shape):
        return T(rng.normal(size=shape).astype(np.float32)).requires_grad_()

    monkeypatch.setattr(fused_ln, "residual_layernorm_fwd", fused_ln.residual_layernorm_reference)
    monkeypatch.setattr(fused_ln, "residual_layernorm_bwd",
                        fused_ln.residual_layernorm_bwd_reference)
    x, delta, gamma, beta = t(6, 16), t(6, 16), t(16), t(16)
    s, h = fused_ln._ResidualLayerNormFn.apply(x, delta, gamma, beta, 1e-6)
    s_ref, h_ref = fused_ln.residual_layernorm_reference(x, delta, gamma, beta, 1e-6)
    got = torch.autograd.grad((h ** 3).sum() + (s ** 2).sum(), [x, gamma], retain_graph=True)
    want = torch.autograd.grad((h_ref ** 3).sum() + (s_ref ** 2).sum(), [x, gamma])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad((h ** 3).sum(), [x, gamma], create_graph=True)

    def checked(q, k, v, bias, key_bias=None):
        return q.shape[0], q.shape[2], q.shape[1], k.shape[1]

    monkeypatch.setattr(attention, "_check_inputs", checked)
    monkeypatch.setattr(attention, "_launch_fwd", lambda q, k, v, bias, scale, key_bias, dims, dh:
                        attention.flash_attention_reference(q, k, v, bias, scale, True, key_bias))
    monkeypatch.setattr(
        attention, "_launch_bwd",
        lambda q, k, v, bias, scale, o, lse, do, key_bias, dims, dh, dbias=False:
        attention.flash_attention_bwd_reference(q, k, v, bias, scale, o, lse, do, key_bias, dbias))
    q, k, v = t(2, 5, 2, 8), t(2, 7, 2, 8), t(2, 7, 2, 8)
    o = attention._FlashAttentionFn.apply(q, k, v, None, 0.35, None)
    o_ref = attention.flash_attention_reference(q, k, v, None, 0.35)
    got = torch.autograd.grad((o ** 3).sum(), [q, k, v], retain_graph=True)
    want = torch.autograd.grad((o_ref ** 3).sum(), [q, k, v])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    with pytest.raises(RuntimeError, match="no second derivative"):
        torch.autograd.grad((o ** 3).sum(), [q, k, v], create_graph=True)
