"""Tensor parallelism over the port's ``model`` axis (``parallel/tensor.py``,
``parallel/mesh.py``): the data x model grid and its refusals; the cut set
of ``shard_params`` against the leaves that the JAX ``shard_params`` gives
``P(None, "model")`` on the tiny ALBEF and VLMo trees; the cut layers
against the uncut ones; the tiny ALBEF alternating attack on data 4 x
model 2 and the VLMo feature attack on data 2 x model 2 against the
unsharded port and the JAX engine on its data x model mesh; and
``batched_attack_step`` on data 2 x model 2 against ``pgd_feature``."""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_torch_parallel import (ALBEF_QUESTIONS, VLMO_QUESTIONS, WORDS, _assert_same, _port,
                                 _samples, albef)  # noqa: F401 (albef: the fixture)
from torch_port_util import JaxKey, tiny_configs, tiny_models, tiny_vlmo, tiny_vlmo_configs
from vqattack_tpu.attacks.batched import BatchedAlbefAttack as JAlbefBatched
from vqattack_tpu.attacks.batched import BatchedVlmoAttack as JVlmoBatched
from vqattack_tpu.attacks.vlmo_orchestrator import VlmoAttackPipeline as JVlmoPipeline
from vqattack_tpu.parallel.mesh import make_mesh as jmake_mesh
from vqattack_tpu.parallel.mesh import shard_params as jshard_params
from vqattack_tpu.text.similarity import NullGate as JNullGate
from vqattack_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from vqattack_tpu_torch.attacks.batched import BatchedAlbefAttack, BatchedVlmoAttack
from vqattack_tpu_torch.attacks.pgd import pgd_feature
from vqattack_tpu_torch.attacks.vlmo_orchestrator import VlmoAttackPipeline
from vqattack_tpu_torch.checkpoint.convert import flax_leaves
from vqattack_tpu_torch.models.layers import Embedding, Linear
from vqattack_tpu_torch.models.vlmo import VLMo, init_vlmo_weights
from vqattack_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS, batched_attack_step, make_mesh,
                                         shard_params)
from vqattack_tpu_torch.parallel.tensor import (ColumnEmbedding, ColumnLinear, ColumnParameter,
                                                column_cuts, cut_layer)
from vqattack_tpu_torch.rng import TorchKey
from vqattack_tpu_torch.text.similarity import NullGate
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer

CPU8 = ["cpu"] * 8
ROW = [torch.device("cpu")] * 2
# the cut layers against the uncut ones: float32 to 1e-6, bf16 to one bf16
# ulp of the values (2^-8 relative): each output column is the same product
# of the same operands.  A cut Linear's input gradient is the sum of its
# pieces' partial products, each rounded to bf16 where the uncut product
# rounds once: in bf16 it is held to 2^-7 of the gradient's largest value.
LAYER_TOL = {torch.float32: dict(rtol=1e-6, atol=1e-6),
             torch.bfloat16: dict(rtol=2 ** -8, atol=2 ** -8)}


# ------------------------------------------------------------------ the grid


def test_grid_rows_and_refusals():
    """Rows are the device list cut in order (JAX's ``reshape(n // mp,
    mp)``); the data axis is each row's first device; each refusal names
    both numbers."""
    devices = [torch.device("cpu", i) for i in range(8)]
    mesh = make_mesh(8, model_parallelism=2, devices=devices)
    assert mesh.shape == {DATA_AXIS: 4, MODEL_AXIS: 2}
    assert mesh.rows == tuple(tuple(devices[i : i + 2]) for i in range(0, 8, 2))
    assert mesh.devices == tuple(devices[::2])
    assert make_mesh(6, model_parallelism=3, devices=devices).shape == {DATA_AXIS: 2,
                                                                        MODEL_AXIS: 3}
    j = jmake_mesh(8, model_parallelism=2)
    assert mesh.shape == dict(j.shape)
    with pytest.raises(ValueError, match="6 devices .* model_parallelism=4"):
        make_mesh(6, model_parallelism=4, devices=devices)
    with pytest.raises(ValueError, match="model_parallelism=0 for n_devices=4"):
        make_mesh(4, model_parallelism=0, devices=devices)
    with pytest.raises(ValueError, match="9 devices asked for, 8 given"):
        make_mesh(9, model_parallelism=3, devices=devices)


# ------------------------------------------------------- the cut set vs JAX


def _jax_cut_paths(params) -> dict:
    """``{flax path: shard shape}`` of every leaf that the JAX
    ``shard_params`` places as ``P(None, "model")`` on the 8-device data 4
    x model 2 mesh."""
    placed = jshard_params(params, jmake_mesh(8, model_parallelism=2))
    out = {}
    for path, x in jax.tree_util.tree_flatten_with_path(placed)[0]:
        if x.sharding.spec == P(None, MODEL_AXIS):
            keys = tuple(getattr(p, "key", p) for p in path)
            out[keys[1:] if keys[0] == "params" else keys] = x.sharding.shard_shape(x.shape)
    return out


def _assert_cut_like_jax(model, params):
    """The port cuts exactly JAX's paths, a piece the shape of JAX's shard;
    the pieces concatenate back to the source bit for bit, each on its row's
    device, and every parameter left whole sits on the row's first
    device."""
    want = _jax_cut_paths(params)
    leaves = {name: (path, transform) for name, path, transform, _ in flax_leaves(model)}
    cuts = column_cuts(model, 2)
    assert {leaves[n][0] for n in cuts} == set(want)
    mesh = make_mesh(8, model_parallelism=2, devices=CPU8)
    replicas = shard_params(model, mesh)
    assert len(replicas) == 4
    for row, rep in zip(mesh.rows, replicas):
        for name, dim in cuts.items():
            cut = cut_layer(rep, name)
            assert isinstance(cut, (ColumnLinear, ColumnEmbedding, ColumnParameter))
            pieces = list(cut.pieces)
            assert [p.device for p in pieces] == list(row)
            path, transform = leaves[name]
            assert all(transform.flax_shape(p.shape) == want[path] for p in pieces)
            assert torch.equal(torch.cat([p.detach() for p in pieces], dim),
                               model.get_parameter(name))
        whole = {n for n in dict(model.named_parameters()) if n not in cuts}
        got = dict(rep.named_parameters())
        for name in whole:
            assert got[name].device == row[0] and torch.equal(got[name],
                                                              model.get_parameter(name))
        for name, buf in rep.named_buffers():
            assert buf.device == row[0]


def test_cut_set_equals_jax_albef():
    """The tiny ``AlbefPretrain`` tree (leaf for leaf its ``init_all``'s,
    ``tests/test_torch_models.py``)."""
    tok = WordPieceTokenizer.toy(WORDS)
    jc, tc = tiny_configs(tok.vocab_size)
    _, (p_sur, _, _), (t_sur, _, _) = tiny_models(jc, tc, victim=False, mlm=False)
    _assert_cut_like_jax(t_sur, p_sur)


def test_cut_set_equals_jax_vlmo():
    """VLMo's ``init_all`` tree (leaf for leaf, ``tests/test_torch_tasks.py``):
    both experts, the ITC and VQA heads, and the relative-position table
    ``[num_rel, heads x depth]``, cut too."""
    tok = WordPieceTokenizer.toy(WORDS)
    jc, tc = tiny_vlmo_configs(tok.vocab_size, depth=2)
    _, j_params, t_model = tiny_vlmo(jc, tc)
    assert "relative_position_bias_table" in column_cuts(t_model, 2)
    _assert_cut_like_jax(t_model, j_params)


# ------------------------------------------------------------ the cut layers


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cut_layers_equal_uncut(dtype):
    """Each cut layer's forward, its input's gradient and its parameters'
    gradients (the pieces' concatenated) against the uncut layer's, in the
    layer's compute dtype."""
    torch.manual_seed(0)
    tol = LAYER_TOL[dtype]
    lin = Linear(16, 32, compute_dtype=dtype)
    x = torch.randn(2, 5, 16, requires_grad=True)
    ct = torch.randn(2, 5, 32).to(dtype)
    cut = ColumnLinear(lin, ROW)
    y_cut = cut(x)
    grads_cut = torch.autograd.grad(y_cut, (x, *cut.pieces, cut.bias), ct)
    y = lin(x)
    grads = torch.autograd.grad(y, (x, lin.weight, lin.bias), ct)
    assert y_cut.dtype == y.dtype == dtype
    torch.testing.assert_close(y_cut, y, **tol)
    gx_tol = tol if dtype == torch.float32 else dict(
        rtol=0, atol=2 ** -7 * float(grads[0].abs().max()))
    torch.testing.assert_close(grads_cut[0], grads[0], **gx_tol)
    torch.testing.assert_close(torch.cat(grads_cut[1:3]), grads[1], **tol)
    torch.testing.assert_close(grads_cut[3], grads[2], **tol)

    emb = Embedding(20, 32, compute_dtype=dtype)
    ids = torch.randint(0, 20, (2, 5))
    cut = ColumnEmbedding(emb, ROW)
    y_cut, y = cut(ids), emb(ids)
    assert y_cut.dtype == y.dtype == dtype
    torch.testing.assert_close(y_cut, y, **tol)
    g_cut = torch.autograd.grad(y_cut, tuple(cut.pieces), ct)
    (g,) = torch.autograd.grad(y, (emb.weight,), ct)
    torch.testing.assert_close(torch.cat(g_cut, 1), g, **tol)

    table = torch.nn.Parameter(torch.randn(13, 8))
    cut = ColumnParameter(table, ROW)
    idx = torch.randint(0, 13, (5, 5))
    y_cut, y = cut[:, 2:6][idx].to(dtype), table[:, 2:6][idx].to(dtype)
    assert torch.equal(y_cut, y)
    ct = torch.randn(5, 5, 4).to(dtype)
    g_cut = torch.autograd.grad(y_cut, tuple(cut.pieces), ct)
    (g,) = torch.autograd.grad(y, (table,), ct)
    assert torch.equal(torch.cat(g_cut, 1), g)


# ---------------------------------------------------- the engines on the grid


def test_albef_alternating_on_data4_model2_equals_unsharded_and_jax(albef):
    """8 MAR samples at batch 8, one block of 3 alternating steps: the port
    on data 4 x model 2 of ``[cpu] * 8`` against the unsharded port and the
    JAX engine on ``jmake_mesh(8, model_parallelism=2)``, on the JAX draws,
    to ``tests/test_parallel.py``'s tolerances."""
    _, jp, tp = albef
    samples = _samples(8, ALBEF_QUESTIONS)
    key = jax.random.key(11)
    mesh = make_mesh(8, model_parallelism=2, devices=CPU8)
    engine = BatchedAlbefAttack(tp, mesh=mesh)
    assert len(engine._replicas) == 4
    assert all(isinstance(v.surrogate.visual_encoder.blocks[0].attn.query, ColumnLinear)
               for v, _ in engine._replicas)
    sharded = engine.run(_port(samples), batch_size=8, rng=JaxKey(key))
    assert engine.last_chunk_sizes == [8]
    assert all(r.old_alg == 0 and r.num_blocks == 1 and len(r.mlm_losses) == 3
               for r in sharded)
    _assert_same(sharded, BatchedAlbefAttack(tp).run(_port(samples), batch_size=8,
                                                     rng=JaxKey(key)))
    j = JAlbefBatched(jp, mesh=jmake_mesh(8, model_parallelism=2)).run(samples, batch_size=8,
                                                                        rng=key)
    _assert_same(sharded, j, port_vs_jax=True)


def test_vlmo_feature_on_data2_model2_equals_unsharded_and_jax():
    """The tiny VLMo (a split block, then the VL expert), 8 feature-only
    samples in one block of 6 steps: each replica's relative-position
    biases from its gathered table; against the unsharded port and the JAX
    engine on ``jmake_mesh(4, model_parallelism=2)``, on the JAX draws."""
    j_tok, t_tok = JTokenizer.toy(WORDS), WordPieceTokenizer.toy(WORDS)
    jc, tc = tiny_vlmo_configs(t_tok.vocab_size, depth=2, num_iters=6, dynamic_pgd=True,
                               fused_block=False)
    j_model, j_params, t_model = tiny_vlmo(jc, tc, seed=0)
    ids = {0: "red"}
    jp = JVlmoPipeline(jc, j_model, j_params, j_params, j_tok, JNullGate(), id2answer=ids)
    tp = VlmoAttackPipeline(tc, t_model, t_tok, NullGate(), id2answer=ids, device="cpu")
    samples = [dict(s, paraphrase=None, target_answer=None)
               for s in _samples(8, VLMO_QUESTIONS, seed=2)]
    key = jax.random.key(13)
    engine = BatchedVlmoAttack(tp, mesh=make_mesh(4, model_parallelism=2, devices=CPU8))
    views = [v for v, _ in engine._replicas]
    assert len(views) == 2
    assert all(isinstance(v.model.relative_position_bias_table, ColumnParameter) and
               torch.equal(v._rel_biases, tp._rel_biases) for v in views)
    sharded = engine.run(_port(samples), batch_size=8, rng=JaxKey(key))
    assert all(r.old_alg == 1 and r.num_blocks == 1 and len(r.feat_losses) == 6
               for r in sharded)
    _assert_same(sharded, BatchedVlmoAttack(tp).run(_port(samples), batch_size=8,
                                                    rng=JaxKey(key)))
    j = JVlmoBatched(jp, mesh=jmake_mesh(4, model_parallelism=2)).run(samples, batch_size=8,
                                                                       rng=key)
    _assert_same(sharded, j, port_vs_jax=True)


@pytest.mark.parametrize("family", ["albef", "vlmo"])
def test_batched_attack_step_on_data2_model2_equals_pgd_feature(albef, family):
    """``batched_attack_step`` with the feature loss of each cut replica on
    data 2 x model 2, a rand-init start: the unsharded ``pgd_feature``'s
    images and losses.  VLMo's aux carries the relative-position biases,
    which each shard takes whole."""
    rng = np.random.default_rng(3)
    b = 8
    x = torch.as_tensor(rng.uniform(-1, 1, (b, 3, 32, 32)), dtype=torch.float32)
    if family == "albef":
        tp = albef[2]
        source, s = tp.surrogate, tp.cfg.attack.max_text_len
    else:
        tok = WordPieceTokenizer.toy(WORDS)
        _, tc = tiny_vlmo_configs(tok.vocab_size, depth=2)
        model = init_vlmo_weights(VLMo(tc.vlmo), 0).eval()
        tp = VlmoAttackPipeline(tc, model, tok, NullGate(), device="cpu")
        source, s = tp.model, tp.max_text_len
    ids = torch.as_tensor(rng.integers(4, 12, (b, s))).long()
    ids[:, 0] = 2
    mask = torch.ones_like(ids)
    aux = {"text_ids": ids, "text_mask": mask, "ori_ids": ids, "ori_mask": mask}
    if family == "albef":
        aux.update(txt_token_mask=mask.float(), special_ids=tp._special)
    else:
        aux["rel_biases"] = tp._rel_biases
    aux.update(tp._targets_fn(x, TorchKey(1, "cpu"), aux))
    mesh = make_mesh(4, model_parallelism=2, devices=CPU8)
    views = [tp.replica(m, d) for d, m in zip(mesh.devices, shard_params(source, mesh))]
    kw = dict(eps=0.125, eps_iter=0.01, nb_iter=3, rand_init=True)
    adv1, l1 = pgd_feature(tp._feature_loss, x, x, TorchKey(2, "cpu"), aux, **kw)
    adv2, l2 = batched_attack_step([v._feature_loss for v in views], x, x, TorchKey(2, "cpu"),
                                   aux, mesh, **kw)
    np.testing.assert_allclose(adv2.numpy(), adv1.numpy(), atol=2e-6)
    np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=2e-4, atol=1e-5)
