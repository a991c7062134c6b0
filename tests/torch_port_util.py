"""Helpers shared by the PyTorch port's tests (``tests/test_torch_*.py``).

- :class:`JaxKey`: an ``rng.py`` key of the port that replays the JAX
  package's ``jax.random`` draws, so both packages see the same noise;
- tiny ALBEF and VLMo geometries and models built in both packages with
  the same weights (the port's random weights -> flax variables);
- layout helpers: the port's pixels are NCHW, the JAX package's NHWC;
- :func:`synth_cli_assets`: synthetic data and side tables for a CLI run.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import itertools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vqattack_tpu import config as jcfg
from vqattack_tpu.models.albef import AlbefPretrain as JAlbefPretrain
from vqattack_tpu.models.albef import AlbefVQA as JAlbefVQA
from vqattack_tpu.models.bert import FusionBert as JFusionBert
from vqattack_tpu.models.vlmo import VLMo as JVLMo
from vqattack_tpu_torch import config as tcfg
from vqattack_tpu_torch.checkpoint.convert import flax_leaves
from vqattack_tpu_torch.models.albef import AlbefPretrain, AlbefVQA, init_weights
from vqattack_tpu_torch.models.bert import FusionBert
from vqattack_tpu_torch.models.vlmo import VLMo, init_vlmo_weights

# One intra-op thread for torch: the tests' tensors are tiny, and torch's
# OpenMP team, sharing the cores with JAX's threads (and under xdist with
# the other workers), can cost a millisecond an op, a hundred times the op:
# test_torch_dtype.py's drift budget took 1.3 s in one serial run and 256 s
# in another with the default team.
torch.set_num_threads(1)

WORDS = ["what", "color", "is", "the", "dog", "cat", "red", "blue", "hat",
         "a", "frisbee", "park"]


class JaxKey:
    """A port key whose draws are the JAX package's: ``split``/``fold_in``
    are ``jax.random``'s and ``uniform``/``randint``/``rademacher`` call
    ``jax.random`` with the same arguments as the JAX code.  The port asks
    for image-shaped draws in NCHW; JAX draws them NHWC, so a 4-D request
    is drawn NHWC and transposed; ``categorical`` draws from the logits it
    is given, as the JAX loss draws from its own."""

    def __init__(self, key):
        self.key = key

    def split(self, n: int = 2):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, data: int):
        return JaxKey(jax.random.fold_in(self.key, data))

    def _draw(self, shape, draw):
        """``draw(key, shape)``; a 4-D (NCHW) request drawn NHWC."""
        shape = tuple(shape)
        if len(shape) == 4:
            b, c, h, w = shape
            return torch.from_numpy(
                np.asarray(draw(self.key, (b, h, w, c))).transpose(0, 3, 1, 2).copy())
        return torch.from_numpy(np.array(draw(self.key, shape)))

    def uniform(self, shape, lo=0.0, hi=1.0, dtype=torch.float32):
        return self._draw(shape, lambda k, s: jax.random.uniform(k, s, jnp.float32,
                                                                 minval=lo, maxval=hi))

    def rademacher(self, shape, dtype=torch.float32):
        return self._draw(shape, lambda k, s: jax.random.rademacher(k, s, dtype=jnp.float32))

    def randint(self, shape, lo, hi):
        return torch.from_numpy(np.array(jax.random.randint(self.key, tuple(shape), lo, hi))).long()

    def categorical(self, logits):
        """``jax.random.categorical`` over the last axis of ``logits``."""
        out = jax.random.categorical(self.key, jnp.asarray(logits.detach().cpu().numpy()), axis=-1)
        return torch.from_numpy(np.array(out)).long().to(logits.device)


def fixed_topk(tok, candidates):
    """A candidate MLM's ``mlm_topk_fn(ids, mask) -> (scores, ids)`` that
    proposes ``candidates[word]`` (scores 1.0, 0.9, ...) at each occurrence
    of ``word`` and nothing elsewhere, the same for both packages."""
    table = {tok.vocab[w]: [tok.vocab[c] for c in cs] for w, cs in candidates.items()}

    def topk(ids, mask):
        ids = np.asarray(ids)
        scores = np.zeros(ids.shape + (5,), np.float32)
        out = np.zeros(ids.shape + (5,), np.int64)
        for pos in np.ndindex(*ids.shape):
            for r, c in enumerate(table.get(int(ids[pos]), [])):
                scores[pos + (r,)], out[pos + (r,)] = 1.0 - 0.1 * r, c
        return scores, out

    return topk


def nhwc(x) -> np.ndarray:
    return np.asarray(x).transpose(0, 2, 3, 1)


def nchw(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2))


def tiny_configs(vocab_size: int, fused_ln: bool = False, **attack_kw):
    """The same tiny RunConfig in both packages (``tiny_test_config`` with
    the toy vocab and, optionally, the fused residual+LayerNorm trunk)."""
    out = []
    for mod in (jcfg, tcfg):
        c = mod.tiny_test_config()
        bert = dataclasses.replace(c.albef.bert, vocab_size=vocab_size)
        vit = dataclasses.replace(c.albef.vit, fused_ln=fused_ln)
        albef = dataclasses.replace(c.albef, bert=bert, vit=vit)
        out.append(dataclasses.replace(c, albef=albef,
                                       attack=dataclasses.replace(c.attack, **attack_kw)))
    return out


def shallow_albef(cfg):
    """``cfg`` with ALBEF's text side cut to one text and one fusion layer
    and a one-layer answer decoder: the JAX programs' compiles scale with
    depth.  The ViT keeps its two blocks, so that the fused residual that
    one block hands the next (``models/vit.py``) is still compared."""
    bert = dataclasses.replace(cfg.albef.bert, num_layers=2, fusion_layer=1)
    return dataclasses.replace(cfg, albef=dataclasses.replace(cfg.albef, bert=bert,
                                                              decoder_layers=1))


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jit_apply(module, variables, *args, method=None, **kw):
    """``module.apply(variables, *args, method=method, **kw)`` compiled as
    one program: eager, flax dispatches and compiles every primitive on its
    own, seconds for a tiny model.  Array arguments are traced; the others
    (``None``, ints such as a top-k) and ``kw`` are fixed.  The program is
    kept for the next call with the same module, method and fixed values."""
    traced = tuple(isinstance(a, (np.ndarray, jax.Array)) for a in args)
    fixed = tuple(None if t else a for t, a in zip(traced, args))
    fn = _jitted_apply(module, method, traced, fixed, tuple(sorted(kw.items())))
    return fn(variables, *[a for t, a in zip(traced, args) if t])


@functools.lru_cache(maxsize=None)
def _jitted_apply(module, method, traced, fixed, kw):
    def apply(v, *xs):
        xs = iter(xs)
        full = [next(xs) if t else a for t, a in zip(traced, fixed)]
        return module.apply(v, *full, method=method, **dict(kw))

    return jax.jit(apply)


def _untransform(transform, value: np.ndarray) -> np.ndarray:
    """The flax leaf whose ``transform`` (a transpose, ``flax_leaves``) is
    ``value``: the leaf's shape is the permutation of ``value``'s that the
    transform maps onto it, and each element goes back to the place the
    transform took it from."""
    if value.ndim < 2:
        return value.copy()
    shapes = {s for s in itertools.permutations(value.shape)
              if transform(np.empty(s)).shape == value.shape}
    assert len(shapes) == 1, (value.shape, shapes)
    (shape,) = shapes
    index = transform(np.arange(value.size).reshape(shape))
    leaf = np.empty(value.size, value.dtype)
    leaf[index.ravel()] = value.ravel()
    return leaf.reshape(shape)


def jax_params_of(module) -> dict:
    """The flax ``variables`` (numpy leaves) that ``load_jax_params`` would
    load into ``module`` as its current parameters: the port's weights for
    the JAX module, so that no flax initialisation compiles (a tiny
    model's ``init`` costs seconds of XLA compile, in every test process)."""
    tree: dict = {}
    for _, path, transform, param in flax_leaves(module):
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = _untransform(transform, param.detach().cpu().numpy())
    return {"params": tree}


def init_tree_shapes(j_module, *args, method=None) -> dict:
    """``{path: shape}`` of every leaf of ``j_module.init(key, *args,
    method=method)``, traced by ``jax.eval_shape`` (nothing compiles)."""
    tree = jax.eval_shape(lambda k: j_module.init(k, *args, method=method), jax.random.key(0))
    return {tuple(getattr(p, "key", p) for p in path): tuple(leaf.shape)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def assert_same_tree(variables, shapes: dict) -> None:
    """``variables`` holds exactly the leaves of ``shapes`` (an
    :func:`init_tree_shapes`), each of its shape: the port's weights cover
    the flax module's ``init``, leaf for leaf."""
    got = {tuple(getattr(p, "key", p) for p in path): tuple(np.shape(leaf))
           for path, leaf in jax.tree_util.tree_flatten_with_path(variables)[0]}
    assert got.keys() == shapes.keys(), (sorted(got.keys() ^ shapes.keys()))
    assert got == shapes, [k for k in got if got[k] != shapes[k]]


def _drawn(module, seed: int):
    """(flax variables, the port module) with the port's random weights
    from ``seed`` (``init_weights``: the JAX package's initialiser scales)."""
    module = init_weights(module, seed).eval()
    return jax_params_of(module), module


def tiny_models(jc, tc, seed: int = 0, victim: bool = True, mlm: bool = True):
    """(JAX modules, JAX params, port modules) for the surrogate and, when
    asked, the victim and the candidate MLM (``None`` otherwise), with the
    same weights: the port's, drawn from ``seed``, as flax variables."""
    j_sur = JAlbefPretrain(jc.albef)
    p_sur, t_sur = _drawn(AlbefPretrain(tc.albef), seed)
    j_vic = p_vic = t_vic = j_mlm = p_mlm = t_mlm = None
    if victim:
        j_vic = JAlbefVQA(jc.albef)
        p_vic, t_vic = _drawn(AlbefVQA(tc.albef), seed + 3)
    if mlm:
        j_mlm, p_mlm, t_mlm = tiny_mlm(jc, tc, seed + 1)
    return (j_sur, j_vic, j_mlm), (p_sur, p_vic, p_mlm), (t_sur, t_vic, t_mlm)


def tiny_mlm(jc, tc, seed: int):
    """(JAX module, JAX params, port module) of the candidate-generation MLM:
    the tiny BERT as a text-only encoder with its MLM head."""
    j_mlm = JFusionBert(dataclasses.replace(jc.albef.bert, fusion_layer=jc.albef.bert.num_layers),
                        with_mlm_head=True)
    t_mlm_cfg = dataclasses.replace(tc.albef.bert, fusion_layer=tc.albef.bert.num_layers)
    p_mlm, t_mlm = _drawn(FusionBert(t_mlm_cfg, with_mlm_head=True), seed)
    return j_mlm, p_mlm, t_mlm


def tiny_vlmo_configs(vocab_size: int, depth: int = 4, **attack_kw):
    """The same tiny RunConfig in both packages, with the toy vocab in the
    VLMo and BERT geometries: ``depth`` VLMo blocks (4 by default), the VL
    expert in the last."""
    return [dataclasses.replace(c, vlmo=dataclasses.replace(
                c.vlmo, vocab_size=vocab_size, depth=depth, vlffn_start_layer=depth - 1))
            for c in tiny_configs(vocab_size, **attack_kw)]


def tiny_vlmo(jc, tc, seed: int = 0):
    """(JAX module, JAX params, port module) of the tiny VLMo with the VQA
    head, with the port's random weights from ``seed``
    (``init_vlmo_weights``: the relative-position table normal(0, 0.5), so
    that the bias path adds something)."""
    t_model = init_vlmo_weights(VLMo(tc.vlmo), seed).eval()
    return JVLMo(jc.vlmo), jax_params_of(t_model), t_model


ROOT = Path(__file__).resolve().parent.parent


def synth_assets_module():
    """``scripts/make_synth_assets.py`` (its vocab and image writers)."""
    spec = importlib.util.spec_from_file_location("make_synth_assets",
                                                  ROOT / "scripts" / "make_synth_assets.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    return synth


def synth_cli_assets(tmp: Path, samples, image_size: int = 32) -> list:
    """The assets of scripts/make_synth_assets.py (its vocab and JPEG
    writers) for a CLI run over ``samples`` = ``[(qid, question, answer,
    paraphrase or None), ...]``, all on one image, plus a tiny RunConfig json
    at ``image_size``.  Returns the CLI arguments, ``--device cpu``
    included."""
    synth = synth_assets_module()
    synth.make_vocab(str(tmp / "vocab.txt"))
    synth.make_image(str(tmp / "img0.jpg"), size=image_size + 8)
    files = {
        "ann.json": [{"image": "img0.jpg", "question": q, "question_id": qid,
                      "answer": [ans] * 10} for qid, q, ans, _ in samples],
        "answers.json": ["red", "blue", "green", "dog"],
        "sur.json": {str(qid): ans for qid, _, ans, _ in samples},
        "tgt.json": {str(qid): ans for qid, _, ans, _ in samples},
        "para.json": {str(qid): [ans, para] for qid, _, ans, para in samples if para},
        "allc.json": {str(qid): [ans] for qid, _, ans, _ in samples},
    }
    for name, obj in files.items():
        (tmp / name).write_text(json.dumps(obj))
    (tmp / "right.txt").write_text("".join(f"{qid}\n" for qid, *_ in samples))
    cfg = tcfg.tiny_test_config(image_size=image_size, vocab_size=30522)
    cfg = dataclasses.replace(cfg, attack=dataclasses.replace(cfg.attack, max_text_len=12),
                              k_test=3)
    tcfg.save_config(cfg, str(tmp / "cfg.json"))
    return ["--config", str(tmp / "cfg.json"), "--vocab", str(tmp / "vocab.txt"),
            "--ann", str(tmp / "ann.json"), "--image-root", str(tmp),
            "--answer-list", str(tmp / "answers.json"), "--right-part", str(tmp / "right.txt"),
            "--surrogate-ans", str(tmp / "sur.json"), "--target-ans", str(tmp / "tgt.json"),
            "--paraphrases", str(tmp / "para.json"), "--all-correct", str(tmp / "allc.json"),
            "--output", str(tmp / "out"), "--device", "cpu"]
