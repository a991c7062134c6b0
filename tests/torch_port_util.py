"""Helpers shared by the PyTorch port's tests (``tests/test_torch_*.py``).

- :class:`JaxKey`: an ``rng.py`` key of the port that replays the JAX
  package's ``jax.random`` draws, so both packages see the same noise;
- tiny ALBEF and VLMo geometries and models built in both packages with
  the same weights (flax init -> ``load_jax_params``);
- layout helpers: the port's pixels are NCHW, the JAX package's NHWC;
- :func:`synth_cli_assets`: synthetic data and side tables for a CLI run.
"""

from __future__ import annotations

import dataclasses
import importlib.util
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
from vqattack_tpu_torch.checkpoint.convert import load_jax_params
from vqattack_tpu_torch.models.albef import AlbefPretrain, AlbefVQA
from vqattack_tpu_torch.models.bert import FusionBert
from vqattack_tpu_torch.models.vlmo import VLMo

WORDS = ["what", "color", "is", "the", "dog", "cat", "red", "blue", "hat",
         "a", "frisbee", "park"]


class JaxKey:
    """A port key whose draws are the JAX package's: ``split``/``fold_in``
    are ``jax.random``'s and ``uniform``/``randint`` call ``jax.random`` with
    the same arguments as the JAX code.  The port asks for image-shaped
    draws in NCHW; JAX draws them NHWC, so a 4-D request is drawn NHWC and
    transposed."""

    def __init__(self, key):
        self.key = key

    def split(self, n: int = 2):
        return [JaxKey(k) for k in jax.random.split(self.key, n)]

    def fold_in(self, data: int):
        return JaxKey(jax.random.fold_in(self.key, data))

    def uniform(self, shape, lo=0.0, hi=1.0, dtype=torch.float32):
        shape = tuple(shape)
        if len(shape) == 4:
            b, c, h, w = shape
            u = jax.random.uniform(self.key, (b, h, w, c), jnp.float32, minval=lo, maxval=hi)
            return torch.from_numpy(np.asarray(u).transpose(0, 3, 1, 2).copy())
        u = jax.random.uniform(self.key, shape, jnp.float32, minval=lo, maxval=hi)
        return torch.from_numpy(np.array(u))

    def randint(self, shape, lo, hi):
        return torch.from_numpy(np.array(jax.random.randint(self.key, tuple(shape), lo, hi))).long()


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


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tiny_models(jc, tc, seed: int = 0, victim: bool = True, mlm: bool = True):
    """(JAX modules, JAX params, port modules) for the surrogate and, when
    asked, the victim and the candidate MLM (``None`` otherwise), with the
    port's weights loaded from the JAX params."""
    size = jc.albef.vit.image_size
    px = jnp.zeros((1, size, size, 3))
    ids = jnp.ones((1, jc.attack.max_text_len), jnp.int32)
    mask = jnp.ones_like(ids)
    j_sur = JAlbefPretrain(jc.albef)
    p_sur = jax.jit(lambda k: j_sur.init(k, px, ids, mask, method=JAlbefPretrain.init_all))(
        jax.random.key(seed))
    t_sur = load_jax_params(AlbefPretrain(tc.albef), _host(p_sur)).eval()
    j_vic = p_vic = t_vic = j_mlm = p_mlm = t_mlm = None
    if victim:
        a_ids = jnp.ones((2, 4), jnp.int32)
        j_vic = JAlbefVQA(jc.albef)
        p_vic = jax.jit(lambda k: j_vic.init(k, px, ids, mask, a_ids, jnp.ones_like(a_ids), 2))(
            jax.random.key(seed + 3))
        t_vic = load_jax_params(AlbefVQA(tc.albef), _host(p_vic)).eval()
    if mlm:
        j_mlm, p_mlm, t_mlm = tiny_mlm(jc, tc, seed + 1)
    return (j_sur, j_vic, j_mlm), (p_sur, p_vic, p_mlm), (t_sur, t_vic, t_mlm)


def tiny_mlm(jc, tc, seed: int):
    """(JAX module, JAX params, port module) of the candidate-generation MLM:
    the tiny BERT as a text-only encoder with its MLM head."""
    ids = jnp.ones((1, jc.attack.max_text_len), jnp.int32)
    j_mlm = JFusionBert(dataclasses.replace(jc.albef.bert, fusion_layer=jc.albef.bert.num_layers),
                        with_mlm_head=True)
    p_mlm = jax.jit(lambda k: j_mlm.init(k, ids, jnp.ones_like(ids)))(jax.random.key(seed))
    t_mlm_cfg = dataclasses.replace(tc.albef.bert, fusion_layer=tc.albef.bert.num_layers)
    t_mlm = load_jax_params(FusionBert(t_mlm_cfg, with_mlm_head=True), _host(p_mlm)).eval()
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
    head.  ``init_all`` leaves the relative-position table at zeros; it is
    redrawn normal(0, 0.5) from ``seed`` so that the bias path adds
    something."""
    cfg = jc.vlmo
    px = jnp.zeros((1, cfg.image_size, cfg.image_size, 3))
    ids = jnp.ones((1, cfg.max_text_len), jnp.int32)
    j_model = JVLMo(cfg)
    params = _host(jax.jit(lambda k: j_model.init(k, ids, jnp.ones_like(ids), px,
                                                  method=JVLMo.init_all))(jax.random.key(seed)))
    table = params["params"]["relative_position_bias_table"]
    params["params"]["relative_position_bias_table"] = (
        np.random.default_rng(seed).normal(size=table.shape) * 0.5).astype(np.float32)
    t_model = load_jax_params(VLMo(tc.vlmo), params).eval()
    return j_model, params, t_model


ROOT = Path(__file__).resolve().parent.parent


def synth_cli_assets(tmp: Path, samples, image_size: int = 32) -> list:
    """The assets of scripts/make_synth_assets.py (its vocab and JPEG
    writers) for a CLI run over ``samples`` = ``[(qid, question, answer,
    paraphrase or None), ...]``, all on one image, plus a tiny RunConfig json
    at ``image_size``.  Returns the CLI arguments, ``--device cpu``
    included."""
    spec = importlib.util.spec_from_file_location("make_synth_assets",
                                                  ROOT / "scripts" / "make_synth_assets.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
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
