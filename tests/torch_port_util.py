"""Helpers shared by the PyTorch port's tests (``tests/test_torch_*.py``).

- :class:`JaxKey`: an ``rng.py`` key of the port that replays the JAX
  package's ``jax.random`` draws, so both packages see the same noise;
- tiny ALBEF geometry and models built in both packages with the same
  weights (flax init -> ``load_jax_params``);
- layout helpers: the port's pixels are NCHW, the JAX package's NHWC.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from vqattack_tpu import config as jcfg
from vqattack_tpu.models.albef import AlbefPretrain as JAlbefPretrain
from vqattack_tpu.models.albef import AlbefVQA as JAlbefVQA
from vqattack_tpu.models.bert import FusionBert as JFusionBert
from vqattack_tpu_torch import config as tcfg
from vqattack_tpu_torch.checkpoint.convert import load_jax_params
from vqattack_tpu_torch.models.albef import AlbefPretrain, AlbefVQA
from vqattack_tpu_torch.models.bert import FusionBert

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
        j_mlm = JFusionBert(dataclasses.replace(jc.albef.bert, fusion_layer=jc.albef.bert.num_layers),
                            with_mlm_head=True)
        p_mlm = jax.jit(lambda k: j_mlm.init(k, ids, mask))(jax.random.key(seed + 1))
        t_mlm_cfg = dataclasses.replace(tc.albef.bert, fusion_layer=tc.albef.bert.num_layers)
        t_mlm = load_jax_params(FusionBert(t_mlm_cfg, with_mlm_head=True), _host(p_mlm)).eval()
    return (j_sur, j_vic, j_mlm), (p_sur, p_vic, p_mlm), (t_sur, t_vic, t_mlm)
