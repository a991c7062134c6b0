"""Typed configuration tree of the PyTorch port.

A copy of the ALBEF part of ``vqattack_tpu/config.py`` (the port imports
nothing of the JAX package): the same frozen dataclasses, field names and
defaults, so a ``RunConfig`` json written by either package loads in the
other.  Keys of the JAX tree that this port does not carry (``vlmo``,
``data``, ``mesh``: the CLI takes the data paths as flags) are ignored on
load.

Fields that shape XLA programs on the TPU (``remat``, ``remat_scores``,
``scan_unroll``, ``dynamic_pgd``, ``fused_block``) are kept so configs
round-trip; PyTorch runs eagerly and the port reads none of them.  ``fused_ln``
is read: it routes the ViT trunk's residual+LayerNorm sites through the
hand-written kernel in ``ops/fused_ln.py``.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


@dataclass(frozen=True)
class ViTConfig:
    """DeiT-style ViT encoder (reference ``models/vit.py:97-177``)."""

    image_size: int = 480
    patch_size: int = 16
    hidden_size: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    remat: bool = False
    remat_scores: bool = False
    # residual-add + LayerNorm pairs through the hand-written kernel
    fused_ln: bool = False
    softmax_dtype: str = "float32"

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + [CLS]


@dataclass(frozen=True)
class BertConfig:
    """Fusion BERT (reference ``models/xbert.py`` + ``configs/config_bert.json``).

    Layers ``< fusion_layer`` are text-only, layers ``>= fusion_layer`` also
    cross-attend to image states; ``fusion_layer == num_layers`` is a plain
    BERT (the substitution MLM)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    fusion_layer: int = 6
    encoder_width: int = 768
    is_decoder: bool = False
    pad_token_id: int = 0
    remat: bool = False
    remat_scores: bool = False
    softmax_dtype: str = "float32"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class ALBEFConfig:
    """ALBEF surrogate + victim geometry (``model_pretrain.py:20-84``,
    ``model_vqa.py:11-47``)."""

    vit: ViTConfig = field(default_factory=ViTConfig)
    bert: BertConfig = field(default_factory=BertConfig)
    embed_dim: int = 256
    temp: float = 0.07
    mlm_probability: float = 0.15
    decoder_layers: int = 6

    @property
    def decoder_config(self) -> BertConfig:
        return _replace(
            self.bert, num_layers=self.decoder_layers, fusion_layer=0, is_decoder=True
        )


@dataclass(frozen=True)
class AttackConfig:
    """PGD + word-substitution attack budget (``adv_attack.py:607-695``)."""

    eps: float = 0.125
    step_size: float = 0.01
    num_iters: int = 40
    clip_min: float = -1.0
    clip_max: float = 1.0
    norm: str = "linf"
    rand_init: bool = True
    max_text_len: int = 25
    mlm_top_k: int = 5
    mlm_score_threshold: float = 0.3
    sim_threshold: float = 0.95
    max_bpe_len: int = 12
    max_bpe_width: int = 4
    max_bpe_candidates: int = 24
    max_answers: int = 8
    max_sub_words: int = 16
    max_candidates: int = 8
    scan_unroll: int = 4
    tap_dtype: str = "float32"
    dynamic_pgd: bool = False
    fused_block: bool = True


@dataclass(frozen=True)
class RunConfig:
    albef: ALBEFConfig = field(default_factory=ALBEFConfig)
    attack: AttackConfig = field(default_factory=AttackConfig)
    seed: int = 42
    batch_size: int = 1
    k_test: int = 128
    eval_every: int = 10
    output_dir: str = "attack_out"
    compute_dtype: str = "float32"


def albef_attack_config() -> RunConfig:
    """The reference ALBEF attack configuration (VQA.yaml + Pretrain.yaml),
    with the same field values as the JAX preset."""
    base = RunConfig()
    albef = _replace(
        base.albef,
        vit=_replace(base.albef.vit, remat=True),
        bert=_replace(base.albef.bert, remat=True),
    )
    return _replace(base, albef=albef,
                    attack=_replace(base.attack, dynamic_pgd=True))


def tiny_test_config(image_size: int = 32, vocab_size: int = 64) -> RunConfig:
    """A miniature geometry for unit tests (2 layers, 32px, toy vocab)."""
    vit = ViTConfig(image_size=image_size, patch_size=16, hidden_size=32, depth=2, num_heads=2)
    bert = BertConfig(
        vocab_size=vocab_size,
        hidden_size=32,
        num_layers=4,
        num_heads=2,
        intermediate_size=64,
        fusion_layer=2,
        encoder_width=32,
        max_position_embeddings=64,
    )
    albef = ALBEFConfig(vit=vit, bert=bert, embed_dim=16, decoder_layers=2)
    attack = AttackConfig(
        num_iters=4, max_text_len=8, max_answers=2, max_sub_words=4, max_candidates=3
    )
    return RunConfig(albef=albef, attack=attack, batch_size=2, k_test=4)


def to_dict(cfg: Any) -> Any:
    if dataclasses.is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, tuple):
        return [to_dict(v) for v in cfg]
    return cfg


_NESTED = {
    "albef": ALBEFConfig,
    "attack": AttackConfig,
    "vit": ViTConfig,
    "bert": BertConfig,
}


def run_config_from_dict(d: dict) -> RunConfig:
    """Inverse of :func:`to_dict`; keys this port does not know are ignored."""

    def build(cls, dd):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in dd:
                continue
            v = dd[f.name]
            if f.name in _NESTED and isinstance(v, dict):
                kwargs[f.name] = build(_NESTED[f.name], v)
            elif isinstance(v, list):
                kwargs[f.name] = tuple(v)
            else:
                kwargs[f.name] = v
        return cls(**kwargs)

    return build(RunConfig, d)


def save_config(cfg: RunConfig, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_dict(cfg), f, indent=2)


def load_config(path: str) -> RunConfig:
    with open(path) as f:
        return run_config_from_dict(json.load(f))
