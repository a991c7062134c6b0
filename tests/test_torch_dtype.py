"""The bfloat16 surrogate trunk (``--dtype bfloat16``, ``--softmax-dtype``,
``--tap-dtype``) against the JAX package's.

- the flash kernel's plain bf16 version against the library kernel's
  ``mha_reference`` and ``jax.vjp`` of it, the float32 yardstick from the
  same bf16 inputs, with and without the two additive terms;
- the port's bf16 ALBEF and VLMo surrogates against the JAX modules at
  ``dtype=jnp.bfloat16`` on the same weights (``tiny_test_config``):
  features, and the pixel gradient's signs, which are what a PGD step uses
  (as ``tests/test_remat.py`` holds the JAX bf16 trunk);
- the port's own 40-iteration float32-vs-bf16 trajectory budget (the JAX
  package's, ``tests/test_remat.py``) for both surrogates, with the bf16
  softmax composed;
- ``tap_dtype`` casting exactly the clean target stacks, held against the
  JAX orchestrators (as ``tests/test_tap_dtype.py``);
- the precision flags resolving to the JAX ``resolve_config``'s fields, and
  the CLI at ``--dtype bfloat16 --device cpu`` for both pipelines, VLMo's
  victim in the surrogate's dtype.

Inputs come from seeded numpy generators.  Each tolerance is argued where
it is used.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds, mha_reference

from torch_port_util import (JaxKey, _host, nchw, shallow_albef, synth_cli_assets, tiny_configs,
                             tiny_models, tiny_vlmo, tiny_vlmo_configs)
from vqattack_tpu import run as jax_run
from vqattack_tpu.attacks import albef as jalbef_losses
from vqattack_tpu.attacks import vlmo as jvlmo_losses
from vqattack_tpu.attacks.orchestrator import AlbefAttackPipeline as JAlbefPipeline
from vqattack_tpu.attacks.vlmo_orchestrator import VlmoAttackPipeline as JVlmoPipeline
from vqattack_tpu.models.albef import AlbefPretrain as JAlbefPretrain
from vqattack_tpu.models.vlmo import VLMo as JVLMo
from vqattack_tpu.ops.attention import _prepare
from vqattack_tpu.text.similarity import NullGate as JNullGate
from vqattack_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from vqattack_tpu_torch import run as port_run
from vqattack_tpu_torch.attacks import albef as albef_losses
from vqattack_tpu_torch.attacks import vlmo as vlmo_losses
from vqattack_tpu_torch.attacks.orchestrator import AlbefAttackPipeline
from vqattack_tpu_torch.attacks.pgd import pgd_feature
from vqattack_tpu_torch.attacks.vlmo_orchestrator import VlmoAttackPipeline
from vqattack_tpu_torch.checkpoint import synthetic
from vqattack_tpu_torch.checkpoint.convert import load_jax_params
from vqattack_tpu_torch.config import load_config
from vqattack_tpu_torch.models.albef import AlbefPretrain
from vqattack_tpu_torch.models.vlmo import VLMo
from vqattack_tpu_torch.ops import attention
from vqattack_tpu_torch.text.similarity import NullGate
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer

T = torch.from_numpy
BF16 = torch.bfloat16
VOCAB = 64
EPS = 0.125


def _f32(x) -> np.ndarray:
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x, np.float32)


def _long(a) -> torch.Tensor:
    return T(np.asarray(a)).long()


# ---------------------------------------------------------------------------
# K3's plain bf16 version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,terms", [(37, False), (130, False), (130, True)])
def test_flash_reference_bf16_against_the_library_oracle(s, terms):
    """The plain bf16 forward and backward of the flash kernel (P and dS
    rounded to bf16 where the library kernel rounds them, everything else
    float32) against ``mha_reference`` behind the JAX wrapper's ``_prepare``
    and ``jax.vjp`` of ``mha_reference`` (its backward, ``mha_reference_bwd``),
    both run on the same bf16 values upcast to float32.  With terms: a
    relative-position table as ``bias`` and a padded-text key mask as
    ``key_bias``, which the JAX side receives summed.  Tolerance: one bf16
    ulp (2^-7) of each tensor's largest magnitude, at least 1, the size of
    the roundings of P, dS and the bf16 output over up to 130 keys."""
    rng = np.random.default_rng(s)
    b, h, dh = 2, 2, 64
    scale = dh ** -0.5
    q, k, v, do = (rng.normal(size=(b, s, h, dh)).astype(np.float32) for _ in range(4))
    tq, tk, tv, tdo = (T(x).to(BF16) for x in (q, k, v, do))
    q, k, v, do = (_f32(x) for x in (tq, tk, tv, tdo))  # the bf16 values, in float32
    table = key_bias = dense = None
    if terms:
        table = (rng.normal(size=(1, h, s, s)) * 0.5).astype(np.float32)
        key_bias = np.zeros((b, s), np.float32)
        key_bias[1, 20:40] = -1e9
        dense = table + key_bias[:, None, None, :]
    qt, kt, vt, ab, seg, sq = _prepare(q, k, v, None if dense is None else jnp.asarray(dense),
                                       scale)
    seg = None if seg is None else SegmentIds(*seg)
    ref = np.asarray(mha_reference(qt, kt, vt, ab, segment_ids=seg, sm_scale=scale))
    ref = ref[:, :, :sq].transpose(0, 2, 1, 3)
    # mha_reference's backward takes sm_scale 1: the scale (1/8, exact) in q, the bias unscaled
    ab1 = None if ab is None else ab * scale
    _, vjp = jax.vjp(lambda q_, k_, v_: mha_reference(q_ * scale, k_, v_, ab1, segment_ids=seg),
                     qt, kt, vt)
    dot = jnp.pad(jnp.transpose(jnp.asarray(do), (0, 2, 1, 3)),
                  ((0, 0), (0, 0), (0, qt.shape[2] - s), (0, 0)))
    dq, dk, dv = (np.asarray(g)[:, :, :s].transpose(0, 2, 1, 3) for g in vjp(dot))

    tb, tkb = (None if x is None else T(x) for x in (table, key_bias))
    o, lse = attention.flash_attention_reference(tq, tk, tv, tb, scale, return_lse=True,
                                                 key_bias=tkb)
    grads = attention.flash_attention_bwd_reference(tq, tk, tv, tb, scale, o, lse, tdo, tkb)
    assert o.dtype == BF16 and lse.dtype == torch.float32
    for name, got, want in zip(("o", "dq", "dk", "dv"), (o, *grads), (ref, dq, dk, dv)):
        assert got.dtype == BF16, name
        err = float(np.abs(_f32(got) - want).max())
        assert err <= 2 ** -7 * max(1.0, float(np.abs(want).max())), f"{name}: {err}"


# ---------------------------------------------------------------------------
# the bf16 surrogates against the JAX modules
# ---------------------------------------------------------------------------


def _feature_tol(want) -> float:
    """Four bf16 ulps (2^-5) of the largest magnitude: the two frameworks
    round to bf16 at other places (flax rounds a Dense's product before its
    bias is added, cuBLAS/oneDNN once after; GELU and the norms' casts), by
    an ulp or two of the largest value over the tiny depth."""
    return 2 ** -5 * max(1.0, float(np.abs(want).max()))


def _sign_agreement(a, b) -> float:
    return float((np.sign(a) == np.sign(b)).mean())


@pytest.fixture(scope="module")
def albef():
    """The tiny ALBEF in both packages at bf16, on the JAX weights; masking
    off (mlm_probability 0) so that both see the same ids."""
    jc, tc = (shallow_albef(c) for c in tiny_configs(VOCAB))
    jc = dataclasses.replace(jc, albef=dataclasses.replace(jc.albef, mlm_probability=0.0))
    tc = dataclasses.replace(tc, albef=dataclasses.replace(tc.albef, mlm_probability=0.0))
    (j32, _, _), (params, _, _), (t32, _, _) = tiny_models(jc, tc, victim=False, mlm=False)
    t16 = load_jax_params(AlbefPretrain(tc.albef, dtype="bfloat16"), _host(params))
    rng = np.random.default_rng(0)
    px = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(5, VOCAB, (2, 8)).astype(np.int32)
    ids[:, 0] = 2
    mask = np.ones_like(ids)
    return {"jc": jc, "tc": tc, "params": params, "t32": t32.requires_grad_(False),
            "t16": t16.eval().requires_grad_(False),
            "j16": JAlbefPretrain(jc.albef, dtype=jnp.bfloat16), "j32": j32,
            "px": px, "ids": ids, "mask": mask}


def _shifted(px) -> np.ndarray:
    """A start inside the ball, the same for both packages."""
    return np.clip(px + 0.05 * np.sin(np.arange(px.size)).reshape(px.shape), -1, 1).astype(
        np.float32)


def test_albef_bf16_surrogate_against_jax(albef):
    """Features, MLM logits and the feature loss's pixel gradient of the
    bf16 surrogate against the JAX module at ``dtype=bfloat16`` (one
    compiled program), the clean targets float32: features within
    :func:`_feature_tol`; the gradient's signs, what the PGD step takes,
    agree on more than 85% of the pixels (the JAX package's own bar for its
    bf16 trunk against float32)."""
    a = albef
    px, ids, mask = a["px"], a["ids"], a["mask"]
    t_px, t_ids, t_mask = T(nchw(px)), _long(ids), _long(mask)
    img32, txt32, _ = a["t32"].gen_feats(t_px, t_ids, t_mask)
    j_loss = jalbef_losses.make_feature_loss(a["j16"])

    @jax.jit
    def jax_side(params, adv, tgt_img, tgt_txt):
        aux = {"variables": params, "text_ids": ids, "text_mask": mask, "tgt_img": tgt_img,
               "tgt_txt": tgt_txt, "txt_token_mask": None, "special_ids": (4, 0, 2)}
        feats = a["j16"].apply(params, px, ids, mask, method=JAlbefPretrain.gen_feats)
        return feats, jax.grad(lambda x: j_loss(x, jax.random.key(1), aux)[0])(adv)

    adv = _shifted(px)
    j_out, j_grad = jax_side(a["params"], adv, img32.numpy(), txt32.numpy())
    t_out = a["t16"].gen_feats(t_px, t_ids, t_mask)
    for name, t, j in zip(("img_feats", "txt_feats", "mlm_logits"), t_out, j_out):
        assert (t.dtype, j.dtype) == (BF16, jnp.bfloat16), name
        err = float(np.abs(_f32(t) - _f32(j)).max())
        assert err <= _feature_tol(_f32(j)), f"{name}: {err}"
    t_aux = {"text_ids": t_ids, "text_mask": t_mask, "tgt_img": img32, "tgt_txt": txt32,
             "special_ids": (4, 0, 2)}
    x = T(nchw(adv)).requires_grad_(True)
    loss, ps = albef_losses.make_feature_loss(a["t16"])(x, JaxKey(jax.random.key(1)), t_aux)
    assert ps.dtype == torch.float32  # a bf16 tap against a float32 target
    (t_grad,) = torch.autograd.grad(loss, x)
    assert t_grad.dtype == torch.float32
    assert _sign_agreement(t_grad.numpy(), nchw(j_grad)) > 0.85


@pytest.fixture(scope="module")
def vlmo():
    jc, tc = tiny_vlmo_configs(VOCAB, depth=2)
    j32, params, t32 = tiny_vlmo(jc, tc)
    t16 = load_jax_params(VLMo(tc.vlmo, dtype="bfloat16"), params)
    rng = np.random.default_rng(1)
    px = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(5, VOCAB, (2, 8)).astype(np.int32)
    ids[:, 0] = 2
    mask = np.ones_like(ids)
    mask[1, 5:] = 0  # padded text keys inside the joint sequence
    ids[1, 5:] = 0
    return {"jc": jc, "tc": tc, "params": params, "j32": j32, "t32": t32.requires_grad_(False),
            "j16": JVLMo(jc.vlmo, dtype=jnp.bfloat16), "t16": t16.eval().requires_grad_(False),
            "px": px, "ids": ids, "mask": mask}


def test_vlmo_bf16_surrogate_against_jax(vlmo):
    """The bf16 VLMo's relative-position biases, attack features, victim
    classifier logits and feature-loss pixel gradient against the JAX module
    at ``dtype=bfloat16`` (one compiled program), with padded text keys, as
    for ALBEF.  The biases are the table rounded to bf16 as the JAX module
    rounds it, held in float32 (the type the flash kernel takes)."""
    m = vlmo
    px, ids, mask = m["px"], m["ids"], m["mask"]
    t_px, t_ids, t_mask = T(nchw(px)), _long(ids), _long(mask)
    _, cls32, tok32, tmask = m["t32"].attack_feats(t_px, t_ids, t_mask)
    j_loss = jvlmo_losses.make_feature_loss(m["j16"])

    @jax.jit
    def jax_side(params, adv, tgt_cls, tgt_tok, tgt_mask):
        def run(method, *a):
            return m["j16"].apply(params, *a, method=method)

        aux = {"variables": params, "text_ids": ids, "text_mask": mask, "tgt_layer_cls": tgt_cls,
               "tgt_tokens": tgt_tok, "tgt_token_mask": tgt_mask}
        return (run(JVLMo.precompute_joint_biases), run(JVLMo.attack_feats, px, ids, mask)[:3],
                run(JVLMo.vqa_logits, px, ids, mask),
                jax.grad(lambda x: j_loss(x, None, aux)[0])(adv))

    adv = _shifted(px)
    j_rel, j_out, j_logits, j_grad = jax_side(m["params"], adv, cls32.numpy(), tok32.numpy(),
                                              tmask.float().numpy())
    rel = m["t16"].precompute_joint_biases()
    assert rel.dtype == torch.float32 and j_rel.dtype == jnp.bfloat16
    np.testing.assert_array_equal(rel.numpy(), _f32(j_rel))
    t_out = m["t16"].attack_feats(t_px, t_ids, t_mask, rel)[:3]
    t_logits = m["t16"].vqa_logits(t_px, t_ids, t_mask, rel)
    for name, t, j in zip(("cls_feats", "layer_cls", "token_feats", "vqa_logits"),
                          (*t_out, t_logits), (*j_out, j_logits)):
        assert (t.dtype, j.dtype) == (BF16, jnp.bfloat16), name
        err = float(np.abs(_f32(t) - _f32(j)).max())
        assert err <= _feature_tol(_f32(j)), f"{name}: {err}"
    t_aux = {"text_ids": t_ids, "text_mask": t_mask, "rel_biases": rel, "tgt_layer_cls": cls32,
             "tgt_tokens": tok32, "tgt_token_mask": tmask.float()}
    x = T(nchw(adv)).requires_grad_(True)
    loss, ps = vlmo_losses.make_feature_loss(m["t16"])(x, None, t_aux)
    assert ps.dtype == torch.float32
    (t_grad,) = torch.autograd.grad(loss, x)
    assert _sign_agreement(t_grad.numpy(), nchw(j_grad)) > 0.85


# ---------------------------------------------------------------------------
# the trajectory budget, port float32 against port bf16
# ---------------------------------------------------------------------------


def _bf16_softmax(tc, which):
    if which == "albef":
        return dataclasses.replace(tc.albef, vit=dataclasses.replace(
            tc.albef.vit, softmax_dtype="bfloat16"), bert=dataclasses.replace(
            tc.albef.bert, softmax_dtype="bfloat16"))
    return dataclasses.replace(tc.vlmo, softmax_dtype="bfloat16")


@pytest.mark.parametrize("which", ["albef", "vlmo"])
def test_bf16_trajectory_drift_budget(which, albef, vlmo):
    """A 40-iteration feature attack with the bf16 trunk and the bf16
    softmax tracks the float32 one within the JAX package's budget
    (``tests/test_remat.py``): the final loss within 10% per sample, the
    mean relative deviation of the loss trajectory under 20%, the mean
    pixel difference under half the ball's radius; both stay in the ball."""
    m = albef if which == "albef" else vlmo
    px, ids, mask = T(nchw(m["px"])), _long(m["ids"]), _long(m["mask"])
    params = _host(m["params"])
    if which == "albef":
        m16 = load_jax_params(AlbefPretrain(_bf16_softmax(m["tc"], which), dtype="bfloat16"),
                              params).eval().requires_grad_(False)
        img, txt, _ = m["t32"].gen_feats(px, ids, mask)
        aux = {"text_ids": ids, "text_mask": mask, "tgt_img": img, "tgt_txt": txt,
               "special_ids": (4, 0, 2)}
        losses = [albef_losses.make_feature_loss(mod) for mod in (m["t32"], m16)]
    else:
        cfg16 = dataclasses.replace(m["tc"], vlmo=_bf16_softmax(m["tc"], which)).vlmo
        m16 = load_jax_params(VLMo(cfg16, dtype="bfloat16"), params).eval().requires_grad_(False)
        _, cls32, tok32, tmask = m["t32"].attack_feats(px, ids, mask)
        aux = {"text_ids": ids, "text_mask": mask, "tgt_layer_cls": cls32, "tgt_tokens": tok32,
               "tgt_token_mask": tmask.float()}
        losses = [vlmo_losses.make_feature_loss(mod) for mod in (m["t32"], m16)]
        auxs = [dict(aux, rel_biases=mod.precompute_joint_biases()) for mod in (m["t32"], m16)]
    runs = []
    for i, loss in enumerate(losses):
        a = aux if which == "albef" else auxs[i]
        runs.append(pgd_feature(loss, px, px, JaxKey(jax.random.key(1)), a, eps=EPS,
                                eps_iter=0.01, nb_iter=40))
    (a32, l32), (a16, l16) = ((adv.numpy(), l.numpy()) for adv, l in runs)
    assert l16.dtype == np.float32 and a16.dtype == np.float32
    rel_final = np.abs(l16[-1] - l32[-1]) / np.abs(l32[-1])
    assert (rel_final < 0.10).all(), rel_final
    assert np.mean(np.abs(l16 - l32) / np.maximum(np.abs(l32), 1e-6)) < 0.20
    assert np.abs(a16 - a32).mean() < 0.5 * EPS
    assert (np.abs(a16 - px.numpy()) <= EPS + 1e-6).all()


# ---------------------------------------------------------------------------
# tap_dtype against the JAX orchestrators
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("which", ["albef", "vlmo"])
def test_tap_dtype_casts_exactly_the_target_stacks(which, albef, vlmo):
    """Under the bf16 trunk the clean targets come out bf16 whatever
    ``tap_dtype`` says (the trunk's own output), and ``tap_dtype`` bfloat16
    casts exactly the target stacks; VLMo's token mask stays float32.  The
    port's pipelines give the JAX pipelines' dtypes and, within
    :func:`_feature_tol`, their values."""
    m = albef if which == "albef" else vlmo
    words = ["what", "color", "is", "the", "dog"]
    jtok = JTokenizer.toy(words, with_pieces=False)
    ttok = WordPieceTokenizer.toy(words, with_pieces=False)
    assert jtok.vocab_size <= VOCAB
    px, ids, mask = m["px"], m["ids"], m["mask"]
    # one JAX pipeline, its compiled forward reused: clean_targets reads
    # cfg.attack.tap_dtype when it is called
    if which == "albef":
        jp = JAlbefPipeline(m["jc"], m["j16"], m["params"], jtok, JNullGate(), use_pallas=False)
    else:
        jp = JVlmoPipeline(m["jc"], m["j16"], m["params"], m["params"], jtok, JNullGate(),
                           use_pallas=False)
    for tap in ("float32", "bfloat16"):
        jp.cfg = dataclasses.replace(m["jc"], attack=dataclasses.replace(m["jc"].attack,
                                                                         tap_dtype=tap))
        tc = dataclasses.replace(m["tc"], attack=dataclasses.replace(m["tc"].attack,
                                                                     tap_dtype=tap))
        if which == "albef":
            j_out = jp.clean_targets(px, ids, mask, jax.random.key(2))
            tp = AlbefAttackPipeline(tc, m["t16"], ttok, NullGate(), device="cpu")
            t = tp._targets_fn(T(nchw(px)), JaxKey(jax.random.key(2)),
                               {"ori_ids": _long(ids), "ori_mask": _long(mask)})
            t_out = (t["tgt_img"], t["tgt_txt"])
        else:
            j_out = jp.clean_targets(px, ids, mask)
            tp = VlmoAttackPipeline(tc, m["t16"], ttok, NullGate(), device="cpu")
            t_out = tp.clean_targets(T(nchw(px)), _long(ids), _long(mask))
            assert t_out[2].dtype == torch.float32 and j_out[2].dtype == jnp.float32
            np.testing.assert_array_equal(t_out[2].numpy(), np.asarray(j_out[2]))
            t_out, j_out = t_out[:2], j_out[:2]
        for t, j in zip(t_out, j_out):
            assert t.dtype == BF16 and j.dtype == jnp.bfloat16, tap
            assert float(np.abs(_f32(t) - _f32(j)).max()) <= _feature_tol(_f32(j))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("flags", [
    [], ["--dtype", "bfloat16"], ["--dtype", "bfloat16", "--softmax-dtype", "bfloat16"],
    ["--softmax-dtype", "bfloat16", "--tap-dtype", "bfloat16"],
    ["--pipeline", "vlmo", "--dtype", "bfloat16", "--tap-dtype", "bfloat16"],
])
def test_precision_flags_resolve_as_jax(flags):
    """``--dtype``, ``--softmax-dtype`` and ``--tap-dtype`` set the same
    config fields as the JAX ``resolve_config``."""
    base = ["--vocab", "vocab.txt", "--device", "cpu"]
    t_cfg = port_run.resolve_config(port_run.build_argparser().parse_args(base + flags))
    j_cfg = jax_run.resolve_config(jax_run.build_argparser().parse_args(
        [a for a in base if a not in ("--device", "cpu")] + flags))
    for get in (lambda c: c.compute_dtype, lambda c: c.attack.tap_dtype,
                lambda c: c.albef.vit.softmax_dtype, lambda c: c.albef.bert.softmax_dtype,
                lambda c: c.vlmo.softmax_dtype):
        assert get(t_cfg) == get(j_cfg)


def _capture_pipeline(monkeypatch):
    built = []
    build = port_run._build_pipeline
    monkeypatch.setattr(port_run, "_build_pipeline",
                        lambda *a: built.append(build(*a)) or built[-1])
    return built


SAMPLES = [(1001, "what color is the dog", "red", "the dog is red"),
           (1002, "what is the man holding", "frisbee", None)]


def test_cli_albef_bf16_on_cpu(tmp_path, capsys, monkeypatch):
    """``--dtype bfloat16 --softmax-dtype bfloat16 --tap-dtype bfloat16``,
    per sample and ``--batch-size 2 --attn flash``: the surrogate computes
    in bf16, the victim and the candidate MLM in float32, every parameter
    stays float32, the artifacts are float32 and inside the ball."""
    argv = synth_cli_assets(tmp_path, SAMPLES) + [
        "--dtype", "bfloat16", "--softmax-dtype", "bfloat16", "--tap-dtype", "bfloat16"]
    built = _capture_pipeline(monkeypatch)
    for extra, out in (([], "out"), (["--batch-size", "2", "--attn", "flash"], "out_b")):
        summary = port_run.main(argv + extra + ["--output", str(tmp_path / out)])
        assert summary["samples"] == 2
        for qid in ("1001", "1002"):
            img = torch.load(tmp_path / out / f"{qid}.pt")
            assert img.dtype == torch.float32 and float(img.abs().max()) <= 1.0
    pipe = built[-1]
    assert pipe.cfg.compute_dtype == "bfloat16" and pipe.cfg.attack.tap_dtype == "bfloat16"
    assert pipe.surrogate.visual_encoder.blocks[0].attn.query.compute_dtype == BF16
    assert pipe.surrogate.text_encoder.mlm_head.decoder.compute_dtype == BF16
    assert pipe.victim.visual_encoder.blocks[0].attn.query.compute_dtype == torch.float32
    assert pipe.mlm_model.layer[0].attention_self.query.compute_dtype == torch.float32
    for module in (pipe.surrogate, pipe.victim, pipe.mlm_model):
        assert all(p.dtype == torch.float32 for p in module.parameters())
    capsys.readouterr()


def test_cli_vlmo_bf16_on_cpu_victim_in_the_surrogates_dtype(tmp_path, capsys, monkeypatch):
    """``--pipeline vlmo --dtype bfloat16``, per sample and batched, with a
    ``--victim-ckpt``: the victim is a second module computing in the
    surrogate's bf16, as the JAX CLI applies the victim's parameters to the
    surrogate's bf16 module; the candidate MLM stays float32."""
    argv = synth_cli_assets(tmp_path, [(q, t + "?", a, p) for q, t, a, p in SAMPLES])
    i = argv.index("--answer-list")
    del argv[i : i + 2]
    (tmp_path / "id2answer.json").write_text(json.dumps({str(i): f"ans{i}" for i in range(16)}))
    cfg = load_config(argv[argv.index("--config") + 1])
    vic = synthetic.vlmo_state_dict(cfg.vlmo, seed=4, heads=("vqa_classifier",))
    torch.save({"state_dict": vic}, tmp_path / "vlmo_vqa.pt")
    argv += ["--pipeline", "vlmo", "--id2answer", str(tmp_path / "id2answer.json"),
             "--victim-ckpt", str(tmp_path / "vlmo_vqa.pt"), "--dtype", "bfloat16"]
    built = _capture_pipeline(monkeypatch)
    for extra, out in (([], "out"), (["--batch-size", "2", "--attn", "flash"], "out_b")):
        summary = port_run.main(argv + extra + ["--output", str(tmp_path / out)])
        assert summary["samples"] == 2 and summary["pipeline"] == "vlmo"
    pipe = built[-1]
    assert pipe.victim is not pipe.model
    for module in (pipe.model, pipe.victim):
        assert module.compute_dtype == BF16 and module.vqa_classifier.fc2.compute_dtype == BF16
    assert pipe._victim_rel_biases.dtype == torch.float32
    assert pipe.mlm_model.layer[0].attention_self.query.compute_dtype == torch.float32
    capsys.readouterr()
