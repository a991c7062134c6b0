"""The black-box transfer slice of the port against the JAX package: the
ViLT and BLIP-VQA victims, ``convert_vilt``, a ViLT surrogate's attack (per
sample and one batched block, the JAX draws injected), ``eval/vqa_eval.py``,
the three defenses, and the ``transfer_eval`` and ``predict`` CLIs of both
packages on the same artifacts and weights.

The models are tiny (``tiny_test_config`` widths, 32 px; ViLT at 1 block,
VLMo at 2, a split block and the VL expert; ALBEF ``shallow_albef``): the JAX side's compiles dominate the time.  Tolerances: model outputs within
1e-5 of their largest magnitude (float32 sums in another order), the
attack's losses within 1e-3 relative and its image within the PGD drift
budget, as in ``tests/test_torch_vlmo_attack.py``; the converter bit for
bit without a resize, within 1e-5 with one (``interpolate_pos_embed`` is
the reference's float32 call, the JAX package emulates it in float64);
the defenses within 1e-5 (another order of the resize's sums).
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (JaxKey, assert_same_tree, fixed_topk, init_tree_shapes, jit_apply,
                             nchw, nhwc, shallow_albef, tiny_configs, tiny_mlm, tiny_vlmo)
from vqattack_tpu import config as jcfg
from vqattack_tpu import defenses as jdefenses
from vqattack_tpu import predict as jpredict
from vqattack_tpu import run as jrun
from vqattack_tpu import transfer_eval as jtransfer
from vqattack_tpu.attacks.batched import BatchedVlmoAttack as JBatched
from vqattack_tpu.attacks.orchestrator import AlbefAttackPipeline as JAlbefPipeline
from vqattack_tpu.attacks.vlmo_orchestrator import VlmoAttackPipeline as JPipeline
from vqattack_tpu.attacks.vlmo_orchestrator import load_id2answer as jload_id2answer
from vqattack_tpu.checkpoint.convert import convert_albef_vqa as jconvert_albef_vqa
from vqattack_tpu.checkpoint.convert import convert_vilt as jconvert_vilt
from vqattack_tpu.checkpoint.convert import convert_vlmo as jconvert_vlmo
from vqattack_tpu.eval import vqa_eval as jvqa_eval
from vqattack_tpu.models.albef import AlbefPretrain as JAlbefPretrain
from vqattack_tpu.models.albef import AlbefVQA as JAlbefVQA
from vqattack_tpu.models.vlmo import VLMo as JVLMo
from vqattack_tpu.text.similarity import NullGate as JNullGate
from vqattack_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from vqattack_tpu_torch import config as tcfg
from vqattack_tpu_torch import defenses as tdefenses
from vqattack_tpu_torch import predict as tpredict
from vqattack_tpu_torch import run as port_run
from vqattack_tpu_torch import transfer_eval as ttransfer
from vqattack_tpu_torch.attacks.batched import BatchedVlmoAttack
from vqattack_tpu_torch.attacks.vlmo_orchestrator import VlmoAttackPipeline
from vqattack_tpu_torch.checkpoint import io as ckpt_io
from vqattack_tpu_torch.checkpoint import synthetic
from vqattack_tpu_torch.checkpoint.convert import convert_albef_vqa, convert_vilt, load_jax_params
from vqattack_tpu_torch.eval import vqa_eval as tvqa_eval
from vqattack_tpu_torch.models.albef import AlbefVQA
from vqattack_tpu_torch.models.vlmo import VLMo
from vqattack_tpu_torch.text.similarity import NullGate
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer

T = torch.from_numpy
WORDS = ["what", "color", "is", "the", "dog", "cat", "red", "blue", "hat", "a",
         "frisbee", "park", "dog-cat"]
CANDIDATES = {"dog": ["dog-cat"], "cat": ["hat"]}
ID2ANSWER = {i: f"ans{i}" for i in range(16)}
VILT = dict(moe=False, use_abs_pos_emb=True, need_relative_position_embed=False,
            layer_scale_init=None)


def _close(got, want, what, rel=1e-5):
    want = np.asarray(want)
    tol = rel * max(1.0, float(np.abs(want).max()))
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol, f"{what}: max abs err {err} > {tol}"


def _vilt_configs(vocab_size, **attack_kw):
    """The tiny RunConfig of both packages with a single-stream ViLT as the
    VLMo geometry (``vilt_base_config``'s switches at tiny widths)."""
    return [dataclasses.replace(c, vlmo=dataclasses.replace(
                c.vlmo, vocab_size=vocab_size, depth=1, vlffn_start_layer=1, **VILT))
            for c in tiny_configs(vocab_size, **attack_kw)]


def _tiny_vilt(jc, tc, seed):
    """(JAX module, JAX params, port module) of the tiny ViLT, the port's
    random weights from ``seed`` as flax variables (``tiny_vlmo``)."""
    return tiny_vlmo(jc, tc, seed)


# ------------------------------------------------------------------ configs


def test_vilt_and_blip_presets_match_the_jax_presets():
    assert tcfg.to_dict(tcfg.vilt_base_config()) == jcfg.to_dict(jcfg.vilt_base_config())
    for size in (384, 480):
        assert tcfg.to_dict(tcfg.blip_vqa_config(size)) == jcfg.to_dict(jcfg.blip_vqa_config(size))
    vilt = tcfg.vilt_base_config()
    assert vilt.image_seq_len == 145 and vilt.image_seq_len + vilt.max_text_len == 185
    assert vilt.hidden_size // vilt.num_heads == 64 and not vilt.moe
    blip = tcfg.blip_vqa_config()
    assert blip.bert.fusion_layer == 0 and blip.decoder_config.num_layers == 12


# ------------------------------------------------------------------- models


def test_vilt_model_matches_jax_vlmo_without_moe():
    """Logits, pooled features and every layer's features of the tiny ViLT
    against the JAX ``VLMo(moe=False)``; the blocks hold one ``norm2`` +
    ``mlp`` and no expert, and the model no VL-expert heads."""
    jc, tc = _vilt_configs(64)
    j_model, params, t_model = _tiny_vilt(jc, tc, seed=0)
    ids0 = jnp.ones((1, jc.vlmo.max_text_len), jnp.int32)
    assert_same_tree(params, init_tree_shapes(j_model, ids0, ids0, jnp.zeros((1, 32, 32, 3)),
                                              method=JVLMo.init_all))
    blk = params["params"]["blocks_0"]
    assert "mlp" in blk and "norm2" in blk and "mlp_text" not in blk
    assert not hasattr(t_model.blocks[0], "mlp_text") and not t_model._has_vlffn
    rng = np.random.default_rng(0)
    px = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 64, (2, jc.vlmo.max_text_len)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 5:] = 0
    j_logits = jit_apply(j_model, params, px, ids, mask, method=JVLMo.vqa_logits)
    j_out = jit_apply(j_model, params, ids, mask, px)
    with torch.no_grad():
        t_logits = t_model.vqa_logits(T(nchw(px)), T(ids).long(), T(mask).long())
        t_out = t_model.infer(T(ids).long(), T(mask).long(), T(nchw(px)))
    _close(t_logits.numpy(), j_logits, "vqa logits")
    for key in ("cls_feats", "text_feats", "image_feats", "feats"):
        _close(t_out[key].numpy(), j_out[key], key)


def test_convert_vilt_matches_jax_and_loads():
    """The port's ``convert_vilt`` against the JAX one on a state dict in
    ViLT's names (``synthetic.vilt_state_dict``): bit for bit at the
    file's size, within 1e-5 with the ``pos_embed`` resize; the converted
    tree loads into the port's ViLT (``load_vilt``) and the JAX module and
    the port give the same logits on it; the key's third of the qkv bias is
    dropped."""
    jc, tc = _vilt_configs(64)
    sd = synthetic.vilt_state_dict(tc.vlmo, seed=3, src_image_size=64)
    np_sd = {k: v.numpy() for k, v in sd.items()}
    for new in (None, tc.vlmo.num_patches):
        j_tree = jconvert_vilt(np_sd, depth=tc.vlmo.depth, new_num_patches=new)
        t_tree = convert_vilt(np_sd, depth=tc.vlmo.depth, new_num_patches=new)
        j_flat = jax.tree_util.tree_flatten_with_path(j_tree)[0]
        t_flat = dict(jax.tree_util.tree_flatten_with_path(t_tree)[0])
        assert len(j_flat) == len(t_flat)
        for path, leaf in j_flat:
            if new is None or "pos_embed" not in jax.tree_util.keystr(path):
                np.testing.assert_array_equal(t_flat[path], leaf, err_msg=str(path))
            else:
                _close(t_flat[path], leaf, "pos_embed")
    assert "bias" not in t_tree["blocks_0"]["attn"]["key"]
    model = VLMo(tc.vlmo).eval()
    load_jax_params(model, t_tree, optional=[h for h in ckpt_io.VLMO_OPTIONAL_HEADS
                                            if h not in t_tree])
    px = np.random.default_rng(4).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    ids = np.ones((1, tc.vlmo.max_text_len), np.int32)
    j_logits = jit_apply(JVLMo(jc.vlmo), {"params": j_tree}, px, ids, ids,
                         method=JVLMo.vqa_logits)
    with torch.no_grad():
        t_logits = model.vqa_logits(T(nchw(px)), T(ids).long(), T(ids).long())
    _close(t_logits.numpy(), j_logits, "logits of the converted weights")


def test_load_vilt_reads_a_file_into_the_port_vilt(tmp_path):
    _, tc = _vilt_configs(64)
    sd = synthetic.vilt_state_dict(tc.vlmo, seed=5, src_image_size=64)
    torch.save(sd, tmp_path / "vilt.pth")
    model = VLMo(tc.vlmo)
    ckpt_io.load_vilt(str(tmp_path / "vilt.pth"), tc.vlmo, into=model)
    w = sd["transformer.blocks.0.attn.qkv.weight"]
    assert torch.equal(model.blocks[0].attn.value.weight, w[64:])
    assert torch.equal(model.blocks[0].mlp.fc2.weight, sd["transformer.blocks.0.mlp.fc2.weight"])
    assert torch.equal(model.vqa_classifier.fc2.bias, sd["vqa_classifier.3.bias"])
    assert model.pos_embed.shape == (1, tc.vlmo.image_seq_len, 32)


def test_blip_rank_answer_matches_jax():
    """BLIP-VQA (``fusion_layer=0``: cross-attention in every question
    layer, an empty text-only range) at tiny widths:
    ``convert_albef_vqa(fusion_layer=0, decoder_layers=2)`` against the JAX
    converter bit for bit on a synthetic state dict in the reference's
    names, and on those weights the two-pass ``rank_answer`` against the
    JAX ``AlbefVQA``."""
    jc, tc = tiny_configs(64)
    jc = dataclasses.replace(jc, albef=dataclasses.replace(
        jc.albef, bert=dataclasses.replace(jc.albef.bert, fusion_layer=0)))
    tc = dataclasses.replace(tc, albef=dataclasses.replace(
        tc.albef, bert=dataclasses.replace(tc.albef.bert, fusion_layer=0)))
    assert tc.albef.bert.fusion_layer == 0
    sd = {k: v.numpy() for k, v in synthetic.albef_vqa_state_dict(
        tc.albef, seed=2, src_image_size=32).items()}
    kw = dict(depth=2, num_layers=4, fusion_layer=0, decoder_layers=2)
    j_tree, t_tree = jconvert_albef_vqa(sd, **kw), convert_albef_vqa(sd, **kw)
    j_flat = jax.tree_util.tree_flatten_with_path(j_tree)[0]
    t_flat = dict(jax.tree_util.tree_flatten_with_path(t_tree)[0])
    assert len(j_flat) == len(t_flat)
    for path, leaf in j_flat:
        np.testing.assert_array_equal(t_flat[path], leaf, err_msg=str(path))

    rng = np.random.default_rng(1)
    px = rng.uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    ids = rng.integers(1, 64, (2, 8)).astype(np.int32)
    mask = np.ones_like(ids)
    a_ids = rng.integers(1, 64, (6, 4)).astype(np.int32)
    a_ids[:, 0] = 2
    a_mask = np.ones_like(a_ids)
    a_mask[3:, 3] = 0
    j_vic = JAlbefVQA(jc.albef)
    ja_ids, ja_mask = jnp.asarray(a_ids), jnp.asarray(a_mask)
    t_vic = load_jax_params(AlbefVQA(tc.albef), t_tree)
    assert all(hasattr(layer, "crossattention_self") for layer in t_vic.text_encoder.layer)
    j_ids, j_probs = jax.jit(lambda p: j_vic.apply(p, px, ids, mask, ja_ids, ja_mask, 3))(
        {"params": j_tree})
    with torch.no_grad():
        t_ids, t_probs = t_vic.eval()(T(nchw(px)), T(ids).long(), T(mask).long(),
                                      T(a_ids).long(), T(a_mask).long(), 3)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    _close(t_probs.numpy(), j_probs, "rank_answer probabilities")


# ------------------------------------------------------------------ attack


@pytest.fixture(scope="module")
def vilt_pipelines():
    j_tok, t_tok = JTokenizer.toy(WORDS), WordPieceTokenizer.toy(WORDS)
    jc, tc = _vilt_configs(t_tok.vocab_size, num_iters=12, dynamic_pgd=True, fused_block=True)
    j_model, j_params, t_model = _tiny_vilt(jc, tc, seed=0)
    _, j_vparams, t_victim = _tiny_vilt(jc, tc, seed=1)
    j_mlm, p_mlm, t_mlm = tiny_mlm(jc, tc, seed=2)
    jp = JPipeline(jc, j_model, j_params, j_vparams, j_tok, JNullGate(), mlm_model=j_mlm,
                   mlm_params=p_mlm, id2answer=ID2ANSWER)
    tp = VlmoAttackPipeline(tc, t_model, t_tok, NullGate(), victim=t_victim, mlm_model=t_mlm,
                            id2answer=ID2ANSWER, device="cpu")
    jp.candidate_mlm_topk = tp.candidate_mlm_topk = fixed_topk(t_tok, CANDIDATES)
    return jp, tp


def _check_attack_result(t, j):
    assert (t.old_alg, t.num_blocks, t.adv_text, t.substitutions) == (
        j.old_alg, j.num_blocks, j.adv_text, j.substitutions)
    np.testing.assert_allclose(t.feat_losses, j.feat_losses, rtol=1e-3)
    if t.old_alg == 0:
        np.testing.assert_allclose(t.mlm_losses, j.mlm_losses, rtol=1e-3)
    d = np.abs(nhwc(t.adv_image) - j.adv_image)
    assert d.max() <= 2 * 0.01 * 14 and d.mean() < 1e-3


def test_vilt_attack_sample_matches_jax(vilt_pipelines):
    """One MAR sample through the ViLT surrogate (the alternating path),
    the JAX draws injected: the schedule, text, substitutions and losses of
    the JAX pipeline, the image within the drift budget, the victim's
    answer on the JAX result equal."""
    jp, tp = vilt_pipelines
    px = np.random.default_rng(1).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
    key = jax.random.key(11)
    args = (px, "what color is the dog?", "1001", "the dog is red.", "red", ["red", "blue"])
    j = jp.attack_sample(*args, rng=key)
    t = tp.attack_sample(nchw(px), *args[1:], key=JaxKey(key))
    _check_attack_result(t, j)
    assert t.old_alg == 0 and t.vl_steps == t.num_blocks - 1 == 2
    assert tp.evaluate_victim(nchw(j.adv_image), j.adv_text) == jp.evaluate_victim(
        j.adv_image, j.adv_text)


def test_vilt_batched_block_matches_jax(vilt_pipelines):
    """One feature-only bucket of the lockstep engine over the ViLT
    surrogate against JAX's ``BatchedVlmoAttack`` on the same draws."""
    jp, tp = vilt_pipelines
    rng = np.random.default_rng(0)
    samples = [{"qid": qid, "question": q, "paraphrase": None, "target_answer": None,
                "all_correct_answers": ["red"],
                "pixels": rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)}
               for qid, q in (("1", "what color is the dog?"), ("2", "what color is the cat?"))]
    key = jax.random.key(7)
    j = {r.qid: r for r in JBatched(jp).run(samples, batch_size=2, rng=key)}
    tb = BatchedVlmoAttack(tp)
    t = tb.run([dict(s, pixels=nchw(s["pixels"])) for s in samples], batch_size=2,
               rng=JaxKey(key))
    assert tb.last_chunk_sizes == [2]
    for r in t:
        _check_attack_result(r, j[r.qid])


# ----------------------------------------------------------------- vqa_eval

NORMALIZATION_CASES = [
    "Yes.", "two dogs", "The Dog", "a man's hat", "3,000", "1.5", "dont", "isnt it?",
    "hes here", "red/white", "(left) side", "ten", "none", "an apple!", "well... ok",
    "somebody'd", "Ive", "x-ray", "  tabs\tand\nnewlines ", "e.g. this", "4 , 5",
]


@pytest.mark.parametrize("fn", ["process_punctuation", "process_digit_article",
                                "normalize_answer"])
def test_vqa_eval_normalization_matches_jax(fn):
    for text in NORMALIZATION_CASES:
        assert getattr(tvqa_eval, fn)(text) == getattr(jvqa_eval, fn)(text), text


def test_vqa_soft_accuracy_and_the_evaluator_match_jax():
    """The leave-one-annotator-out score (k = 3 of 10 gives 0.9), the
    punctuation pass on non-unanimous ground truths, and ``VQAEval.evaluate``
    over a ``VQA`` result set with its per-type breakdowns."""
    gts = [["red"] * 3 + ["blue"] * 7, ["two"] * 10, ["yes!", "yes", "no"], []]
    for pred in ("red", "Red.", "2", "two", "yes", "blue"):
        for gt in gts:
            assert tvqa_eval.vqa_soft_accuracy(pred, gt) == jvqa_eval.vqa_soft_accuracy(pred, gt)
    assert tvqa_eval.vqa_soft_accuracy("red", gts[0]) == pytest.approx(0.9)
    anns = {"annotations": [
        {"question_id": q, "image_id": q // 10, "question_type": t, "answer_type": a,
         "answers": [{"answer": x} for x in gt]}
        for q, t, a, gt in ((10, "what color", "other", gts[0]), (11, "how many", "number", gts[1]),
                            (20, "is the", "yes/no", gts[2]))]}
    res = [{"question_id": 10, "answer": "red"}, {"question_id": 11, "answer": "2"},
           {"question_id": 20, "answer": "no"}]
    out = []
    for mod in (tvqa_eval, jvqa_eval):
        vqa = mod.VQA(anns)
        assert vqa.getQuesIds(imgIds=[1]) == [10, 11] and vqa.getImgIds(quesIds=[20]) == [2]
        out.append(mod.VQAEval().evaluate(vqa, vqa.load_res(res)))
    assert out[0] == out[1] and out[0]["perAnswerType"]["other"] == pytest.approx(90.0)


# ----------------------------------------------------------------- defenses


def test_defenses_match_jax():
    """``random_resize_pad`` (the JAX draws injected through ``JaxKey``, the
    default and a wider scale range), ``spatial_smoothing`` and
    ``bit_depth_reduction`` on NCHW tensors against the JAX transforms on
    NHWC arrays."""
    x = np.random.default_rng(0).uniform(-1, 1, (2, 48, 40, 3)).astype(np.float32)
    tx = T(nchw(x))
    for seed, min_scale in ((0, None), (3, 0.6)):
        j = jdefenses.random_resize_pad(jnp.asarray(x), jax.random.key(seed),
                                        min_scale=min_scale)
        t = tdefenses.random_resize_pad(tx, JaxKey(jax.random.key(seed)), min_scale=min_scale)
        assert t.shape == tx.shape
        _close(nhwc(t.numpy()), j, f"random_resize_pad, min_scale {min_scale}")
    for window in (3, 5):
        j = jdefenses.spatial_smoothing(jnp.asarray(x), window=window)
        np.testing.assert_array_equal(nhwc(tdefenses.spatial_smoothing(tx, window).numpy()),
                                      np.asarray(j))
    for bits in (2, 4):
        j = jdefenses.bit_depth_reduction(jnp.asarray(x), bits=bits)
        _close(nhwc(tdefenses.bit_depth_reduction(tx, bits).numpy()), j, f"{bits} bits",
               rel=1e-6)


# -------------------------------------------------------------------- CLIs


def _write_assets(tmp, jc, n=6, size=32):
    """A 30,522-token vocab, NHWC artifacts with their adversarial text,
    clean answers, ground truths, the answer list and id2answer, and the
    JAX RunConfig json (``data.image_size`` at the models' size, which the
    port ignores)."""
    from torch_port_util import ROOT
    import importlib.util

    spec = importlib.util.spec_from_file_location("make_synth_assets",
                                                  ROOT / "scripts" / "make_synth_assets.py")
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    synth.make_vocab(str(tmp / "vocab.txt"))
    synth.make_image(str(tmp / "img.jpg"), size=size + 8)
    art = tmp / "artifacts"
    art.mkdir()
    rng = np.random.default_rng(0)
    answers = ["red", "blue", "green", "dog", "cat", "two"]
    texts, clean, gt = {}, {}, {}
    for i in range(n):
        qid = str(5000 + i)
        np.save(art / f"{qid}.npy", rng.uniform(-1, 1, (1, size, size, 3)).astype(np.float32))
        texts[qid] = ["what color is the dog", "what is on the table", "is it red"][i % 3]
        clean[qid] = answers[i % 2]
        gt[qid] = [answers[(i + j) % 4] for j in range(10)]
    (art / "adv_txt_dict.json").write_text(json.dumps(texts))
    files = {"sur.json": clean, "gt.json": gt, "answers.json": answers,
             "id2answer.json": {str(i): f"ans{i}" for i in range(16)}}
    for name, obj in files.items():
        (tmp / name).write_text(json.dumps(obj))
    jcfg.save_config(dataclasses.replace(jc, data=dataclasses.replace(jc.data, image_size=size)),
                     str(tmp / "cfg.json"))
    return art


def _configs(kind):
    """The tiny RunConfig of both packages for each victim: ALBEF-VQA,
    BLIP-VQA (``fusion_layer=0``), VLMo and ViLT; vocab 30,522."""
    if kind == "vilt":
        return _vilt_configs(30522)
    jc, tc = (shallow_albef(c) for c in tiny_configs(30522))
    if kind == "blip":
        jc, tc = (dataclasses.replace(c, albef=dataclasses.replace(
            c.albef, bert=dataclasses.replace(c.albef.bert, fusion_layer=0)))
            for c in (jc, tc))
    if kind == "vlmo":
        jc, tc = (dataclasses.replace(c, vlmo=dataclasses.replace(
            c.vlmo, vocab_size=30522, depth=2, vlffn_start_layer=1)) for c in (jc, tc))
    return jc, tc


def _victim_tree(kind, tc):
    """The victim's flax tree: a synthetic state dict in the reference's
    names (``checkpoint/synthetic.py``) through the JAX package's
    converter, with no JAX initialisation to compile."""
    if kind in ("albef", "blip"):
        a = tc.albef
        sd = synthetic.albef_vqa_state_dict(a, seed=4, src_image_size=a.vit.image_size)
        return jconvert_albef_vqa({k: v.numpy() for k, v in sd.items()}, depth=a.vit.depth,
                                  num_layers=a.bert.num_layers,
                                  fusion_layer=a.bert.fusion_layer,
                                  decoder_layers=a.decoder_layers)
    if kind == "vilt":
        sd = synthetic.vilt_state_dict(tc.vlmo, seed=4)
        return jconvert_vilt({k: v.numpy() for k, v in sd.items()}, depth=tc.vlmo.depth)
    sd = synthetic.vlmo_state_dict(tc.vlmo, seed=4, heads=synthetic.VLMO_VQA_HEADS)
    return jconvert_vlmo({k: v.numpy() for k, v in sd.items()}, depth=tc.vlmo.depth)


def _shared_weights(monkeypatch, kind, tc):
    """Both packages' ``_build_pipeline`` patched to hold one victim, the
    tree of :func:`_victim_tree`.  The JAX CLIs' pipeline is built around
    it once and reused (the replay and ``predict`` run the victim only, so
    no surrogate or MLM weights are made); the port's own
    ``_build_pipeline`` runs and its victim takes the same tree."""
    tree = {"params": _victim_tree(kind, tc)}
    built = {}
    t_build = port_run._build_pipeline

    def j_wrap(args, cfg, tok, use_pallas=False):
        if "jax" not in built:
            if args.pipeline == "albef":
                built["jax"] = JAlbefPipeline(cfg, JAlbefPretrain(cfg.albef), None, tok,
                                              JNullGate(), victim=JAlbefVQA(cfg.albef),
                                              victim_params=tree)
            else:
                id2answer = jload_id2answer(args.id2answer) if args.id2answer else {}
                built["jax"] = JPipeline(cfg, JVLMo(cfg.vlmo), tree, tree, tok, JNullGate(),
                                         id2answer=id2answer)
        return built["jax"]

    def t_wrap(args, cfg, tok):
        pipe = t_build(args, cfg, tok)
        optional = ([] if args.pipeline == "albef" else
                    [h for h in ckpt_io.VLMO_OPTIONAL_HEADS if h not in tree["params"]])
        load_jax_params(pipe.victim, tree, optional=optional)
        return pipe

    monkeypatch.setattr(jrun, "_build_pipeline", j_wrap)
    monkeypatch.setattr(port_run, "_build_pipeline", t_wrap)


def _recorded_predictions(monkeypatch):
    """Every prediction the two evaluators' ``AttackAccuracy`` sees, by package."""
    from vqattack_tpu.eval import metrics as jmetrics
    from vqattack_tpu_torch.eval import metrics as tmetrics

    seen = {"jax": [], "port": []}
    for name, cls in (("jax", jmetrics.AttackAccuracy), ("port", tmetrics.AttackAccuracy)):
        update = cls.update
        monkeypatch.setattr(cls, "update", lambda self, a, c, _u=update, _n=name: (
            seen[_n].append(a), _u(self, a, c))[1])
    return seen


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["albef", "blip", "vlmo", "vilt"])
def test_transfer_eval_and_predict_clis_match_the_jax_clis(tmp_path, capsys, monkeypatch, kind):
    """``transfer_eval`` of both packages over the same artifacts and victim
    weights: the same per-pair predictions (6 pairs, one chunk of 16), the
    same printed ``samples``, flip rate and VQA soft accuracy.  For the
    ALBEF victim (two-pass ranking) and ViLT's (its classifier), also
    ``predict`` on one image file and a raw question: the same
    ``pre_question`` normalisation, the same ranked answers, probabilities
    within 1e-5.  The victim's weights: :func:`_shared_weights`."""
    jc, tc = _configs(kind)
    art = _write_assets(tmp_path, jc)
    pipeline = "albef" if kind in ("albef", "blip") else "vlmo"
    common = ["--pipeline", pipeline, "--config", str(tmp_path / "cfg.json"),
              "--vocab", str(tmp_path / "vocab.txt")]
    common += (["--answer-list", str(tmp_path / "answers.json")] if pipeline == "albef"
               else ["--id2answer", str(tmp_path / "id2answer.json")])
    argv = common + ["--artifacts", str(art), "--surrogate-ans", str(tmp_path / "sur.json"),
                     "--gt-answers", str(tmp_path / "gt.json")]
    _shared_weights(monkeypatch, kind, tc)
    seen = _recorded_predictions(monkeypatch)
    jtransfer.main(argv)
    j_out = _last_json(capsys)
    t_ret = ttransfer.main(argv + ["--device", "cpu"])
    t_out = _last_json(capsys)
    assert t_out == t_ret and t_out["samples"] == 6
    assert seen["port"] == seen["jax"] and len(seen["port"]) == 6
    assert t_out["attack_accuracy"] == j_out["attack_accuracy"]
    assert t_out["vqa_soft_accuracy"] == pytest.approx(j_out["vqa_soft_accuracy"], abs=1e-9)
    if kind not in ("albef", "vilt"):
        return
    argv = common + ["--image", str(tmp_path / "img.jpg"), "--question", "What color is the Dog?"]
    jpredict.main(argv)
    j_out = _last_json(capsys)
    t_out = tpredict.main(argv + ["--device", "cpu"])
    assert _last_json(capsys) == json.loads(json.dumps(t_out))
    assert t_out["question"] == j_out["question"] == "what color is the dog"
    assert [a for a, _ in t_out["answers"]] == [a for a, _ in j_out["answers"]]
    assert len(t_out["answers"]) == (4 if kind == "albef" else 5)  # k_test 4: ALBEF ranks 4
    _close([p for _, p in t_out["answers"]], [p for _, p in j_out["answers"]], "probabilities")


def test_entry_points_refuse_to_fall_back_to_the_cpu(tmp_path, monkeypatch):
    """Without ``--device cpu`` and without a card, ``transfer_eval`` and
    ``predict`` stop: they never run quietly on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    jc, _ = _configs("albef")
    art = _write_assets(tmp_path, jc)
    common = ["--vocab", str(tmp_path / "vocab.txt"), "--config", str(tmp_path / "cfg.json"),
              "--answer-list", str(tmp_path / "answers.json")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttransfer.main(["--artifacts", str(art)] + common)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpredict.main(["--image", str(tmp_path / "img.jpg"), "--question", "what"] + common)
