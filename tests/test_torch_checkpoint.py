"""The port's checkpoint path against the JAX package's.

Synthetic checkpoints in the reference's names (``checkpoint/synthetic.py``,
every tensor from a numpy seed) go through the JAX loaders followed by
``load_jax_params`` and through the port's loaders: the parameters must be
the same bit for bit, apart from the resized position grid and relative
table (within 1e-6 of their largest value), and the loaded models' forwards
agree with flax's within the model tests' tolerances.  ALBEF runs at a
narrow width (32) and the reference's depth (ViT 12, BERT 12 with fusion
from 6, decoder 6), so the JAX loaders run exactly as the JAX CLI calls
them; VLMo at a tiny depth against ``convert_vlmo(sd, depth=...)`` (the JAX
``load_vlmo`` converts 12 blocks whatever the depth).  Also: the Hugging
Face BERT directory in both file formats, the interpolations, the named
configs, the gate calibration and the CLI's refusals.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from torch_port_util import jit_apply, nchw
from vqattack_tpu import config as jcfg
from vqattack_tpu import named_configs as jnamed
from vqattack_tpu.checkpoint import convert as jconvert
from vqattack_tpu.checkpoint import interpolate as jinterp
from vqattack_tpu.checkpoint import io as jio
from vqattack_tpu.models.albef import AlbefPretrain as JAlbefPretrain
from vqattack_tpu.models.albef import AlbefVQA as JAlbefVQA
from vqattack_tpu.models.bert import FusionBert as JFusionBert
from vqattack_tpu.models.vlmo import VLMo as JVLMo
from vqattack_tpu.text import calibrate as jcalibrate
from vqattack_tpu_torch import config as tcfg
from vqattack_tpu_torch import named_configs as tnamed
from vqattack_tpu_torch import run as port_run
from vqattack_tpu_torch.checkpoint import interpolate as tinterp
from vqattack_tpu_torch.checkpoint import io as tio
from vqattack_tpu_torch.checkpoint import synthetic
from vqattack_tpu_torch.checkpoint.convert import load_jax_params
from vqattack_tpu_torch.models.albef import AlbefPretrain, AlbefVQA
from vqattack_tpu_torch.models.bert import FusionBert
from vqattack_tpu_torch.models.vlmo import VLMo, init_vlmo_weights
from vqattack_tpu_torch.text import calibrate as tcalibrate

VOCAB = 64


def _close(got, want, rtol, atol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * scale)


def _both(cfg: tcfg.RunConfig):
    """(JAX RunConfig, port RunConfig) of one geometry."""
    return jcfg.run_config_from_dict(tcfg.to_dict(cfg)), cfg


def albef_configs(image_size=64):
    """Width 32 at the reference's depth: ViT 12, BERT 12 (fusion from 6),
    decoder 6, as the JAX loaders' defaults convert."""
    c = tcfg.tiny_test_config(image_size=image_size, vocab_size=VOCAB)
    albef = dataclasses.replace(
        c.albef, vit=dataclasses.replace(c.albef.vit, depth=12),
        bert=dataclasses.replace(c.albef.bert, num_layers=12, fusion_layer=6), decoder_layers=6)
    return _both(dataclasses.replace(c, albef=albef))


def assert_trees_match(port_tree, jax_tree, resized=()):
    """Every leaf bit for bit, those under a path in ``resized`` within 1e-6
    of their largest value; the same leaves on both sides."""
    if "params" in jax_tree:
        jax_tree = jax_tree["params"]
    j = {jax.tree_util.keystr(k): np.asarray(v)
         for k, v in jax.tree_util.tree_leaves_with_path(jax_tree)}
    t = {jax.tree_util.keystr(k): np.asarray(v)
         for k, v in jax.tree_util.tree_leaves_with_path(port_tree)}
    assert sorted(t) == sorted(j)
    for k, want in j.items():
        got = t[k]
        assert got.shape == want.shape and got.dtype == np.float32, k
        if any(r in k for r in resized):
            assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max(), k
        else:
            np.testing.assert_array_equal(got, want, err_msg=k)


def assert_modules_match(a: torch.nn.Module, b: torch.nn.Module, resized=()):
    sa, sb = a.state_dict(), b.state_dict()
    assert sorted(sa) == sorted(sb)
    for k in sa:
        if any(r in k for r in resized):
            assert (sa[k] - sb[k]).abs().max() <= 1e-6 * sb[k].abs().max(), k
        else:
            assert torch.equal(sa[k], sb[k]), k


def _inputs(size, b=2, text_len=8, seed=0):
    rng = np.random.default_rng(seed)
    px = rng.uniform(-1, 1, (b, size, size, 3)).astype(np.float32)
    ids = rng.integers(5, VOCAB, (b, text_len)).astype(np.int32)
    ids[:, 0] = 2
    mask = np.ones_like(ids)
    mask[1, text_len - 2:] = 0
    ids[1, text_len - 2:] = 0
    return px, ids, mask


def _long(a):
    return torch.from_numpy(np.asarray(a)).long()


# ---------------------------------------------------------------------------
# ALBEF
# ---------------------------------------------------------------------------


def test_albef_pretrain_loader_matches_jax(tmp_path):
    """``{'model': sd, 'config': ...}`` at 32 px -> 64 px: the JAX loader
    and ``load_jax_params`` against the port's loader, and gen_feats."""
    jc, tc = albef_configs()
    sd = synthetic.albef_pretrain_state_dict(tc.albef, seed=1, src_image_size=32)
    path = tmp_path / "ALBEF.pth"
    torch.save({"model": sd, "config": {"image_res": 32}, "epoch": 30}, path)
    j_tree = jio.load_albef_pretrain(str(path), image_size=64)
    assert_trees_match(tio.load_albef_pretrain(str(path), tc.albef), j_tree, ["pos_embed"])
    port = tio.load_albef_pretrain(str(path), tc.albef, into=AlbefPretrain(tc.albef)).eval()
    assert_modules_match(port, load_jax_params(AlbefPretrain(tc.albef), j_tree), ["pos_embed"])
    assert torch.equal(port.text_encoder.layer[7].crossattention_self.key.weight,
                       sd["text_encoder.bert.encoder.layer.7.crossattention.self.key.weight"])

    px, ids, mask = _inputs(64)
    j_img, j_txt, j_logits = JAlbefPretrain(jc.albef).apply(
        j_tree, px, ids, mask, method=JAlbefPretrain.gen_feats)
    with torch.no_grad():
        img, txt, logits = port.gen_feats(torch.from_numpy(nchw(px)), _long(ids), _long(mask))
    _close(img, j_img, 1e-4, 1e-5)
    _close(txt, j_txt, 1e-4, 1e-5)
    _close(logits, j_logits, 1e-4, 1e-5)


@pytest.mark.parametrize("encoder", ["text_encoder.", "text_encoder.bert."])
def test_albef_vqa_loader_matches_jax(tmp_path, encoder):
    """The VQA file at 48 px -> 64 px, its question encoder under either
    prefix: parameters, and the victim's ranked answers."""
    jc, tc = albef_configs()
    sd = synthetic.albef_vqa_state_dict(tc.albef, seed=2, src_image_size=48)
    if encoder != "text_encoder.":
        sd = {(encoder + k[len("text_encoder."):] if k.startswith("text_encoder.") else k): v
              for k, v in sd.items()}
    path = tmp_path / "vqa.pth"
    torch.save({"model": sd}, path)
    j_tree = jio.load_albef_vqa(str(path), image_size=64)
    assert_trees_match(tio.load_albef_vqa(str(path), tc.albef), j_tree, ["pos_embed"])
    port = tio.load_albef_vqa(str(path), tc.albef, into=AlbefVQA(tc.albef)).eval()
    assert_modules_match(port, load_jax_params(AlbefVQA(tc.albef), j_tree), ["pos_embed"])

    px, ids, mask = _inputs(64, seed=3)
    rng = np.random.default_rng(4)
    a_ids = rng.integers(5, VOCAB, (6, 4)).astype(np.int32)
    a_ids[:, 0] = 2
    a_mask = np.ones_like(a_ids)
    a_mask[2:, 3] = a_ids[2:, 3] = 0
    j_ids, j_probs = JAlbefVQA(jc.albef).apply(j_tree, px, ids, mask, a_ids, a_mask, 4)
    with torch.no_grad():
        t_ids, t_probs = port(torch.from_numpy(nchw(px)), _long(ids), _long(mask),
                              _long(a_ids), _long(a_mask), 4)
    np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids))
    np.testing.assert_allclose(t_probs.numpy(), np.asarray(j_probs), atol=1e-4)


def test_albef_loader_names_a_missing_trunk_tensor(tmp_path):
    _, tc = albef_configs()
    sd = synthetic.albef_pretrain_state_dict(tc.albef, seed=1, src_image_size=32)
    del sd["visual_encoder.blocks.4.mlp.fc2.bias"]
    torch.save({"model": sd}, tmp_path / "ALBEF.pth")
    with pytest.raises(KeyError, match="visual_encoder.blocks.4.mlp.fc2.bias"):
        tio.load_albef_pretrain(str(tmp_path / "ALBEF.pth"), tc.albef,
                                into=AlbefPretrain(tc.albef))


# ---------------------------------------------------------------------------
# the candidate MLM from a Hugging Face directory
# ---------------------------------------------------------------------------


def _mlm_module(bert_cfg):
    return FusionBert(dataclasses.replace(bert_cfg, fusion_layer=bert_cfg.num_layers),
                      with_mlm_head=True)


def _check_mlm(directory, jc, tc, sd_source=None):
    """The port's MLM from ``directory`` against JAX ``load_hf_bert_mlm``:
    parameters bit for bit, and the text-mode MLM logits."""
    j_tree = jio.load_hf_bert_mlm(str(directory))
    assert_trees_match(tio.load_hf_bert_mlm(str(directory)), j_tree)
    port = tio.load_hf_bert_mlm(str(directory), into=_mlm_module(tc.albef.bert)).eval()
    assert_modules_match(port, load_jax_params(_mlm_module(tc.albef.bert), j_tree))
    _, ids, mask = _inputs(32, seed=5)
    j_cfg = dataclasses.replace(jc.albef.bert, fusion_layer=jc.albef.bert.num_layers)
    _, _, j_logits = jit_apply(JFusionBert(j_cfg, with_mlm_head=True), j_tree, ids, mask,
                               mode="text")
    with torch.no_grad():
        _, _, logits = port(_long(ids), _long(mask), mode="text")
    _close(logits, j_logits, 1e-4, 1e-5)
    return port


@pytest.mark.parametrize("safetensors", [True, False])
def test_hf_bert_mlm_directory_matches_jax(tmp_path, safetensors):
    """``BertForMaskedLM.save_pretrained`` in both formats (the port reads
    them without transformers)."""
    transformers = pytest.importorskip("transformers")
    jc, tc = _both(tcfg.tiny_test_config(vocab_size=VOCAB))
    b = tc.albef.bert
    torch.manual_seed(0)
    model = transformers.BertForMaskedLM(transformers.BertConfig(
        vocab_size=b.vocab_size, hidden_size=b.hidden_size, num_hidden_layers=b.num_layers,
        num_attention_heads=b.num_heads, intermediate_size=b.intermediate_size,
        max_position_embeddings=b.max_position_embeddings, layer_norm_eps=b.layer_norm_eps))
    model.save_pretrained(tmp_path, safe_serialization=safetensors)
    names = {p.name for p in tmp_path.iterdir()}
    assert ("model.safetensors" in names) == safetensors
    assert ("pytorch_model.bin" in names) == (not safetensors)
    _check_mlm(tmp_path, jc, tc)


def test_hf_bert_mlm_reads_the_tf_spelling_and_ties_the_decoder(tmp_path):
    """The original bert-base-uncased file: ``gamma``/``beta`` LayerNorms,
    no decoder weight (tied to the word embeddings), a pooler and the
    next-sentence head beside the MLM head."""
    pytest.importorskip("transformers")
    jc, tc = _both(tcfg.tiny_test_config(vocab_size=VOCAB))
    sd = synthetic.hf_bert_mlm_state_dict(tc.albef.bert, seed=6)
    assert "bert.embeddings.LayerNorm.gamma" in sd
    assert "cls.predictions.decoder.weight" not in sd
    synthetic.save_hf_bert_dir(str(tmp_path), tc.albef.bert, sd)
    port = _check_mlm(tmp_path, jc, tc)
    assert torch.equal(port.mlm_head.decoder.weight, sd["bert.embeddings.word_embeddings.weight"])
    assert torch.equal(port.embeddings.LayerNorm.weight, sd["bert.embeddings.LayerNorm.gamma"])
    (tmp_path / "pytorch_model.bin").unlink()
    with pytest.raises(FileNotFoundError, match="no model.safetensors or pytorch_model.bin"):
        tio.load_hf_bert_mlm(str(tmp_path))


def test_read_safetensors_matches_the_package(tmp_path):
    """Every dtype the reader takes, against the ``safetensors`` package;
    a truncated file and offsets past the data raise."""
    st = pytest.importorskip("safetensors.torch")
    rng = np.random.default_rng(7)
    tensors = {
        "f32": torch.from_numpy(rng.normal(size=(3, 5)).astype(np.float32)),
        "f16": torch.from_numpy(rng.normal(size=(4,)).astype(np.float16)),
        "bf16": torch.from_numpy(rng.normal(size=(2, 3)).astype(np.float32)).bfloat16(),
        "f64": torch.from_numpy(rng.normal(size=(2,))),
        "i64": torch.arange(6).reshape(1, 6),
        "scalar": torch.tensor(1.5),
    }
    path = tmp_path / "m.safetensors"
    st.save_file(tensors, str(path), metadata={"format": "pt"})
    got = tio.read_safetensors(str(path))
    assert sorted(got) == sorted(tensors)
    for k, v in tensors.items():
        assert got[k].dtype == np.float32 and got[k].shape == tuple(v.shape), k
        np.testing.assert_array_equal(got[k], v.float().numpy(), err_msg=k)
    raw = path.read_bytes()
    (tmp_path / "short.safetensors").write_bytes(raw[:-4])
    with pytest.raises(ValueError, match="offsets"):
        tio.read_safetensors(str(tmp_path / "short.safetensors"))
    (tmp_path / "head.safetensors").write_bytes(raw[:12])
    with pytest.raises(ValueError, match="header"):
        tio.read_safetensors(str(tmp_path / "head.safetensors"))


# ---------------------------------------------------------------------------
# VLMo
# ---------------------------------------------------------------------------


def vlmo_configs(**kw):
    """Tiny VLMo at 64 px (window 4): depth 4, width 32, the VL expert in
    the last block."""
    c = tcfg.tiny_test_config(image_size=64, vocab_size=VOCAB)
    return _both(dataclasses.replace(c, vlmo=dataclasses.replace(c.vlmo, **kw)))


BASE_PLUS = dict(use_abs_pos_emb=True, need_relative_position_embed=False, layer_scale_init=None)
VLMO_CASES = {
    # a pre-trained surrogate at 48 px (window 3) in a deepspeed envelope:
    # no VQA classifier; the relative table resized 5x5 -> 7x7
    "surrogate": ({}, 48, synthetic.VLMO_PRETRAIN_HEADS, "module"),
    # a fine-tuned victim at the run's size with an NLVR2 head beside
    "victim": ({}, None, ("vqa_classifier", "nlvr2_classifier"), "state_dict"),
    # the abs-pos family (base_plus): pos_embed resized, no table, no layer scale
    "base_plus": (BASE_PLUS, 48, synthetic.VLMO_PRETRAIN_HEADS + ("vqa_classifier",), None),
    # deeper than the 12 blocks the JAX load_vlmo converts (large has 24):
    # the port converts the config's depth
    "deep": (dict(depth=13, vlffn_start_layer=12), None, synthetic.VLMO_VQA_HEADS, None),
}


@pytest.mark.parametrize("case", sorted(VLMO_CASES))
def test_vlmo_loader_matches_jax(tmp_path, capsys, case):
    kw, src, heads, envelope = VLMO_CASES[case]
    jc, tc = vlmo_configs(**kw)
    sd = synthetic.vlmo_state_dict(tc.vlmo, seed=8, src_image_size=src, heads=heads)
    path = tmp_path / "vlmo.pt"
    if envelope == "module":
        torch.save({"module": {f"module.{k}": v for k, v in sd.items()}}, path)
    elif envelope:
        torch.save({envelope: sd, "hyper_parameters": {"image_size": src}}, path)
    else:
        torch.save(sd, path)
    geometry = {}
    if src is not None:
        geometry = dict(new_window=64 // 16, src_window=src // 16)
    j_tree = jconvert.convert_vlmo(jconvert.load_torch_checkpoint(str(path)),
                                   depth=tc.vlmo.depth, **geometry)
    resized = ["relative_position_bias_table", "pos_embed"]
    assert_trees_match(tio.load_vlmo(str(path), tc.vlmo, src_image_size=src), j_tree, resized)

    fresh = init_vlmo_weights(VLMo(tc.vlmo), seed=9)
    port = tio.load_vlmo(str(path), tc.vlmo, src_image_size=src,
                         into=init_vlmo_weights(VLMo(tc.vlmo), seed=9)).eval()
    line = capsys.readouterr().out
    absent = [h for h in tio.VLMO_OPTIONAL_HEADS
              if h not in j_tree and getattr(port, h, None) is not None]
    dropped = [h for h in tio.VLMO_DROPPED_HEADS if h in j_tree]
    assert bool(line) == bool(absent or dropped)
    for h in absent + dropped:
        assert h in line
    for name, p in port.named_parameters():
        if name.split(".")[0] in absent:
            assert torch.equal(p, dict(fresh.named_parameters())[name]), name
    j_params = {k: v for k, v in j_tree.items() if k not in tio.VLMO_DROPPED_HEADS}
    assert_modules_match(port, load_jax_params(init_vlmo_weights(VLMo(tc.vlmo), seed=9),
                                               j_params, absent), resized)

    px, ids, mask = _inputs(64, text_len=tc.vlmo.max_text_len, seed=10)
    j = JVLMo(jc.vlmo).apply({"params": j_tree}, ids, mask, px, method=JVLMo.infer)
    with torch.no_grad():
        t = port.infer(_long(ids), _long(mask), torch.from_numpy(nchw(px)))
    for k in ("text_feats", "image_feats", "cls_feats", "feats"):
        _close(t[k], j[k], 1e-4, 1e-5)
    if "vqa_classifier" in heads:
        j_logits = JVLMo(jc.vlmo).apply({"params": j_tree}, px, ids, mask,
                                         method=JVLMo.vqa_logits)
        with torch.no_grad():
            logits = port.vqa_logits(torch.from_numpy(nchw(px)), _long(ids), _long(mask))
        _close(logits, j_logits, 1e-4, 1e-5)


def test_vlmo_loader_names_a_missing_trunk_tensor(tmp_path):
    _, tc = vlmo_configs()
    sd = synthetic.vlmo_state_dict(tc.vlmo, seed=8)
    del sd["transformer.blocks.3.mlp_vl.fc1.bias"]
    torch.save(sd, tmp_path / "vlmo.pt")
    with pytest.raises(KeyError, match="transformer.blocks.3.mlp_vl.fc1.bias"):
        tio.load_vlmo(str(tmp_path / "vlmo.pt"), tc.vlmo, into=VLMo(tc.vlmo))


# ---------------------------------------------------------------------------
# geometry, named configs, calibration
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("orig,new,dim", [(14, 30, 32), (2, 4, 8), (3, 4, 16), (30, 30, 4),
                                          (16, 30, 32), (24, 30, 16)])
def test_interpolate_pos_embed_matches_jax(orig, new, dim):
    """The port makes the reference's float32 ``F.interpolate`` call, whose
    source coordinates are rounded to float32; the JAX package emulates it in
    float64.  They agree within 1e-6 of the largest value from a 224 px
    source (14 -> 30, the VLMo and ALBEF surrogates) and in the tiny
    geometries, and within 1e-5 (the JAX package's own bound against the
    reference's call) from ALBEF's 256 and 384 px sources."""
    pos = np.random.default_rng(orig).normal(size=(1, orig * orig + 1, dim)).astype(np.float32)
    got = tinterp.interpolate_pos_embed(pos, new * new)
    want = jinterp.interpolate_pos_embed(pos, new * new)
    assert got.shape == want.shape == (1, new * new + 1, dim) and got.dtype == np.float32
    bound = 1e-5 if orig in (16, 24) else 1e-6 * np.abs(want).max()
    assert np.abs(got - want).max() <= bound
    np.testing.assert_array_equal(got[:, :1], pos[:, :1])
    grid = torch.from_numpy(pos[:, 1:]).reshape(1, orig, orig, dim).permute(0, 3, 1, 2)
    ref = torch.nn.functional.interpolate(grid, size=(new, new), mode="bicubic",
                                          align_corners=False)
    np.testing.assert_array_equal(got[0, 1:], ref[0].permute(1, 2, 0).reshape(-1, dim).numpy())


@pytest.mark.parametrize("src,dst,extra", [(27, 59, 397), (5, 7, 0), (3, 7, 4)])
def test_interpolate_rel_pos_bias_matches_jax(src, dst, extra):
    """The real 224 -> 480 grid (27 -> 59, VLMo's 397 trailing rows) and
    small ones, including the quadratic fit of a 3-grid."""
    table = np.random.default_rng(src).normal(size=(src * src + extra, 3)).astype(np.float32)
    got = tinterp.interpolate_rel_pos_bias(table, src, dst)
    want = jinterp.interpolate_rel_pos_bias(table, src, dst)
    assert got.shape == (dst * dst + extra, 3)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tinterp._geometric_points(src, dst),
                                  jinterp._geometric_points(src, dst))


VQA_NAMES = sorted(n for n in jnamed.NAMED if n.startswith("task_finetune_vqa"))


@pytest.mark.parametrize("names", [(n,) for n in VQA_NAMES] + [(VQA_NAMES[0], "step3k")])
def test_named_configs_match_jax(names):
    assert tnamed.NAMED == jnamed.NAMED and tnamed.VLMO_BASE == jnamed.VLMO_BASE
    named = tnamed.vlmo_named_config(*names)
    assert named == jnamed.vlmo_named_config(*names)
    got = dataclasses.asdict(tnamed.vlmo_config_from_named(named))
    assert got == dataclasses.asdict(jnamed.vlmo_config_from_named(named))
    assert got["image_size"] == 480


class _BagOfWordsGate:
    """A stub gate: cosine of hashed bag-of-words vectors, the same numbers
    in either package."""

    def scores(self, reference, candidates):
        def emb(text):
            v = np.zeros(16, np.float32)
            for i, w in enumerate(text.split()):
                v[sum(map(ord, w)) % 16] += 1.0 + 0.1 * i
            return v / max(np.linalg.norm(v), 1e-9)

        r = emb(reference)
        return np.asarray([emb(c) @ r for c in candidates], np.float32)


def test_gate_calibration_matches_jax():
    questions = ["what color is the dog", "what is the man holding", "how many cats are there",
                 "is the woman wearing a hat", "what is on the table", "where is the ball",
                 "no", "what color is the frisbee"]
    t_prof = tcalibrate.gate_score_profile(_BagOfWordsGate(), questions, seed=3)
    j_prof = jcalibrate.gate_score_profile(_BagOfWordsGate(), questions, seed=3)
    assert sorted(t_prof.scores) == sorted(j_prof.scores)
    for k in t_prof.scores:
        np.testing.assert_array_equal(t_prof.scores[k], j_prof.scores[k])
    assert t_prof.table() == j_prof.table()
    assert tcalibrate.suggest_threshold(t_prof) == jcalibrate.suggest_threshold(j_prof)
    with pytest.raises(ValueError, match="not enough calibration data"):
        tcalibrate.suggest_threshold(tcalibrate.gate_score_profile(_BagOfWordsGate(), ["a b"]))


# ---------------------------------------------------------------------------
# the CLI's refusals
# ---------------------------------------------------------------------------


def _args(*extra):
    return port_run.build_argparser().parse_args(["--vocab", "vocab.txt", *extra])


def test_named_config_sets_the_vlmo_geometry_and_refuses_what_it_cannot_run():
    """``--named-config`` sets VLMo's geometry (the attack preset's remat
    kept) and is VLMo's only; ``--attn flash`` on the card takes base_plus
    (544 over 16 heads: head dim 34) and refuses a head dim the kernels do
    not take; ``--arrow`` is VLMo's data."""
    large = port_run.resolve_config(_args("--pipeline", "vlmo", "--attn", "flash",
                                          "--named-config", "task_finetune_vqa_large_image480"))
    assert (large.vlmo.depth, large.vlmo.hidden_size, large.vlmo.num_heads) == (24, 1024, 16)
    assert large.vlmo.remat == tcfg.vlmo_attack_config().vlmo.remat
    plus = ["--pipeline", "vlmo", "--named-config", "task_finetune_vqa_base_plus_image480"]
    assert port_run.resolve_config(_args(*plus)).vlmo.use_abs_pos_emb
    assert port_run.resolve_config(_args(*plus, "--attn", "flash", "--device", "cpu"))
    card = port_run.resolve_config(_args(*plus, "--attn", "flash")).vlmo
    assert (card.depth, card.hidden_size, card.num_heads) == (24, 544, 16)
    assert card.hidden_size // card.num_heads == 34 and not card.need_relative_position_embed
    with pytest.raises(SystemExit, match="--named-config presets are the VLMo pipeline's"):
        port_run.resolve_config(_args("--named-config", "task_finetune_vqa_base_image480"))
    with pytest.raises(KeyError, match="unknown named config"):
        port_run.resolve_config(_args("--pipeline", "vlmo", "--named-config", "no_such"))
    assert port_run.resolve_config(_args("--pipeline", "vlmo", "--arrow", "vqav2_val.arrow"))
    with pytest.raises(SystemExit, match="--arrow: the arrow tables are the VLMo pipeline's"):
        port_run.resolve_config(_args("--arrow", "vqav2_val.arrow"))


def test_load_jax_params_leaves_out_only_the_named_optional_heads():
    """A head may be absent only when ``optional`` names it; it then keeps
    its values."""
    _, tc = vlmo_configs()
    sd = {k: v.numpy() for k, v in synthetic.vlmo_state_dict(
        tc.vlmo, seed=8, heads=("itm_score", "itc", "itc_vl", "vqa_classifier")).items()}
    tree = jconvert.convert_vlmo(sd, depth=tc.vlmo.depth)
    model = init_vlmo_weights(VLMo(tc.vlmo), seed=0)
    with pytest.raises(KeyError, match="no flax leaf mlm_score/"):
        load_jax_params(model, tree)
    before = model.mlm_score.decoder.weight.clone()
    load_jax_params(model, tree, optional=("mlm_score",))
    assert torch.equal(model.mlm_score.decoder.weight, before)
    assert torch.equal(model.itm_score.weight, torch.from_numpy(sd["itm_score.fc.weight"]))
