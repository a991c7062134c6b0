"""The port's VLMo attack against the JAX package's: the losses, the
per-sample pipeline on both PGD paths with the JAX draws injected, the
answer-recovery probe, the victim check, the lockstep engine
(``BatchedVlmoAttack``), ``load_id2answer``, and ``run.py --pipeline vlmo``
on the CPU.

A 2-block tiny VLMo (the VL expert in the second) keeps the JAX side's
program compiles short.  The questions keep VLMo's raw ``?``, so the text
dialect (the ``?`` stripped and re-appended around substitution, paraphrases
encoded with a ``.``) runs in both packages.  Tolerances as in
``tests/test_torch_slice.py``: losses within 1e-3 relative, the image
within the PGD drift budget.
"""

from __future__ import annotations

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (JaxKey, fixed_topk, nchw, nhwc, synth_cli_assets, tiny_mlm,
                             tiny_vlmo, tiny_vlmo_configs)
from vqattack_tpu.attacks import vlmo as jvlmo
from vqattack_tpu.attacks.batched import BatchedVlmoAttack as JBatched
from vqattack_tpu.attacks.mar_labels import build_mar_labels as jbuild_mar_labels
from vqattack_tpu.attacks.vlmo_orchestrator import VlmoAttackPipeline as JPipeline
from vqattack_tpu.attacks.vlmo_orchestrator import load_id2answer as jload_id2answer
from vqattack_tpu.models.vlmo import VLMo as JVLMo
from vqattack_tpu.text.similarity import NullGate as JNullGate
from vqattack_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from vqattack_tpu_torch import run as port_run
from vqattack_tpu_torch.attacks import vlmo as tvlmo
from vqattack_tpu_torch.attacks.batched import BatchedVlmoAttack
from vqattack_tpu_torch.attacks.mar_labels import build_mar_labels
from vqattack_tpu_torch.attacks.vlmo_orchestrator import VlmoAttackPipeline, load_id2answer
from vqattack_tpu_torch.text.similarity import NullGate
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer

T = torch.from_numpy
# "dog-cat" re-tokenizes into three pieces: substituting it into a
# paraphrase changes the paraphrase's token count
WORDS = ["what", "color", "is", "the", "dog", "cat", "red", "blue", "hat", "a",
         "frisbee", "park", "dog-cat"]
CANDIDATES = {"dog": ["dog-cat"], "cat": ["hat"]}
ID2ANSWER = {i: f"ans{i}" for i in range(16)}


@pytest.fixture(scope="module")
def pipelines():
    j_tok, t_tok = JTokenizer.toy(WORDS), WordPieceTokenizer.toy(WORDS)
    # 12 iterations: 3 blocks of 4 for 2 substitutable words; the JAX side
    # runs its production execution (fused per-block programs)
    jc, tc = tiny_vlmo_configs(t_tok.vocab_size, depth=2, num_iters=12, dynamic_pgd=True,
                               fused_block=True)
    j_model, j_params, t_model = tiny_vlmo(jc, tc, seed=0)
    _, j_vparams, t_victim = tiny_vlmo(jc, tc, seed=1)
    j_mlm, p_mlm, t_mlm = tiny_mlm(jc, tc, seed=2)
    jp = JPipeline(jc, j_model, j_params, j_vparams, j_tok, JNullGate(), mlm_model=j_mlm,
                   mlm_params=p_mlm, id2answer=ID2ANSWER)
    tp = VlmoAttackPipeline(tc, t_model, t_tok, NullGate(), victim=t_victim, mlm_model=t_mlm,
                            id2answer=ID2ANSWER, device="cpu")
    jp.candidate_mlm_topk = tp.candidate_mlm_topk = fixed_topk(t_tok, CANDIDATES)
    return jp, tp


def _px(seed):
    return np.random.default_rng(seed).uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)


def test_vlmo_losses_match_jax(pipelines):
    """The per-sample feature loss on random stacks, and the three loss
    builders over the tiny model: values and d/dpixels (and d/dembeds)."""
    rng = np.random.default_rng(0)
    cls_a, cls_b = (rng.normal(size=(2, 3, 16)).astype(np.float32) for _ in range(2))
    tok_a, tok_b = (rng.normal(size=(2, 3, 5, 16)).astype(np.float32) for _ in range(2))
    mask = (np.arange(5) < np.array([[5], [3]])).astype(np.float32)
    np.testing.assert_allclose(
        tvlmo.vlmo_per_sample_feature_loss(T(cls_a), T(tok_a), T(cls_b), T(tok_b),
                                           T(mask)).numpy(),
        np.asarray(jvlmo.vlmo_per_sample_feature_loss(cls_a, tok_a, cls_b, tok_b, mask)),
        rtol=1e-5)

    jp, tp = pipelines
    px = _px(3)
    ids, mask = jp.encode("what color is the dog?")
    tgt_px = _px(4)
    _, cls_t, tok_t, m_t = jp._attack_feats(jp.surrogate_params, tgt_px, ids, mask)
    mar = jbuild_mar_labels("the dog is red.", "red", ["blue"], jp.tokenizer, 8, 2,
                            sentence_suffix=".")
    j_aux = {"variables": jp.surrogate_params, "text_ids": ids, "text_mask": mask,
             "rel_biases": jp._rel_biases, "tgt_layer_cls": cls_t, "tgt_tokens": tok_t,
             "tgt_token_mask": m_t.astype(jnp.float32), "mlm_ids": jnp.asarray(mar.mlm_ids[None]),
             "mlm_mask": jnp.asarray(mar.mlm_mask[None]),
             "mlm_labels": jnp.asarray(mar.labels[None])}
    t_aux = {k: (T(np.array(v)).long() if np.asarray(v).dtype.kind == "i" else T(np.array(v)))
             for k, v in j_aux.items() if k not in ("variables", "rel_biases")}
    t_aux["rel_biases"] = tp._rel_biases
    embeds = np.array(jp._embed_text(jp.surrogate_params, ids))
    for j_make, t_make, vl in ((jvlmo.make_feature_loss, tvlmo.make_feature_loss, False),
                               (jvlmo.make_mlm_loss, tvlmo.make_mlm_loss, False),
                               (jvlmo.make_vl_loss, tvlmo.make_vl_loss, True)):
        j_fn, t_fn = j_make(jp.model), t_make(tp.model)
        x = T(nchw(px)).requires_grad_(True)
        if vl:
            (j_l, j_ps), j_g = jax.jit(jax.value_and_grad(
                lambda a, e: j_fn(a, e, None, j_aux), argnums=(0, 1), has_aux=True))(
                jnp.asarray(px), jnp.asarray(embeds))
            e = T(embeds).requires_grad_(True)
            t_l, t_ps = t_fn(x, e, None, t_aux)
            g_x, g_e = torch.autograd.grad(t_l, (x, e))
            np.testing.assert_allclose(g_e.numpy(), np.asarray(j_g[1]), rtol=1e-3,
                                       atol=1e-6 * np.abs(j_g[1]).max())
            j_gx = j_g[0]
        else:
            (j_l, j_ps), j_gx = jax.jit(jax.value_and_grad(
                lambda a: j_fn(a, None, j_aux), has_aux=True))(jnp.asarray(px))
            t_l, t_ps = t_fn(x, None, t_aux)
            (g_x,) = torch.autograd.grad(t_l, x)
        np.testing.assert_allclose(t_ps.detach().numpy(), np.asarray(j_ps), rtol=1e-4)
        np.testing.assert_allclose(nhwc(g_x.numpy()), np.asarray(j_gx), rtol=1e-3,
                                   atol=1e-6 * np.abs(j_gx).max())


@pytest.mark.parametrize("paraphrase,answer", [(None, None), ("the dog is red.", "red")])
def test_attack_sample_matches_jax(pipelines, paraphrase, answer):
    """Feature-only and alternating (MAR) paths: the same block schedule,
    adversarial text and substitutions, losses within 1e-3, the image within
    the PGD drift budget (a sign flip moves a pixel by 2*eps_iter per step;
    mean |diff| under 1e-3); the victim's answer on the JAX result equal."""
    jp, tp = pipelines
    px = _px(1)
    key = jax.random.key(11)
    args = (px, "what color is the dog?", "1001", paraphrase, answer, ["red", "blue"])
    j = jp.attack_sample(*args, rng=key)
    t = tp.attack_sample(nchw(px), *args[1:], key=JaxKey(key))
    assert (t.old_alg, t.num_blocks, t.adv_text, t.substitutions) == (
        j.old_alg, j.num_blocks, j.adv_text, j.substitutions)
    assert t.old_alg == (1 if paraphrase is None else 0)
    assert t.adv_text.endswith("?") and t.substitutions
    assert t.vl_steps == t.num_blocks - 1 == 2
    np.testing.assert_allclose(t.feat_losses, j.feat_losses, rtol=1e-3)
    if paraphrase is not None:
        np.testing.assert_allclose(t.mlm_losses, j.mlm_losses, rtol=1e-3)
    d = np.abs(nhwc(t.adv_image) - j.adv_image)
    assert d.max() <= 2 * 0.01 * 14 and d.mean() < 1e-3
    assert np.abs(t.adv_image - nchw(px)).max() <= 0.125 + 1e-6
    assert tp.evaluate_victim(nchw(j.adv_image), j.adv_text) == jp.evaluate_victim(
        j.adv_image, j.adv_text)


def test_recover_answer_probe_matches_jax(pipelines):
    jp, tp = pipelines
    px = _px(2)
    args = ("the dog is red.", "red", [], tp.tokenizer, tp.max_text_len, 2)
    mar = build_mar_labels(*args, sentence_suffix=".")
    j_mar = jbuild_mar_labels("the dog is red.", "red", [], jp.tokenizer, jp.max_text_len, 2,
                              sentence_suffix=".")
    got = tp.recover_answer_probe(nchw(px), mar)
    assert isinstance(got, str) and got == jp.recover_answer_probe(jnp.asarray(px), j_mar)
    assert tp.recover_answer_probe(nchw(px), build_mar_labels(
        "a hat.", "red", [], tp.tokenizer, tp.max_text_len, 2, sentence_suffix=".")) is None


def test_evaluate_victim_batch_equals_the_single_call_and_jax(pipelines):
    jp, tp = pipelines
    rng = np.random.default_rng(5)
    images = [rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32) for _ in range(3)]
    texts = ["what color is the dog?", "is the cat red?", "dog cat hat?"]
    got = tp.evaluate_victim_batch([nchw(i) for i in images], texts)
    assert len(got) == 3 and tp.evaluate_victim_batch([], []) == []
    for img, txt, (pid, ans) in zip(images, texts, got):
        assert tp.evaluate_victim(nchw(img), txt) == (pid, ans) and ans == ID2ANSWER[pid]
    assert got == jp.evaluate_victim_batch(images, texts)


# qid, question, paraphrase, answer.  k = 2 substitutable words everywhere
# (color and the noun), 3 blocks: the feature bucket (1, 3) holds three
# samples at batch 4, so it pads to 4; in the MAR bucket (0, 3) block 0
# substitutes 2001's "dog" -> "dog-cat", which breaks its label alignment,
# while 2002's "cat" -> "hat" keeps it, so blocks 1 and 2 run the mix
SAMPLES = [
    ("1001", "what color is the dog?", None, None),
    ("1002", "what color is the cat?", None, None),
    ("1003", "what color is the hat?", None, None),
    ("2001", "what color is the dog?", "the dog is red.", "red"),
    ("2002", "what color is the cat?", "the cat is blue.", "blue"),
]


def test_batched_vlmo_matches_jax(pipelines):
    """The lockstep engine against JAX's ``BatchedVlmoAttack`` on the same
    draws: per sample the same schedule, text and substitutions, losses
    within 1e-3, the image within the drift budget; the mixed second loss
    runs in the MAR bucket's blocks 1 and 2 (2 MLM half-steps each)."""
    jp, tp = pipelines
    rng = np.random.default_rng(0)
    samples = [{"qid": qid, "question": q, "paraphrase": para, "target_answer": ans,
                "all_correct_answers": ["red", "blue"],
                "pixels": rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)}
               for qid, q, para, ans in SAMPLES]
    key = jax.random.key(7)
    j = {r.qid: r for r in JBatched(jp).run(samples, batch_size=4, rng=key)}
    tb = BatchedVlmoAttack(tp)
    mixed, calls = tb._mixed_loss, []
    tb._mixed_loss = lambda *a: calls.append(1) or mixed(*a)
    t = tb.run([dict(s, pixels=nchw(s["pixels"])) for s in samples], batch_size=4,
               rng=JaxKey(key))
    assert len(calls) == 4
    # bucket order: (old_alg, k) = (0, 3), then (1, 3) padded to 4
    assert [r.qid for r in t] == ["2001", "2002", "1001", "1002", "1003"]
    assert tb.last_chunk_sizes == [2, 4] and tb.last_occupancy == 5 / 6
    for r in t:
        jr = j[r.qid]
        assert (r.old_alg, r.num_blocks, r.adv_text, r.substitutions) == (
            jr.old_alg, jr.num_blocks, jr.adv_text, jr.substitutions)
        np.testing.assert_allclose(r.feat_losses, jr.feat_losses, rtol=1e-3)
        if r.old_alg == 0:
            np.testing.assert_allclose(r.mlm_losses, jr.mlm_losses, rtol=1e-3)
        d = np.abs(nhwc(r.adv_image) - jr.adv_image)
        assert d.max() <= 2 * 0.01 * 14 and d.mean() < 1e-3
    assert t[0].substitutions[0] == ("dog", "dog-cat") and t[0].adv_text.endswith("?")


def test_load_id2answer_reads_json_and_a_pickle(tmp_path):
    table = {0: "yes", 3: "two", 3128: "frisbee"}
    (tmp_path / "a.json").write_text(json.dumps({str(k): v for k, v in table.items()}))
    (tmp_path / "a.pkl").write_bytes(pickle.dumps(table))
    for name in ("a.json", "a.pkl"):
        path = str(tmp_path / name)
        assert load_id2answer(path) == jload_id2answer(path) == table


def _vlmo_argv(tmp_path):
    argv = synth_cli_assets(tmp_path, [
        (1001, "what color is the dog", "red", "the dog is red"),
        (1002, "what is the man holding", "frisbee", None)])
    i = argv.index("--answer-list")  # the VLMo victim needs no answer list
    del argv[i : i + 2]
    (tmp_path / "id2answer.json").write_text(json.dumps({str(i): f"ans{i}" for i in range(16)}))
    return argv + ["--pipeline", "vlmo", "--id2answer", str(tmp_path / "id2answer.json")]


def test_cli_vlmo_runs_on_cpu(tmp_path, capsys):
    """Per-sample and batched (``--batch-size 2 --attn flash``): the
    artifacts of both samples; ``--arrow`` reads the tables it names (a
    missing one stops the run)."""
    argv = _vlmo_argv(tmp_path)
    for extra, out in (([], "out"), (["--batch-size", "2", "--attn", "flash"], "out_b")):
        summary = port_run.main(argv + extra + ["--output", str(tmp_path / out)])
        assert summary["samples"] == 2 and summary["pipeline"] == "vlmo"
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
        for qid in ("1001", "1002"):
            img = torch.load(tmp_path / out / f"{qid}.pt")
            assert img.shape == (1, 3, 32, 32) and float(img.abs().max()) <= 1.0
        texts = json.loads((tmp_path / out / "adv_txt_dict.json").read_text())
        assert set(texts) == {"1001", "1002"}
    pytest.importorskip("pyarrow")
    with pytest.raises(FileNotFoundError):
        port_run.main(argv + ["--arrow", str(tmp_path / "vqav2_val.arrow")])


def test_vlmo_entry_points_refuse_to_fall_back_to_the_cpu(monkeypatch, tmp_path, pipelines):
    _, tp = pipelines
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VlmoAttackPipeline(tp.cfg, tp.model, tp.tokenizer, NullGate())
    argv = [a for a in _vlmo_argv(tmp_path) if a != "cpu"]
    argv.remove("--device")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_run.main(argv)
