"""The port's lockstep engine (``attacks/batched.py``) against the JAX
package's on the same tiny weights and the JAX draws: a feature bucket
padded to a power of two, and a MAR bucket whose first block runs the MLM
loss and whose later blocks run the mixed loss, after a substitution breaks
one sample's label alignment; pipelined chunks against serial ones; the
batched victim check; and the CLI's batched path with the flash attention
branch on."""

from __future__ import annotations

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (JaxKey, fixed_topk, nchw, nhwc, shallow_albef, synth_cli_assets,
                             tiny_configs, tiny_models)
from vqattack_tpu.attacks import text_attack as jtext
from vqattack_tpu.attacks.batched import BatchedAlbefAttack as JBatched
from vqattack_tpu.attacks.orchestrator import AlbefAttackPipeline as JPipeline
from vqattack_tpu.text.similarity import NullGate as JNullGate
from vqattack_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from vqattack_tpu_torch import run as port_run
from vqattack_tpu_torch.attacks import text_attack as ttext
from vqattack_tpu_torch.attacks.batched import BatchedAlbefAttack, PhaseTimer
from vqattack_tpu_torch.attacks.orchestrator import AlbefAttackPipeline
from vqattack_tpu_torch.ops import attention
from vqattack_tpu_torch.text.similarity import NullGate
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer

# "dog-cat" re-tokenizes into three pieces: substituting it into a
# paraphrase changes the paraphrase's token count
WORDS = ["what", "color", "is", "the", "dog", "cat", "red", "blue", "hat", "a",
         "frisbee", "park", "dog-cat"]
# the candidate MLM's top-k, the same for both packages: each word's
# substitutes (every other position scores under the 0.3 threshold)
CANDIDATES = {"dog": ["dog-cat"], "cat": ["hat"]}

# qid, question, paraphrase, answer.  k = 2 substitutable words everywhere
# (color and the noun), 3 blocks: the feature bucket (1, 3) holds three
# samples at batch 4, so it pads to 4; in the MAR bucket (0, 3) block 0
# substitutes 2001's "dog" -> "dog-cat", which breaks its label alignment,
# while 2002's "cat" -> "hat" keeps it, so blocks 1 and 2 run the mix
SAMPLES = [
    ("1001", "what color is the dog", None, None),
    ("1002", "what color is the cat", None, None),
    ("1003", "what color is the hat", None, None),
    ("2001", "what color is the dog", "the dog is red.", "red"),
    ("2002", "what color is the cat", "the cat is blue.", "blue"),
]
ATK = dict(eps=0.125, eps_iter=0.01)


@pytest.fixture(scope="module")
def engines():
    j_tok, t_tok = JTokenizer.toy(WORDS), WordPieceTokenizer.toy(WORDS)
    # 12 iterations: 3 blocks of 4; the JAX side runs its production
    # execution (fused per-block programs).  ALBEF is cut to one ViT block,
    # one text and one fusion layer and a one-layer answer decoder
    # (``shallow_albef``): the file's time is the JAX engine's four
    # block-program compiles, which scale with depth, not with the
    # iteration count.
    jc, tc = (shallow_albef(c) for c in tiny_configs(
        t_tok.vocab_size, num_iters=12, dynamic_pgd=True, fused_block=True))
    (j_sur, j_vic, j_mlm), (p_sur, p_vic, p_mlm), (t_sur, t_vic, t_mlm) = tiny_models(jc, tc)
    jp = JPipeline(jc, j_sur, p_sur, j_tok, JNullGate(), victim=j_vic, victim_params=p_vic,
                   mlm_model=j_mlm, mlm_params=p_mlm)
    tp = AlbefAttackPipeline(tc, t_sur, t_tok, NullGate(), victim=t_vic, mlm_model=t_mlm,
                             device="cpu")
    jp.candidate_mlm_topk = tp.candidate_mlm_topk = fixed_topk(t_tok, CANDIDATES)
    rng = np.random.default_rng(0)
    samples = []
    for qid, q, para, ans in SAMPLES:
        samples.append({"qid": qid, "question": q, "paraphrase": para, "target_answer": ans,
                        "all_correct_answers": ["red", "blue"],
                        "pixels": rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)})
    return JBatched(jp), BatchedAlbefAttack(tp), samples


def _port_samples(samples):
    return [dict(s, pixels=nchw(s["pixels"])) for s in samples]


@pytest.fixture(scope="module")
def runs(engines):
    """Both engines on the same samples and key; the port's mixed second
    loss counts its calls."""
    jb, tb, samples = engines
    key = jax.random.key(7)
    j = jb.run(samples, batch_size=4, rng=key)
    mixed, calls = tb._mixed_loss, []
    tb._mixed_loss = lambda *a: calls.append(1) or mixed(*a)
    try:
        t = tb.run(_port_samples(samples), batch_size=4, rng=JaxKey(key))
    finally:
        tb._mixed_loss = mixed
    # blocks 1 and 2 of the MAR bucket: 2 MLM half-steps each
    assert len(calls) == 4
    return j, t


def test_buckets_and_padding(engines, runs):
    _, tb, samples = engines
    j, t = runs
    assert [r.qid for r in t] == [r.qid for r in j]
    assert sorted(r.qid for r in t) == sorted(s["qid"] for s in samples)
    # chunks in bucket order: (0, 3) x2, (1, 3) 3 -> 4
    assert tb.last_chunk_sizes == [2, 4]
    assert tb.last_occupancy == pytest.approx(5 / 6)


@pytest.mark.parametrize("qids", [("1001", "1002", "1003"), ("2001", "2002")],
                         ids=["feature_padded", "mar_then_mixed"])
def test_bucket_matches_jax(runs, qids):
    """Per bucket: the same adversarial texts and substitutions, losses
    within 1e-3, and images within the PGD drift budget of
    ``test_attack_sample_matches_jax`` (a sign flip moves a pixel by
    2*eps_iter per step; mean |diff| under 1e-3)."""
    j, t = (dict((r.qid, r) for r in rs) for rs in runs)
    for qid in qids:
        a, b = t[qid], j[qid]
        assert (a.old_alg, a.num_blocks, a.adv_text, a.substitutions) == (
            b.old_alg, b.num_blocks, b.adv_text, b.substitutions)
        np.testing.assert_allclose(a.feat_losses, b.feat_losses, rtol=1e-3)
        if b.mlm_losses is None:
            assert a.mlm_losses is None
        else:
            np.testing.assert_allclose(a.mlm_losses, b.mlm_losses, rtol=1e-3)
        steps = len(a.feat_losses) + (0 if a.mlm_losses is None else len(a.mlm_losses))
        steps += a.vl_steps
        d = np.abs(nhwc(a.adv_image) - b.adv_image)
        assert d.max() <= 2 * ATK["eps_iter"] * steps and d.mean() < 1e-3
        assert np.abs(a.adv_image).max() <= 1.0
    if qids[0] == "2001":
        # the mixed second loss ran in blocks 1 and 2: 2001's alignment broke
        assert t["2001"].substitutions[0] == ("dog", "dog-cat")
        assert t["2002"].substitutions[0] == ("cat", "hat")


def test_pipelined_chunks_equal_serial(engines, runs):
    _, tb, samples = engines
    _, serial = runs
    piped = tb.run(_port_samples(samples), batch_size=4, rng=JaxKey(jax.random.key(7)),
                   pipeline_depth=2)
    assert [r.qid for r in piped] == [r.qid for r in serial]
    for a, b in zip(piped, serial):
        assert (a.adv_text, a.substitutions) == (b.adv_text, b.substitutions)
        assert np.array_equal(a.adv_image, b.adv_image)
        assert np.array_equal(a.feat_losses, b.feat_losses)


def test_evaluate_victim_batch_matches_jax(engines, runs):
    """Three pairs, padded to four: the same ranked answers as the JAX
    package's batched victim call on the same images and texts."""
    jb, tb, _ = engines
    j, _ = runs
    rng = np.random.default_rng(1)
    tok = tb.p.tokenizer
    a_ids = rng.integers(5, tok.vocab_size, (6, 4)).astype(np.int32)
    a_ids[:, 0] = tok.cls_token_id
    mask = np.ones_like(a_ids)
    pairs = j[:3]
    j_ids, j_probs = jb.p.evaluate_victim_batch([r.adv_image for r in pairs],
                                                [r.adv_text for r in pairs],
                                                jnp.asarray(a_ids), jnp.asarray(mask))
    t_ids, t_probs = tb.p.evaluate_victim_batch([nchw(r.adv_image) for r in pairs],
                                                [r.adv_text for r in pairs],
                                                torch.from_numpy(a_ids).long(),
                                                torch.from_numpy(mask).long())
    assert t_ids.shape == (3, 4)
    np.testing.assert_array_equal(t_ids, np.asarray(j_ids))
    np.testing.assert_allclose(t_probs, np.asarray(j_probs), rtol=1e-4, atol=1e-6)
    assert tb.p.evaluate_victim_batch([], [], torch.from_numpy(a_ids).long(),
                                      torch.from_numpy(mask).long())[0].shape == (0, 4)


def test_cli_batched_flash_on_cpu(tmp_path, capsys, monkeypatch):
    """``--batch-size 4 --attn flash`` on synthetic assets at 192 px (145
    ViT tokens, so the flash branch runs): three samples through the
    lockstep engine, artifacts written, and the backend restored after."""
    calls = []
    real = attention.flash_attention

    def spy(*a):
        calls.append(a[0].shape[1])
        return real(*a)

    monkeypatch.setattr(attention, "flash_attention", spy)
    samples = [(1001, "what color is the dog", "red", "the dog is red"),
               (1002, "what color is the cat", "blue", None),
               (1003, "what is the hat", "red", "the hat is red")]
    argv = synth_cli_assets(tmp_path, samples, image_size=192)
    summary = port_run.main(argv + ["--batch-size", "4", "--attn", "flash",
                                    "--pipeline-depth", "2", "--seed", "3"])
    assert summary["samples"] == 3 and summary["device"] == "cpu"
    assert 0 < summary["bucket_occupancy"] <= 1
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert calls and set(calls) == {145}
    assert attention.get_impl() == "xla"
    out = tmp_path / "out"
    for qid, *_ in samples:
        img = torch.load(out / f"{qid}.pt")
        assert img.shape == (1, 3, 192, 192) and float(img.abs().max()) <= 1.0
    assert len(json.loads((out / "adv_txt_dict.json").read_text())) == 3


def test_engine_refuses_a_mixed_key_bucket(engines):
    _, tb, samples = engines
    states = tb._prepare_many(_port_samples(samples[:1] + samples[3:4]))
    px = np.zeros((2, 3, 32, 32), np.float32)
    with pytest.raises(ValueError, match="share"):
        tb.attack_bucket(px, states, JaxKey(jax.random.key(0)))


def test_select_substitutions_multi_suffix_and_timer_match_jax():
    """The VLMo dialect (``question_suffix="?"``): the same sentences and
    substitutions as the JAX function for two requests in one call, and the
    port's timer charged with each sub-phase."""
    questions = ["what color is the dog?", "what is the cat?"]
    table = np.random.default_rng(5).normal(size=(64, 8)).astype(np.float32)

    def embed(texts):  # [N, 8, 8]: a row per word, from the word's letters
        rows = [[sum(map(ord, w)) % 64 for w in (t.split() + ["."] * 8)[:8]] for t in texts]
        return table[np.asarray(rows)]

    def gate(refs, texts):
        return np.asarray([0.99 - 0.01 * (len(t) % 5) for t in texts], np.float32)

    def requests(mod):
        out = []
        for i, q in enumerate(questions):
            words = q.strip("?").split()
            lists = [None] * len(words)
            lists[-1] = ["hat", "park"]
            if len(words) > 4:
                lists[1] = ["red"]
            cands = mod.WordCandidates(words, [(j, j + 1) for j in range(len(words))], lists,
                                       [4, 4])
            grad = np.full((2, 8), i + 1.0, np.float32)
            out.append(mod.SubstitutionRequest(q, q, grad, cands, table[:8], 0.95))
        return out

    timer = PhaseTimer(True)
    t = ttext.select_substitutions_multi(requests(ttext), embed, gate, max_length=8,
                                         question_suffix="?", timer=timer)
    j = jtext.select_substitutions_multi(requests(jtext), embed, gate, max_length=8,
                                         question_suffix="?")
    assert t == j
    assert all(text.endswith("?") for text, _ in t) and any(ops for _, ops in t)
    assert {"sub_build", "sub_embed", "sub_rank", "sub_walk", "sub_gate"} <= set(timer.acc)
