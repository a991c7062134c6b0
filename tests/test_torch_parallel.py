"""The port's data mesh (``parallel/``) and the lockstep engine on it: the
mesh's shapes, placement and refusals; a chunk on ``[cpu] * 4`` against the
unsharded engine and against the JAX engine on its 8-device CPU mesh (the
JAX draws replayed, ALBEF alternating and VLMo); the chunking against the
JAX engine's; ``make_sweep_runner`` with the cases of
``tests/test_sweep_runner.py``; ``threaded_iter`` with those of
``tests/test_utils_modules.py``."""

from __future__ import annotations

import ast
import dataclasses
import sys
import threading
import time
import warnings

import jax
import numpy as np
import pytest
import torch

from torch_port_util import (ROOT, JaxKey, fixed_topk, nchw, nhwc, shallow_albef, tiny_configs,
                             tiny_mlm, tiny_models, tiny_vlmo, tiny_vlmo_configs)
from vqattack_tpu.attacks.batched import BatchedAlbefAttack as JAlbefBatched
from vqattack_tpu.attacks.batched import BatchedVlmoAttack as JVlmoBatched
from vqattack_tpu.attacks.orchestrator import AlbefAttackPipeline as JAlbefPipeline
from vqattack_tpu.attacks.vlmo_orchestrator import VlmoAttackPipeline as JVlmoPipeline
from vqattack_tpu.parallel.mesh import make_mesh as jmake_mesh
from vqattack_tpu.text.similarity import NullGate as JNullGate
from vqattack_tpu.text.tokenizer import WordPieceTokenizer as JTokenizer
from vqattack_tpu_torch.attacks import batched as batched_mod
from vqattack_tpu_torch.attacks.batched import BatchedAlbefAttack, BatchedVlmoAttack
from vqattack_tpu_torch.attacks.orchestrator import AlbefAttackPipeline, AttackResult
from vqattack_tpu_torch.attacks.vlmo_orchestrator import VlmoAttackPipeline
from vqattack_tpu_torch.data.iter_utils import threaded_iter
from vqattack_tpu_torch.parallel import mesh as mesh_mod
from vqattack_tpu_torch.parallel import (DATA_AXIS, MODEL_AXIS, batched_attack_step, make_mesh,
                                         make_sweep_runner, shard_batch, shard_params)
from vqattack_tpu_torch.rng import RowsKey, TorchKey
from vqattack_tpu_torch.text.similarity import NullGate
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer

CPU4 = ["cpu"] * 4
WORDS = ["what", "color", "is", "the", "dog", "cat", "red", "blue", "hat", "a",
         "frisbee", "park", "dog-cat"]
# each question's noun has one substitute that keeps the paraphrase's token
# count: the MAR chunk runs the MLM loss in every block (k = 2, 3 blocks)
CANDIDATES = {"cat": ["hat"]}
# test_parallel.py's tolerances: images, then loss trajectories
IMG_ATOL = 2e-6
LOSS_TOL = dict(rtol=2e-4, atol=1e-5)


# ------------------------------------------------------------------ the mesh


def test_mesh_shapes_and_refusals():
    mesh = make_mesh(devices=CPU4)
    assert mesh.shape == {DATA_AXIS: 4, MODEL_AXIS: 1}
    assert make_mesh(2, devices=CPU4).shape[DATA_AXIS] == 2
    assert make_mesh(4, model_parallelism=2, devices=CPU4).shape == {DATA_AXIS: 2,
                                                                      MODEL_AXIS: 2}
    with pytest.raises(ValueError, match="5 devices asked for, 4 given"):
        make_mesh(5, devices=CPU4)
    if not torch.cuda.is_available():  # the default mesh takes CUDA cards only
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1)


def test_run_config_round_trips_the_jax_mesh_section():
    """A JAX config JSON's ``mesh`` section loads into ``MeshConfig`` and
    comes back out as it went in (its ``data`` section is dropped)."""
    from vqattack_tpu import config as jcfg
    from vqattack_tpu_torch import config as tcfg

    j = jcfg.to_dict(dataclasses.replace(jcfg.tiny_test_config(), mesh=jcfg.MeshConfig(
        data_parallelism=4, model_parallelism=2)))
    port = tcfg.run_config_from_dict(j)
    assert port.mesh == tcfg.MeshConfig(data_parallelism=4, model_parallelism=2)
    assert tcfg.to_dict(port)["mesh"] == j["mesh"] and "data" not in tcfg.to_dict(port)


def test_shard_batch_places_rows_and_warns_once_on_an_indivisible_batch():
    mesh = make_mesh(devices=CPU4)
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    shards = shard_batch({"x": x, "ids": (4, 0, 2), "n": torch.tensor(3.0)}, mesh)
    assert len(shards) == 4
    for i, sh in enumerate(shards):
        assert torch.equal(sh["x"], x[2 * i : 2 * i + 2]) and sh["ids"] == (4, 0, 2)
        assert float(sh["n"]) == 3.0
    mesh_mod._warned_indivisible.discard((6, 4))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        (whole,) = shard_batch(x[:6], mesh)
        shard_batch(x[:6], mesh)
    assert torch.equal(whole, x[:6])
    assert [str(w.message) for w in caught if "not divisible" in str(w.message)] == [
        "batch axis 6 not divisible by data-mesh size 4: running it whole on the mesh's first "
        "device (fine for a sweep's tail bucket; if this happens for EVERY bucket, pick "
        "--batch-size as a multiple of --mesh-devices)"]
    with pytest.raises(ValueError, match="disagree"):
        shard_batch({"a": x, "b": x[:4]}, mesh)


def test_shard_params_replicas_are_bit_identical():
    torch.manual_seed(0)
    module = torch.nn.Sequential(torch.nn.Linear(16, 32), torch.nn.LayerNorm(32))
    replicas = shard_params(module, make_mesh(devices=CPU4))
    assert len(replicas) == 4
    for rep in replicas:
        assert rep is not module
        for (n, a), (m, b) in zip(module.state_dict().items(), rep.state_dict().items()):
            assert n == m and a.data_ptr() != b.data_ptr() and torch.equal(a, b)


def test_rows_key_draws_the_whole_batch_rows():
    """A shard's draws are the rows of the whole batch's, each shard on a
    clone of a stateful key (the engine tests below replay the JAX draws
    through it)."""
    whole = TorchKey(3, "cpu")
    u, r = whole.uniform((4, 5)), whole.randint((4, 2), 0, 9)
    for lo in (0, 2):
        k = RowsKey(TorchKey(3, "cpu").clone(), lo, lo + 2, 4, torch.device("cpu"))
        assert torch.equal(k.uniform((2, 5)), u[lo : lo + 2])
        assert torch.equal(k.randint((2, 2), 0, 9), r[lo : lo + 2])
    logits = torch.randn(4, 7)
    cat = TorchKey(4, "cpu").categorical(logits)
    shard = RowsKey(TorchKey(4, "cpu"), 2, 4, 4, torch.device("cpu"))
    assert torch.equal(shard.categorical(logits[2:]), cat[2:])
    img = TorchKey(6, "cpu").rademacher((4, 3, 2, 2))
    assert torch.equal(RowsKey(TorchKey(6, "cpu"), 2, 4, 4, torch.device("cpu"))
                       .split(2)[1].rademacher((2, 3, 2, 2)), img[2:])
    with pytest.raises(ValueError, match="leading axis"):
        shard.uniform((4, 3))


def test_new_modules_import_only_torch_numpy_stdlib():
    """The AST test of ``test_torch_slice.py`` walks every file of the port;
    the modules of this slice are among them, and import nothing else."""
    allowed = set(sys.stdlib_module_names) | {"torch", "numpy", "vqattack_tpu_torch"}
    for rel in ("parallel/__init__.py", "parallel/mesh.py", "parallel/sweep.py",
                "parallel/tensor.py", "data/iter_utils.py"):
        tree = ast.parse((ROOT / "vqattack_tpu_torch" / rel).read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] in allowed, (rel, name)


# -------------------------------------------------- the engine on the mesh


def _samples(n, questions, seed=0, nhwc_px=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        q, para, ans = questions[i % len(questions)]
        px = rng.uniform(-1, 1, (1, 32, 32, 3)).astype(np.float32)
        out.append({"qid": str(3000 + i), "question": q, "paraphrase": para,
                    "target_answer": ans, "all_correct_answers": ["red", "blue"],
                    "pixels": px if nhwc_px else nchw(px)})
    return out


def _port(samples):
    return [dict(s, pixels=nchw(s["pixels"])) for s in samples]


def _assert_same(got, want, port_vs_jax=False):
    """Per sample the same schedule and text, losses within test_parallel's
    tolerances, images within its 2e-6 (JAX's in NHWC)."""
    assert [r.qid for r in got] == [r.qid for r in want]
    for a, b in zip(got, want):
        assert (a.old_alg, a.num_blocks, a.adv_text, list(a.substitutions)) == (
            b.old_alg, b.num_blocks, b.adv_text, list(b.substitutions))
        np.testing.assert_allclose(a.feat_losses, b.feat_losses, **LOSS_TOL)
        if b.mlm_losses is not None:
            np.testing.assert_allclose(a.mlm_losses, b.mlm_losses, **LOSS_TOL)
        want_img = b.adv_image if not port_vs_jax else nchw(b.adv_image)
        np.testing.assert_allclose(a.adv_image, want_img, atol=IMG_ATOL)


# one bucket: the same question (one substitutable word), two paraphrases
# one bucket: the same question (one substitutable word), two paraphrases
ALBEF_QUESTIONS = [("what color is the cat", "the cat is blue.", "blue"),
                   ("what color is the cat", "a cat is red.", "red")]


def _one_vit_block(cfg):
    vit = dataclasses.replace(cfg.albef.vit, depth=1)
    return dataclasses.replace(cfg, albef=dataclasses.replace(cfg.albef, vit=vit))


@pytest.fixture(scope="module")
def albef():
    """Both packages' ALBEF pipelines on the same tiny weights, 6
    iterations.  The JAX engine runs its unfused dynamic programs (the
    clean targets, then the PGD loop): for one block they draw as the fused
    block does (``tests/test_pgd_fused.py`` pins the two forms), and they
    compile in less time."""
    j_tok, t_tok = JTokenizer.toy(WORDS), WordPieceTokenizer.toy(WORDS)
    # one ViT block and one text and one fusion layer: the JAX programs'
    # compile scales with depth
    jc, tc = (_one_vit_block(shallow_albef(c)) for c in tiny_configs(
        t_tok.vocab_size, num_iters=6, dynamic_pgd=True, fused_block=False))
    (j_sur, _, _), (p_sur, _, _), (t_sur, _, t_mlm) = tiny_models(jc, tc, victim=False)
    tp = AlbefAttackPipeline(tc, t_sur, t_tok, NullGate(), mlm_model=t_mlm, device="cpu")
    tp.candidate_mlm_topk = fixed_topk(t_tok, CANDIDATES)
    # without a candidate MLM: the image attack, one block of the whole budget
    jp_img = JAlbefPipeline(jc, j_sur, p_sur, j_tok, JNullGate())
    tp_img = AlbefAttackPipeline(tc, t_sur, t_tok, NullGate(), device="cpu")
    return tp, jp_img, tp_img


def _counting_map_shards(monkeypatch):
    calls = []
    real = batched_mod.map_shards
    monkeypatch.setattr(batched_mod, "map_shards",
                        lambda fn, n: calls.append(n) or real(fn, n))
    return calls


def test_albef_alternating_on_the_mesh_equals_unsharded_and_jax_mesh(albef, monkeypatch):
    """8 MAR samples at batch 8, one block of 3 alternating steps (the
    pipeline without a candidate MLM): the port on ``[cpu] * 4`` (4
    replicas, 2 rows each) against the unsharded port and against the JAX
    engine on JAX's 8-device mesh, all on the JAX draws (the rand-init start
    and every step's masks)."""
    _, jp, tp = albef
    samples = _samples(8, ALBEF_QUESTIONS)
    key = jax.random.key(11)
    engine = BatchedAlbefAttack(tp, mesh=make_mesh(devices=CPU4))
    calls = _counting_map_shards(monkeypatch)
    sharded = engine.run(_port(samples), batch_size=8, rng=JaxKey(key))
    assert calls == [4] and engine.last_chunk_sizes == [8]
    assert all(r.old_alg == 0 and r.num_blocks == 1 and len(r.mlm_losses) == 3
               for r in sharded)
    whole = BatchedAlbefAttack(tp).run(_port(samples), batch_size=8, rng=JaxKey(key))
    _assert_same(sharded, whole)
    j = JAlbefBatched(jp, mesh=jmake_mesh(8)).run(samples, batch_size=8, rng=key)
    _assert_same(sharded, j, port_vs_jax=True)


def test_engine_on_a_mesh_equals_unsharded_across_blocks(albef, monkeypatch):
    """The default key (a ``torch.Generator``) and the text attack: every
    shard draws the whole chunk on a clone of the chunk's key, so 2 and 4
    replicas give the unsharded engine's samples through 3 blocks, 2 VL
    steps and the substitutions chosen on the gathered chunk; an
    indivisible chunk (6 rows on 4 devices, capped by the batch) runs whole
    on the first device, warned."""
    tp = albef[0]
    samples = _samples(8, ALBEF_QUESTIONS, seed=1, nhwc_px=False)
    whole = BatchedAlbefAttack(tp).run(samples, batch_size=8, rng=TorchKey(5, "cpu"))
    assert all(r.num_blocks == 3 and r.vl_steps == 2 and r.substitutions for r in whole)
    calls = _counting_map_shards(monkeypatch)
    for n in (2, 4):
        got = BatchedAlbefAttack(tp, mesh=make_mesh(n, devices=CPU4)).run(
            samples, batch_size=8, rng=TorchKey(5, "cpu"))
        _assert_same(got, whole)
    assert calls == [2] * 3 + [4] * 3
    mesh_mod._warned_indivisible.discard((6, 4))
    with pytest.warns(UserWarning, match="batch axis 6 not divisible by data-mesh size 4"):
        e6 = BatchedAlbefAttack(tp, mesh=make_mesh(devices=CPU4))
        e6.run(samples[:6], batch_size=6, rng=TorchKey(5, "cpu"))
    assert e6.last_chunk_sizes == [6] and calls[6:] == [1] * 3


@pytest.mark.parametrize("n_mesh, batch_size, sizes", [
    (4, 8, [(8, 3), (4, 1)]),
    (4, 16, [(4, 1), (7, 2), (12, 3)]),
    (2, 8, [(5, 1), (2, 2)]),
], ids=["mesh4_b8", "mesh4_b16", "mesh2_b8"])
def test_chunk_sizes_and_occupancy_equal_the_jax_engine(monkeypatch, n_mesh, batch_size, sizes):
    """The chunk floor under a mesh: the same padded chunks and occupancy as
    the JAX engine on a JAX mesh of the same size (the attack itself
    replaced, on both sides, by a stub that returns the chunk's rows)."""
    samples = []
    for n, k in sizes:  # n samples whose schedule has k blocks
        samples += [{"qid": f"{k}-{i}", "k": k} for i in range(n)]

    def stub(self, samples_):
        from vqattack_tpu_torch.attacks.batched import _SampleState
        from vqattack_tpu_torch.attacks.mar_labels import MarLabels
        from vqattack_tpu_torch.attacks.text_attack import WordCandidates

        return [_SampleState(s["qid"], "", "", MarLabels(1, None, None, None, [], [], [], 0),
                             [], WordCandidates([], [], [], [1] * s["k"]), None, [])
                for s in samples_]

    def chunk(self, chunk, n_real, rng):
        return [AttackResult(st.qid, None, "", 1, np.zeros(0), None, 1, [])
                for st, _ in chunk[:n_real]]

    got = {}
    for name, cls, mesh in (("port", BatchedAlbefAttack, make_mesh(n_mesh, devices=CPU4)),
                            ("jax", JAlbefBatched, jmake_mesh(n_mesh))):
        monkeypatch.setattr(cls, "_prepare_many", stub)
        monkeypatch.setattr(cls, "_run_chunk", chunk)
        engine = cls.__new__(cls)
        engine.p, engine.mesh, engine._timer = None, mesh, batched_mod.PhaseTimer(False)
        rng = TorchKey(0, "cpu") if name == "port" else jax.random.key(0)
        out = engine.run(samples, batch_size=batch_size, rng=rng)
        assert sorted(r.qid for r in out) == sorted(s["qid"] for s in samples)
        got[name] = (engine.last_chunk_sizes, engine.last_occupancy)
    assert got["port"] == got["jax"]
    assert all(c % n_mesh == 0 or c == batch_size for c in got["port"][0])


VLMO_QUESTIONS = [("what color is the cat?", "the cat is blue", "blue"),
                  ("what color is the cat?", "a cat is red", "red")]


def test_vlmo_on_the_mesh_equals_unsharded_and_jax_mesh():
    """The tiny VLMo (two blocks: a split block, then the VL expert) at
    batch 8, each replica with its own relative-position biases: 8 MAR
    samples through 3 blocks and the text attack on ``[cpu] * 4`` against
    the unsharded port; 8 feature-only samples in one block against the
    unsharded port and the JAX engine (its unfused dynamic programs, as in
    the ALBEF fixture) on its 8-device mesh, on the JAX draws."""
    j_tok, t_tok = JTokenizer.toy(WORDS), WordPieceTokenizer.toy(WORDS)
    jc, tc = tiny_vlmo_configs(t_tok.vocab_size, depth=2, num_iters=6, dynamic_pgd=True,
                               fused_block=False)
    j_model, j_params, t_model = tiny_vlmo(jc, tc, seed=0)
    _, _, t_mlm = tiny_mlm(jc, tc, seed=2)
    ids = {0: "red"}
    tp = VlmoAttackPipeline(tc, t_model, t_tok, NullGate(), mlm_model=t_mlm, id2answer=ids,
                            device="cpu")
    tp.candidate_mlm_topk = fixed_topk(t_tok, CANDIDATES)
    samples = _samples(8, VLMO_QUESTIONS, seed=2)
    engine = BatchedVlmoAttack(tp, mesh=make_mesh(devices=CPU4))
    views = [v for v, _ in engine._replicas]
    assert len({id(v.model) for v in views} | {id(t_model)}) == 5
    assert all(torch.equal(v._rel_biases, tp._rel_biases) for v in views)
    got = engine.run(_port(samples), batch_size=8, rng=TorchKey(3, "cpu"))
    assert all(r.old_alg == 0 and r.vl_steps == 2 and r.substitutions for r in got)
    _assert_same(got, BatchedVlmoAttack(tp).run(_port(samples), batch_size=8,
                                                rng=TorchKey(3, "cpu")))

    # feature-only samples without a candidate MLM: one block of 6 steps
    jp = JVlmoPipeline(jc, j_model, j_params, j_params, j_tok, JNullGate(), id2answer=ids)
    tp = VlmoAttackPipeline(tc, t_model, t_tok, NullGate(), id2answer=ids, device="cpu")
    samples = [dict(s, paraphrase=None, target_answer=None) for s in samples]
    key = jax.random.key(13)
    sharded = BatchedVlmoAttack(tp, mesh=make_mesh(devices=CPU4)).run(
        _port(samples), batch_size=8, rng=JaxKey(key))
    assert all(r.old_alg == 1 and r.num_blocks == 1 and len(r.feat_losses) == 6
               for r in sharded)
    _assert_same(sharded, BatchedVlmoAttack(tp).run(_port(samples), batch_size=8,
                                                    rng=JaxKey(key)))
    j = JVlmoBatched(jp, mesh=jmake_mesh(8)).run(samples, batch_size=8, rng=key)
    _assert_same(sharded, j, port_vs_jax=True)


def test_batched_attack_step_equals_pgd_on_one_device():
    """``batched_attack_step`` on ``[cpu] * 4`` with a rand-init start:
    every shard draws the whole batch's rows, so the result is the
    unsharded ``pgd_feature``'s."""
    from vqattack_tpu_torch.attacks.pgd import pgd_feature

    def loss_fn(adv, key, aux):
        ps = torch.sum((adv - aux["t"]) ** 2, dim=(1, 2, 3))
        return ps.sum(), ps

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-1, 1, (8, 3, 8, 8)), dtype=torch.float32)
    aux = {"t": x + 2.0}
    kw = dict(eps=0.3, eps_iter=0.05, nb_iter=4, rand_init=True)
    adv1, l1 = pgd_feature(loss_fn, x, x, TorchKey(0, "cpu"), aux, **kw)
    adv2, l2 = batched_attack_step([loss_fn] * 4, x, x, TorchKey(0, "cpu"), aux,
                                   make_mesh(devices=CPU4), **kw)
    assert torch.equal(adv1, adv2)
    np.testing.assert_allclose(l1.numpy(), l2.numpy(), rtol=1e-6)


# ------------------------------------------------------- make_sweep_runner


@pytest.fixture(scope="module")
def sweep_pipe():
    from vqattack_tpu_torch.config import tiny_test_config
    from vqattack_tpu_torch.models.albef import AlbefPretrain, init_weights
    from vqattack_tpu_torch.models.bert import FusionBert

    tok = WordPieceTokenizer.toy(WORDS)
    base = tiny_test_config()
    bert = dataclasses.replace(base.albef.bert, vocab_size=tok.vocab_size)
    cfg = dataclasses.replace(
        base, albef=dataclasses.replace(base.albef, bert=bert))
    sur = init_weights(AlbefPretrain(cfg.albef), seed=0)
    mlm = init_weights(FusionBert(dataclasses.replace(
        bert, fusion_layer=bert.num_layers), with_mlm_head=True), seed=1)
    return tok, cfg, sur, mlm


def _sweep_samples(n, question, seed, qid0=0, **extra):
    rng = np.random.default_rng(seed)
    return [{"qid": str(qid0 + i), "question": question,
             "pixels": rng.uniform(-1, 1, (1, 3, 32, 32)).astype(np.float32), **extra}
            for i in range(n)]


def _in_ball(out, samples, eps):
    for s in samples:
        r = out[s["qid"]]
        assert r["adv_image"].shape == (1, 3, 32, 32)
        assert (np.abs(r["adv_image"] - s["pixels"]) <= eps + 1e-5).all()
        assert np.isfinite(r["losses"]).all()


@pytest.mark.parametrize("case", ["mesh", "paraphrase_batched", "vlmo", "no_mlm"])
def test_sweep_runner(sweep_pipe, monkeypatch, case):
    """The four cases of ``tests/test_sweep_runner.py`` on ``[cpu] * 4``:
    a feature sweep; paraphrase samples in one lockstep bucket call (no
    per-sample fallback) with their MAR trajectories; a VLMo pipeline routed
    to the VLMo engine; a pipeline without a candidate MLM (no
    substitution)."""
    tok, cfg, sur, mlm = sweep_pipe
    mesh = make_mesh(devices=CPU4)
    eps = cfg.attack.eps
    if case == "vlmo":
        from vqattack_tpu_torch.models.vlmo import VLMo, init_vlmo_weights

        vcfg = dataclasses.replace(cfg.vlmo, vocab_size=tok.vocab_size)
        vcfg_run = dataclasses.replace(cfg, vlmo=vcfg)
        pipe = VlmoAttackPipeline(vcfg_run, init_vlmo_weights(VLMo(vcfg), seed=0), tok,
                                  NullGate(), mlm_model=mlm, id2answer={0: "red"}, device="cpu")
        spy = []
        orig = BatchedVlmoAttack.attack_bucket
        monkeypatch.setattr(BatchedVlmoAttack, "attack_bucket",
                            lambda self, *a: spy.append(1) or orig(self, *a))
        samples = _sweep_samples(8, "what color is the dog?", 2, qid0=100)
        out = make_sweep_runner(pipe, mesh, batch_size=8)(samples)
        assert spy and len(out) == 8
        _in_ball(out, samples, vcfg_run.attack.eps)
        return
    pipe = AlbefAttackPipeline(cfg, sur, tok, NullGate(),
                               mlm_model=None if case == "no_mlm" else mlm, device="cpu")
    if case == "mesh":
        samples = _sweep_samples(8, "what color is the dog", 0)
        out = make_sweep_runner(pipe, mesh, batch_size=8)(samples)
        assert len(out) == 8
        _in_ball(out, samples, eps)
    elif case == "paraphrase_batched":
        def boom(*a, **kw):  # pragma: no cover - the assertion is the test
            raise AssertionError("per-sample fallback used: the sweep must batch")

        monkeypatch.setattr(AlbefAttackPipeline, "attack_sample", boom)
        sizes = []
        orig = BatchedAlbefAttack.attack_bucket
        monkeypatch.setattr(BatchedAlbefAttack, "attack_bucket",
                            lambda self, px, states, rng: sizes.append(len(states))
                            or orig(self, px, states, rng))
        samples = _sweep_samples(4, "what color is the dog", 1, paraphrase="the dog is red",
                                 target_answer="red")
        out = make_sweep_runner(pipe, mesh, batch_size=4)(samples)
        assert sizes == [4] and len(out) == 4
        _in_ball(out, samples, eps)
        for s in samples:
            ml = out[s["qid"]]["mlm_losses"]
            assert ml is not None and np.isfinite(ml).all()
    else:
        samples = _sweep_samples(4, "what color is the cat", 3)
        out = make_sweep_runner(pipe, mesh, batch_size=4)(samples)
        assert len(out) == 4
        _in_ball(out, samples, eps)
        assert all(not out[s["qid"]]["substitutions"] for s in samples)


# ------------------------------------------------------------- threaded_iter


class _SlowDataset:
    """Items whose read time falls with the index: unordered, they would come
    back reversed."""

    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        time.sleep(0.02 * (self.n - i))
        return {"i": i}


class _ExplodingDataset:
    def __len__(self):
        return 6

    def __getitem__(self, i):
        if i == 3:
            raise ValueError("bad sample 3")
        return {"i": i}


@pytest.mark.parametrize("case", ["order", "inline", "subset", "exception", "duplicates",
                                  "early_break"])
def test_threaded_iter(case):
    """The six cases of ``tests/test_utils_modules.py``: order kept against
    the read times, ``num_workers=0`` inline, an index subset, a worker's
    exception raised in order without a deadlock, repeated indices each in
    their slot, and an early close releasing the workers."""
    if case == "order":
        assert [d["i"] for d in threaded_iter(_SlowDataset(8), num_workers=4)] == list(range(8))
    elif case == "inline":
        main = threading.get_ident()

        class Here(_SlowDataset):
            def __getitem__(self, i):
                assert threading.get_ident() == main
                return super().__getitem__(i)

        assert [d["i"] for d in threaded_iter(Here(3), num_workers=0)] == [0, 1, 2]
    elif case == "subset":
        out = threaded_iter(_SlowDataset(8), indices=[5, 1, 3], num_workers=2)
        assert [d["i"] for d in out] == [5, 1, 3]
    elif case == "exception":
        got = []
        with pytest.raises(ValueError, match="bad sample 3"):
            for d in threaded_iter(_ExplodingDataset(), num_workers=2):
                got.append(d["i"])
        assert got == [0, 1, 2]
    elif case == "duplicates":
        out = threaded_iter(_SlowDataset(4), indices=[0, 1, 0, 2], num_workers=2)
        assert [d["i"] for d in out] == [0, 1, 0, 2]
    else:
        before = threading.active_count()
        for _ in range(5):
            it = threaded_iter(_SlowDataset(8), num_workers=4, prefetch=2)
            next(it)
            it.close()  # what a `break` or the generator's collection does
        deadline = time.time() + 10
        while threading.active_count() > before and time.time() < deadline:
            time.sleep(0.05)
        assert threading.active_count() <= before + 1
