"""The port's downstream fine-tuning slice against the JAX package: the
annotation dialects of ``VQADataset``, ``FusionBert.encode`` over two image
streams, ALBEF's task models (``AlbefVE``, ``AlbefNLVR``,
``AlbefRetrieval``), ``VLMo.nlvr2_logits`` and the widened token-type
table, the retrieval and IRTR losses, one train step of each of the five
tasks (``retrieval``, ``ve``, ``nlvr2``, ``vlmo_irtr``, ``vlmo_nlvr2``),
the task metrics, and the CLI on the CPU.

The models are ``tiny_test_config``'s, ALBEF's text side cut
(``shallow_albef``; NLVR at 3 layers, fused from layer 1, its
cross-attention on image 0, then 1; the two-stream encoder alone at 4
layers, image 0, 1, 0), VLMo at two blocks (a split block,
then the VL expert), with the port's random weights handed to flax
(``jax_params_of``: no flax ``init`` compiles).

Tolerances: forward values rtol 1e-4 and atol 1e-5 of the tensor's largest
magnitude (at least 1), float32 products and reductions in other orders;
losses rtol 1e-5; the train step as ``tests/test_torch_train.py`` states
it (gradients rtol 1e-3, atol 1e-5 of each tensor's largest value or 1e-6
of the model's largest gradient; ``grad_norm`` rtol 1e-4; parameters after
one AdamW step rtol 1e-5 and atol 1e-4 lr where the JAX gradient exceeds
1e-6, else 2 lr); the datasets, the widened table and the metrics exactly.

The JAX retrieval loss normalises its features again with
``jnp.linalg.norm(x, -1, keepdims=True)``, whose -1 is ``ord``: one scalar
for the whole matrix, where the reference and the port normalise each row.
The loss tests take that call per row (``torch_port_util.row_norm``), as
``tests/test_torch_pretrain.py`` does for the pretraining loss.
"""

from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_util import (JaxKey, adam_mu, assert_same_tree, init_tree_shapes, jax_params_of,
                             nchw, port_layout, row_norm, shallow_albef, tiny_configs,
                             tiny_vlmo_configs)  # noqa: F401 (row_norm: a fixture)
from vqattack_tpu.checkpoint import convert as jconvert
from vqattack_tpu.data import transforms as jtransforms
from vqattack_tpu.data import vqa as jvqa
from vqattack_tpu.models import albef_tasks as jtasks
from vqattack_tpu.models.bert import FusionBert as JFusionBert
from vqattack_tpu.models.vlmo import VLMo as JVLMo
from vqattack_tpu.text.tokenizer import SPECIAL_TOKENS
from vqattack_tpu.train import objectives as jobj
from vqattack_tpu.train import optim as joptim
from vqattack_tpu.train import task_metrics as jmetrics
from vqattack_tpu.train import trainer as jtrainer
from vqattack_tpu_torch import config as tcfg
from vqattack_tpu_torch.checkpoint import convert, synthetic
from vqattack_tpu_torch.checkpoint import io as ckpt_io
from vqattack_tpu_torch.checkpoint.convert import flax_leaves, load_jax_params
from vqattack_tpu_torch.checkpoint.io import find_train_steps
from vqattack_tpu_torch.data import transforms
from vqattack_tpu_torch.data.vqa import VQADataset
from vqattack_tpu_torch.models import albef_tasks
from vqattack_tpu_torch.models.albef import init_weights
from vqattack_tpu_torch.models.bert import FusionBert
from vqattack_tpu_torch.models.vlmo import VLMo, init_vlmo_weights
from vqattack_tpu_torch.rng import TorchKey
from vqattack_tpu_torch.train import cli, objectives, optim, task_metrics, trainer

T = torch.from_numpy
VOCAB = 64
NLVR_LAYERS = 3  # fused from layer 1 (shallow_albef): layers 1 and 2 take image 0, then 1


def _close(got, want, rtol=1e-4, atol=1e-5):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol * max(1.0, float(np.abs(want).max())))


def _port_batch(batch):
    """A numpy batch (NHWC pixels, int32 ids) in the port's layout."""
    out = {}
    for k, v in batch.items():
        v = T(nchw(v) if k.startswith("pixels") else np.asarray(v))
        out[k] = v.long() if v.dtype == torch.int32 else v
    return out


def _text(rng, b, s=8, pad_row=1, pad_from=5):
    ids = rng.integers(5, VOCAB, (b, s)).astype(np.int32)
    ids[:, 0] = 2
    mask = np.ones_like(ids)
    mask[pad_row, pad_from:] = 0
    return ids, mask


# ---------------------------------------------------------------------------
# the annotation dialects
# ---------------------------------------------------------------------------


def _images(root, names, size=40):
    from PIL import Image

    rng = np.random.default_rng(1)
    for name in names:
        Image.fromarray(rng.integers(0, 255, (size, size + 4, 3), np.uint8)).save(root / name)


def test_vqa_dataset_dialects_match_jax(tmp_path):
    """Item for item, both splits: VQA, VE (``sentence``, a string label, a
    name without ``.jpg``), NLVR (an ``images`` pair, "True"/"False"),
    captions (a list; a shared image, one ``img_idx``; "b" and "b.jpg" two
    identities), grounding
    (``text``, ``ref_id``), VLMo's soft targets; pixels the JAX ones
    transposed."""
    _images(tmp_path, ["a.jpg", "b.jpg", "c.jpg"])
    ann = [
        {"image": "a.jpg", "question": "What color is the dog?", "question_id": 1,
         "answer": ["red", "red", "blue"], "answer_labels": [3], "answer_scores": [1.0]},
        {"image": "b", "sentence": "The dog is red.", "label": "entailment"},
        {"image": "c.jpg", "sentence": "A cat.", "label": "contradiction"},
        {"images": ["a.jpg", "c.jpg"], "sentence": "Two images, one dog.", "label": "True"},
        {"images": ["b.jpg", "b.jpg"], "sentence": "No dog.", "label": "False"},
        {"image": "dir/a.jpg", "caption": ["a dog in a park", "a red dog"]},
        {"image": "c.jpg", "caption": "the cat"},
        {"image": "b.jpg", "text": "the left dog", "ref_id": 7, "label": 1},
    ]
    (tmp_path / "dir").mkdir()
    _images(tmp_path / "dir", ["a.jpg"])
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    for split in ("train", "test"):
        want = jvqa.VQADataset([str(tmp_path / "ann.json")], str(tmp_path),
                               jtransforms.test_transform(16), split=split)
        got = VQADataset([str(tmp_path / "ann.json")], str(tmp_path), transforms.test_transform(16),
                         split=split)
        assert len(got) == len(want) == len(ann)
        for i in range(len(ann)):
            w, g = want[i], got[i]
            assert g.keys() == w.keys(), i
            for k in g:
                if k.startswith("pixels"):
                    np.testing.assert_array_equal(g[k], nchw(w[k]), err_msg=f"{i} {k}")
                else:
                    assert g[k] == w[k], (i, k)
        assert [got[i].get("img_idx") for i in range(len(ann))] == [0, 1, 2, None, None, 0, 2, 3]
        assert [got[i].get("label") for i in (1, 2, 3, 4, 7)] == [2, 0, 1, 0, 1]


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def albef_cfgs():
    return tuple(shallow_albef(c) for c in tiny_configs(VOCAB))


@pytest.mark.parametrize("streams", [1, 2])
def test_fusion_bert_encode_with_two_image_streams_matches_jax(streams):
    """``encode`` with a tuple of two streams of different lengths and
    masks (layer i >= fusion_layer takes stream (i - fusion_layer) % 2: 4
    layers fused from 1 take streams 0, 1, 0), and
    with one stream, as before; the last states and the stack of every
    layer's."""
    jc, tc = tiny_configs(VOCAB)
    bert = dataclasses.replace(tc.albef.bert, num_layers=4, fusion_layer=1)
    model = init_weights(FusionBert(bert), 3).eval()
    rng = np.random.default_rng(0)
    ids, mask = _text(rng, 2)
    enc = [rng.normal(size=(2, n, 32)).astype(np.float32) for n in (5, 7)]
    enc_mask = [np.ones((2, 5), np.int32), np.ones((2, 7), np.int32)]
    enc_mask[1][0, 4:] = 0
    if streams == 1:
        enc, enc_mask = enc[0], enc_mask[0]
    j_model = JFusionBert(dataclasses.replace(jc.albef.bert, num_layers=4, fusion_layer=1))

    @jax.jit
    def j_encode(p, ids, mask, enc, enc_mask):
        def run(m):
            return m.encode(m.embed(ids), mask, enc, enc_mask, mode="multi_modal")
        return j_model.apply(p, method=run)

    want = j_encode(jax_params_of(model), ids, mask, enc, enc_mask)
    tup = (lambda x: tuple(map(T, x))) if streams == 2 else T
    with torch.no_grad():
        got = model.encode(model.embed(T(ids).long()), T(mask).long(), tup(enc), tup(enc_mask))
    for g, w in zip(got, want):
        _close(g, w)


def _albef_task(kind, tc, jc, seed=0):
    """(port model, JAX module, flax variables) of one ALBEF task model."""
    if kind == "nlvr2":
        model = albef_tasks.AlbefNLVR(tc.albef, num_layers=NLVR_LAYERS)
        j_model = jtasks.AlbefNLVR(jc.albef, num_layers=NLVR_LAYERS)
    else:
        model = {"ve": albef_tasks.AlbefVE, "retrieval": albef_tasks.AlbefRetrieval}[kind](
            tc.albef)
        j_model = {"ve": jtasks.AlbefVE, "retrieval": jtasks.AlbefRetrieval}[kind](jc.albef)
    model = init_weights(model, seed).eval()
    return model, j_model, jax_params_of(model)


def _albef_inputs(cfg, rng, b=2, pairs=False):
    size = cfg.albef.vit.image_size
    px = rng.uniform(-1, 1, ((2 if pairs else 1) * b, size, size, 3)).astype(np.float32)
    return (px, *_text(rng, b))


def _vlmo_nlvr2(seed=0):
    """(port VLMo with NLVR2's head at 3 token types, JAX module, variables)."""
    jc, tc = tiny_vlmo_configs(VOCAB, depth=2)
    jc, tc = (dataclasses.replace(c, vlmo=dataclasses.replace(c.vlmo, type_vocab_size=3))
              for c in (jc, tc))
    model = init_vlmo_weights(VLMo(tc.vlmo, with_nlvr2_head=True), seed).eval()
    return model, JVLMo(jc.vlmo, with_nlvr2_head=True), jax_params_of(model), jc


@pytest.mark.parametrize("kind", ["ve", "nlvr2", "retrieval", "vlmo_nlvr2"])
def test_task_model_trees_match_jax(albef_cfgs, kind):
    """Every leaf of the JAX module's ``init`` tree (``init_all`` for VLMo)
    is a parameter of the port's model, shape for shape, and
    ``load_jax_params`` loads the tree into a fresh model with none left
    over.  The NLVR2 VLMo: the 3-row modality table, the head's 2D-wide fc1,
    the VQA head's D-wide one."""
    jc, tc = albef_cfgs
    rng = np.random.default_rng(1)
    if kind == "vlmo_nlvr2":
        model, j_model, variables, vc = _vlmo_nlvr2()
        size, d = vc.vlmo.image_size, vc.vlmo.hidden_size
        ids, mask = _text(rng, 2, vc.vlmo.max_text_len)
        px = rng.uniform(-1, 1, (2, size, size, 3)).astype(np.float32)
        shapes = init_tree_shapes(j_model, ids, mask, px, method=JVLMo.init_all)
        fresh = init_vlmo_weights(VLMo(model.cfg, with_nlvr2_head=True), 5)
        assert model.token_type_embeddings.weight.shape[0] == 3
        assert model.nlvr2_classifier.fc1.weight.shape == (2 * d, 2 * d)
        assert model.vqa_classifier.fc1.weight.shape == (2 * d, d)
    else:
        model, j_model, variables = _albef_task(kind, tc, jc)
        shapes = init_tree_shapes(j_model, *_albef_inputs(jc, rng, pairs=kind == "nlvr2"))
        fresh = _albef_task(kind, tc, jc, seed=5)[0]
    assert_same_tree(variables, shapes)
    load_jax_params(fresh, variables)
    for (name, a), b in zip(model.named_parameters(), fresh.parameters()):
        assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# the widened token types, load_vlmo into an NLVR2 model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [2, 3, 4])
def test_widen_token_type_embeddings_matches_jax(rows):
    emb = np.random.default_rng(rows).normal(size=(rows, 6)).astype(np.float32)
    tree = {"token_type_embeddings": {"embedding": emb}, "other": 1}
    got = convert.widen_token_type_embeddings(tree, 3)
    want = jconvert.widen_token_type_embeddings(tree, 3)
    assert got.keys() == want.keys() and got["other"] == 1
    np.testing.assert_array_equal(got["token_type_embeddings"]["embedding"],
                                  want["token_type_embeddings"]["embedding"])
    if rows == 2:
        widened = got["token_type_embeddings"]["embedding"]
        assert widened.shape == (3, 6) and np.array_equal(widened[2], emb[1])
    assert tree["token_type_embeddings"]["embedding"] is emb  # not widened in place


def _vlmo_file(tmp_path, cfg, heads, name="vlmo.pt"):
    """A synthetic VLMo checkpoint of ``cfg`` (2 token types) with ``heads``."""
    path = str(tmp_path / name)
    torch.save({"state_dict": synthetic.vlmo_state_dict(cfg, 4, heads=heads)}, path)
    return path


def test_load_vlmo_into_an_nlvr2_model(tmp_path, capsys):
    """A 2-row file into ``VLMo(with_nlvr2_head=True)``: the modality table
    the JAX converter and widener give (row 2 = row 1), the text table
    widened alike, the file's NLVR2 head kept; without the head in the
    file, the model's stays and is named; a model without the head drops
    the file's."""
    model, _, _, _ = _vlmo_nlvr2()
    cfg3 = model.cfg
    cfg2 = dataclasses.replace(cfg3, type_vocab_size=2)
    path = _vlmo_file(tmp_path, cfg2, synthetic.VLMO_VQA_HEADS + ("nlvr2_classifier",))
    sd = jconvert.load_torch_checkpoint(path)
    want = jconvert.widen_token_type_embeddings(jconvert.convert_vlmo(sd, depth=cfg3.depth), 3)
    tree = ckpt_io.load_vlmo(path, cfg3, token_types=3)
    table = tree["token_type_embeddings"]["embedding"]
    np.testing.assert_array_equal(table, want["token_type_embeddings"]["embedding"])
    assert table.shape[0] == 3 and np.array_equal(table[2], table[1])
    assert tree["text_embeddings"]["token_type_embeddings"]["embedding"].shape[0] == 3
    ckpt_io.load_vlmo(path, cfg3, into=model, token_types=3)
    assert "nlvr2_classifier" not in capsys.readouterr().out
    w = model.token_type_embeddings.weight
    assert torch.equal(w[2], w[1]) and torch.equal(w[:2], T(sd["token_type_embeddings.weight"]))
    np.testing.assert_array_equal(model.nlvr2_classifier.fc1.weight.detach().numpy(),
                                  sd["nlvr2_classifier.0.weight"])
    # a file without the head: the model's stays at its values, named
    before = model.nlvr2_classifier.fc2.weight.detach().clone()
    ckpt_io.load_vlmo(_vlmo_file(tmp_path, cfg2, synthetic.VLMO_VQA_HEADS, "vqa.pt"), cfg3,
                      into=model, token_types=3)
    kept, _ = capsys.readouterr().out.split("; ")
    assert "nlvr2_classifier" in kept
    assert torch.equal(model.nlvr2_classifier.fc2.weight, before)
    # a model without the head drops the file's
    plain = init_vlmo_weights(VLMo(cfg2), 0)
    ckpt_io.load_vlmo(path, cfg2, into=plain)
    assert "dropped: nlvr2_classifier" in capsys.readouterr().out


def test_the_jax_cli_grafts_an_unwidened_table_into_vlmo_nlvr2(tmp_path, monkeypatch):
    """What the JAX CLI's ``vlmo_nlvr2 --init-ckpt`` does, pinned: its
    ``load_vlmo`` takes no ``token_types``, so its merge puts the file's
    2-row modality table in place of the model's 3-row one, and row 2 (the
    second image) does not exist.  The port's CLI widens the file's table:
    3 rows, row 2 a copy of row 1."""
    from vqattack_tpu import config as jcfg
    from vqattack_tpu.train import cli as jcli

    vocab, argv = _cli_files(tmp_path)
    argv += ["--task", "vlmo_nlvr2", "--ann", str(tmp_path / "nlvr2.json")]
    # the JAX CLI's load_vlmo converts 12 blocks whatever the config's depth
    cfg12 = dataclasses.replace(tcfg.tiny_test_config(vocab_size=len(vocab)).vlmo, depth=12,
                                vlffn_start_layer=10)
    path = _vlmo_file(tmp_path, cfg12, synthetic.VLMO_VQA_HEADS)
    file_table = jconvert.load_torch_checkpoint(path)["token_type_embeddings.weight"]
    # the JAX model's init from the port's weights (no flax init compiles);
    # the parameters the CLI grafted caught where its train state is made
    _, _, variables, _ = _vlmo_nlvr2()
    monkeypatch.setattr(JVLMo, "init", lambda self, *a, **kw: variables)
    monkeypatch.setattr("vqattack_tpu.utils.cache.enable_compile_cache", lambda *a: None)
    seen = {}

    class Grafted(Exception):
        pass

    def caught(params, tx):
        seen["params"] = params
        raise Grafted

    monkeypatch.setattr(jtrainer, "create_train_state", caught)
    jcfg.save_config(_shallow_vlmo(jcfg.tiny_test_config(vocab_size=len(vocab))),
                     str(tmp_path / "jcfg.json"))
    with pytest.raises(Grafted):
        jcli.main(argv + ["--config", str(tmp_path / "jcfg.json"), "--init-ckpt", path])
    j_table = np.asarray(seen["params"]["params"]["token_type_embeddings"]["embedding"])
    np.testing.assert_array_equal(j_table, file_table)  # 2 rows: no row 2

    # the port's CLI, from a file at its config's depth
    cfg2 = dataclasses.replace(cfg12, depth=2, vlffn_start_layer=1)
    path = _vlmo_file(tmp_path, cfg2, synthetic.VLMO_VQA_HEADS, "vlmo2.pt")
    file_table = jconvert.load_torch_checkpoint(path)["token_type_embeddings.weight"]
    args = cli.build_argparser().parse_args(argv + [
        "--config", str(tmp_path / "cfg.json"), "--device", "cpu", "--init-ckpt", path])
    model, _, _ = cli.build_task(args, cli.resolve_config(args, None, torch.device("cpu")),
                                 None, torch.device("cpu"))
    w = model.token_type_embeddings.weight.detach().numpy()
    assert w.shape[0] == 3
    np.testing.assert_array_equal(w[:2], file_table)
    np.testing.assert_array_equal(w[2], file_table[1])


# ---------------------------------------------------------------------------
# the losses and one train step of each task
# ---------------------------------------------------------------------------


def test_indexed_contrastive_loss_matches_jax(row_norm):
    """Unnormalised features, image indices with repeats (rows 0, 2 and 3
    share an image): the loss and the features' gradients."""
    rng = np.random.default_rng(3)
    img, txt = (rng.normal(size=(5, 7)).astype(np.float32) for _ in range(2))
    idx = np.array([4, 1, 4, 4, 0])
    want, want_g = jax.value_and_grad(jobj.indexed_contrastive_loss, argnums=(0, 1))(
        jnp.asarray(img), jnp.asarray(txt), 0.07, jnp.asarray(idx))
    ti, tt = T(img).requires_grad_(True), T(txt).requires_grad_(True)
    loss = objectives.indexed_contrastive_loss(ti, tt, 0.07, T(idx))
    np.testing.assert_allclose(loss.item(), float(want), rtol=1e-5)
    for g, w in zip(torch.autograd.grad(loss, (ti, tt)), want_g):
        _close(g, w, 1e-4, 1e-6)


def _retrieval_case(albef_cfgs, rng):
    jc, tc = albef_cfgs
    model, j_model, variables = _albef_task("retrieval", tc, jc)
    px, ids, mask = _albef_inputs(jc, rng, b=4)
    px[3] = px[0]  # rows 0 and 3 show one image: ITA positives of each other
    batch = {"pixels": px, "text_ids": ids, "text_mask": mask,
             "idx": np.array([0, 1, 2, 0], np.int32)}
    J = jtasks.AlbefRetrieval

    def jfwd(p, b):  # the four methods
        img = j_model.apply(p, b["pixels"], method=J.image_features)
        txt = j_model.apply(p, b["text_ids"], b["text_mask"], method=J.text_features)
        itm = j_model.apply(p, txt[1], b["text_mask"], img[1][::-1], method=J.itm_score)
        return (*img, *txt, itm, *j_model.apply(p, b["pixels"], b["text_ids"], b["text_mask"]))

    def tfwd(m, b):
        img = m.image_features(b["pixels"])
        txt = m.text_features(b["text_ids"], b["text_mask"])
        for feat in (img[0], txt[0]):
            np.testing.assert_allclose(torch.linalg.vector_norm(feat, dim=-1).numpy(), 1.0,
                                       rtol=1e-6)
        itm = m.itm_score(txt[1], b["text_mask"], img[1].flip(0))
        return (*img, *txt, itm, *m(b["pixels"], b["text_ids"], b["text_mask"]))

    return (variables, model, batch, lambda p, b, k: jobj.retrieval_train_loss(j_model, p, b, k),
            objectives.retrieval_train_loss, jfwd, tfwd)


def _classify_case(kind):
    def case(albef_cfgs, rng):
        jc, tc = albef_cfgs
        model, j_model, variables = _albef_task(kind, tc, jc)
        px, ids, mask = _albef_inputs(jc, rng, b=3, pairs=kind == "nlvr2")
        batch = {"pixels": px, "text_ids": ids, "text_mask": mask,
                 "labels": np.array([2, 0, 1] if kind == "ve" else [1, 0, 1], np.int32)}

        def jloss(p, b, key):
            loss = jobj.nlvr2_loss(j_model.apply(p, b["pixels"], b["text_ids"], b["text_mask"]),
                                   b["labels"])
            return loss, {"loss": loss}

        def tloss(m, b, key):
            loss = objectives.nlvr2_loss(m(b["pixels"], b["text_ids"], b["text_mask"]),
                                         b["labels"])
            return loss, {"loss": loss}

        def jfwd(p, b):
            return (j_model.apply(p, b["pixels"], b["text_ids"], b["text_mask"]),)

        def tfwd(m, b):
            return (m(b["pixels"], b["text_ids"], b["text_mask"]),)

        return variables, model, batch, jloss, tloss, jfwd, tfwd
    return case


def _vlmo_irtr_case(albef_cfgs, rng):
    jc, tc = tiny_vlmo_configs(VOCAB, depth=2)
    model = init_vlmo_weights(VLMo(tc.vlmo), 0).eval()
    j_model = JVLMo(jc.vlmo)
    size = jc.vlmo.image_size
    ids, mask = _text(rng, 3, jc.vlmo.max_text_len)
    batch = {"pixels": rng.uniform(-1, 1, (3, size, size, 3)).astype(np.float32),
             "text_ids": ids, "text_mask": mask}
    return (jax_params_of(model), model, batch,
            lambda p, b, k: jobj.vlmo_irtr_train_loss(j_model, p, b, k, num_negs=2),
            lambda m, b, k: objectives.vlmo_irtr_train_loss(m, b, k, num_negs=2), None, None)


def _vlmo_nlvr2_case(albef_cfgs, rng):
    model, j_model, variables, jc = _vlmo_nlvr2()
    size = jc.vlmo.image_size
    ids, mask = _text(rng, 3, jc.vlmo.max_text_len)
    batch = {"pixels1": rng.uniform(-1, 1, (3, size, size, 3)).astype(np.float32),
             "pixels2": rng.uniform(-1, 1, (3, size, size, 3)).astype(np.float32),
             "text_ids": ids, "text_mask": mask, "labels": np.array([1, 0, 1], np.int32)}

    def jloss(p, b, key):
        logits = j_model.apply(p, b["pixels1"], b["pixels2"], b["text_ids"], b["text_mask"],
                               method=JVLMo.nlvr2_logits)
        loss = jobj.nlvr2_loss(logits, b["labels"])
        return loss, {"loss": loss}

    def tloss(m, b, key):
        loss = objectives.nlvr2_loss(
            m.nlvr2_logits(b["pixels1"], b["pixels2"], b["text_ids"], b["text_mask"]),
            b["labels"])
        return loss, {"loss": loss}

    def jfwd(p, b):  # two different images
        return (j_model.apply(p, b["pixels1"], b["pixels2"], b["text_ids"], b["text_mask"],
                              method=JVLMo.nlvr2_logits),)

    def tfwd(m, b):
        return (m.nlvr2_logits(b["pixels1"], b["pixels2"], b["text_ids"], b["text_mask"]),)

    return variables, model, batch, jloss, tloss, jfwd, tfwd


STEP_CASES = {"retrieval": _retrieval_case, "ve": _classify_case("ve"),
              "nlvr2": _classify_case("nlvr2"), "vlmo_irtr": _vlmo_irtr_case,
              "vlmo_nlvr2": _vlmo_nlvr2_case}


@pytest.mark.parametrize("task", list(STEP_CASES))
def test_train_step_matches_jax(albef_cfgs, row_norm, task):
    """The model's outputs (the heads' logits; retrieval's
    ``image_features``, ``text_features``, ``itm_score`` and ``__call__``;
    ``VLMo.nlvr2_logits``), then one AdamW step of each task's loss from the
    same parameters on the same batch, the JAX draws replayed through
    ``JaxKey`` (retrieval's hard negatives, IRTR's caption offsets), the
    outputs and the step in one JAX program: the loss and its terms, every
    gradient (as Adam's first moment after the step, ``0.1 g``, in both
    packages), ``grad_norm`` and every parameter after the step.  A
    parameter moves by ``lr g / (|g| + eps)`` (the first step's normalised
    update, eps 1e-8): an error ``dg`` allowed in ``g`` moves it by up to
    ``lr eps dg / (|g| + eps)^2``, which the parameters' bound adds to 1e-4
    lr (at most 2 lr, a flipped sign)."""
    rng = np.random.default_rng(4)
    params, model, batch, jloss, tloss, jfwd, tfwd = STEP_CASES[task](albef_cfgs, rng)
    key, lr, eps = jax.random.key(11), 1e-3, 1e-8
    tx = joptim.create_optimizer(params, "adamw", lr, weight_decay=0.02)
    j_step = jtrainer.make_train_step(jloss, tx, donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (j_state, j_metrics), j_out = jax.jit(lambda p: (
        j_step(jtrainer.create_train_state(p, tx), jb, key),
        jfwd(p, jb) if jfwd else ()))(params)
    want_g = {n: 10 * g for n, g in port_layout(model, adam_mu(j_state.opt_state)).items()}

    if tfwd:
        with torch.no_grad():
            t_out = tfwd(model, _port_batch(batch))
        assert len(t_out) == len(j_out)
        for got, want in zip(t_out, j_out):
            _close(got, want)
    t_params = optim.named_params(model)
    t_tx = optim.create_optimizer(model, "adamw", lr, weight_decay=0.02)
    state = trainer.create_train_state(model, t_tx)
    state, metrics = trainer.make_train_step(tloss, t_tx)(state, _port_batch(batch), JaxKey(key))
    for k in j_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(j_metrics[k]),
                                   rtol=1e-4 if k == "grad_norm" else 1e-5, err_msg=k)
    largest = max(float(np.abs(g).max()) for g in want_g.values())
    assert largest > 0
    want = port_layout(model, j_state.params)
    for name, p in t_params.items():
        g, w = 10 * state.opt_state["mu"][name].numpy(), want_g[name]
        atol = max(1e-5 * float(np.abs(w).max()), 1e-6 * largest)
        np.testing.assert_allclose(g, w, rtol=1e-3, atol=atol, err_msg=name)
        dg = atol + 1e-3 * np.abs(w)
        moved = np.minimum(lr * (1e-4 + eps * dg / (np.abs(w) + eps) ** 2), 2 * lr)
        np.testing.assert_array_less(np.abs(p.detach().numpy() - want[name]),
                                     moved + 1e-5 * np.abs(want[name]) + 1e-12, err_msg=name)


def test_vlmo_irtr_loss_refuses_a_batch_of_one():
    _, model, batch, *_ = _vlmo_irtr_case(None, np.random.default_rng(0))
    batch = _port_batch({k: v[:1] for k, v in batch.items()})
    with pytest.raises(ValueError, match="batch >= 2"):
        objectives.vlmo_irtr_train_loss(model, batch, TorchKey(0, torch.device("cpu")))


# ---------------------------------------------------------------------------
# the task metrics
# ---------------------------------------------------------------------------


def test_task_metrics_match_jax():
    """Two batches of each kind of metric (accuracy with -100 labels, the
    VQA score, a scalar; a batch with every label ignored), through both
    registries with a ``reduce_fn``: the same epoch values, then reset."""
    rng = np.random.default_rng(5)
    tasks = ["mlm", "vqa", "irtr", "nlvr2", "other"]
    reduce = lambda total, count: (2 * total, 2 * count)  # noqa: E731
    regs = [jmetrics.TaskMetricRegistry(tasks, reduce), task_metrics.TaskMetricRegistry(tasks,
                                                                                         reduce)]
    for _ in range(2):
        logits = rng.normal(size=(4, 6, 9)).astype(np.float32)
        labels = rng.integers(0, 9, (4, 6))
        labels[0] = -100
        targets = (rng.uniform(size=(4, 9)) * (rng.uniform(size=(4, 9)) > 0.5)).astype(np.float32)
        for reg in regs:
            reg.update("mlm", loss=1.5, logits=logits, labels=labels)
            reg.update("mlm", logits=logits[:1], labels=labels[:1])  # every label ignored
            reg.update("vqa", loss=0.3, logits=logits[:, 0], targets=targets)
            reg.update("irtr", loss=0.7, logits=logits[:, 0, :2])
            reg.update("nlvr2", loss=0.2, logits=logits[:, 0, :2], labels=labels[:, 1] % 2)
            reg.update("other", loss=2.0)
    want, got = (reg.epoch_wrapup() for reg in regs)
    assert got.keys() == want.keys() and "the_metric" in got
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-12), k
    assert regs[1].epoch_wrapup() == regs[0].epoch_wrapup()  # both reset


# ---------------------------------------------------------------------------
# the CLI on the CPU
# ---------------------------------------------------------------------------


def _shallow_vlmo(cfg):
    """Two VLMo blocks, a split block and the VL expert."""
    return dataclasses.replace(cfg, vlmo=dataclasses.replace(cfg.vlmo, depth=2,
                                                             vlffn_start_layer=1))


def _cli_files(tmp_path):
    """A vocabulary, five 40 px JPEGs, one annotation file a dialect
    (captions over repeated images, VE sentences with string labels and a
    name without ``.jpg``, NLVR pairs with "True"/"False"), and a tiny
    RunConfig json (ALBEF's text side cut, VLMo at two blocks); returns the
    vocabulary and the common CLI arguments."""
    toks = list(SPECIAL_TOKENS) + ["a", "the", "dog", "cat", "red", "two", "is", "in"]
    for c in "abcdefghijklmnopqrstuvwxyz":
        toks += [c, f"##{c}"]
    (tmp_path / "vocab.txt").write_text("\n".join(toks) + "\n")
    _images(tmp_path, [f"{i}.jpg" for i in range(5)])
    sentences = ["a red dog", "the cat is red", "two dogs", "a dog in the cat"]
    files = {
        "retrieval": [{"image": f"{i % 3}.jpg", "caption": [sentences[i % 4]]}
                      for i in range(6)],
        "ve": [{"image": str(i), "sentence": sentences[i % 4],
                "label": ["entailment", "neutral", "contradiction"][i % 3]} for i in range(5)],
        "nlvr2": [{"images": [f"{i}.jpg", f"{(i + 1) % 5}.jpg"], "sentence": sentences[i % 4],
                   "label": ["True", "False"][i % 2]} for i in range(5)],
    }
    for name, ann in files.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(ann))
    cfg = _shallow_vlmo(shallow_albef(tcfg.tiny_test_config(vocab_size=len(toks))))
    tcfg.save_config(cfg, str(tmp_path / "cfg.json"))
    return toks, ["--vocab", str(tmp_path / "vocab.txt"), "--image-root", str(tmp_path),
                  "--batch-size", "2", "--lr", "1e-4", "--log-every", "1"]


ANN_OF = {"retrieval": "retrieval", "ve": "ve", "nlvr2": "nlvr2", "vlmo_irtr": "retrieval",
          "vlmo_nlvr2": "nlvr2"}


@pytest.mark.parametrize("task", list(ANN_OF))
def test_cli_trains_saves_and_resumes_on_the_cpu(tmp_path, task):
    """``train.cli.main`` for each task on its dialect's annotations and PIL
    images: 2 steps with a checkpoint after each, then a resume that
    continues from step 2 to 3; every loss and gradient norm finite."""
    _, argv = _cli_files(tmp_path)
    argv += ["--task", task, "--config", str(tmp_path / "cfg.json"), "--ann",
             str(tmp_path / f"{ANN_OF[task]}.json"), "--device", "cpu", "--ckpt-dir",
             str(tmp_path / "ck"), "--ckpt-every", "1"]
    first = cli.main(argv + ["--steps", "2"])
    assert first["task"] == task and first["step"] == 2 and len(first["losses"]) == 2
    assert sorted(find_train_steps(str(tmp_path / "ck"))) == [1, 2]
    second = cli.main(argv + ["--steps", "3"])
    assert second["start_step"] == 2 and second["step"] == 3 and len(second["losses"]) == 1
    assert np.isfinite(first["losses"] + second["losses"] + first["grad_norms"]).all()
    assert min(first["grad_norms"]) > 0


def test_init_ckpt_grafts_twelve_layers_into_nlvr(tmp_path, capsys):
    """``--task nlvr2 --init-ckpt``: a 12-layer ALBEF pre-trained file into
    NLVR's 18 layers (the CLI's ``AlbefNLVR``): the ViT and layers 0-11 take
    the file's values, layers 12-17 and the head keep the seed's, and the
    CLI trains from it."""
    toks, argv = _cli_files(tmp_path)
    base = tcfg.tiny_test_config(vocab_size=len(toks))
    cfg = dataclasses.replace(base, albef=dataclasses.replace(
        base.albef, bert=dataclasses.replace(base.albef.bert, num_layers=12, fusion_layer=6)))
    tcfg.save_config(cfg, str(tmp_path / "cfg12.json"))
    path = str(tmp_path / "albef.pth")
    torch.save({"model": synthetic.albef_pretrain_state_dict(
        cfg.albef, 2, src_image_size=cfg.albef.vit.image_size)}, path)
    argv += ["--task", "nlvr2", "--config", str(tmp_path / "cfg12.json"), "--ann",
             str(tmp_path / "nlvr2.json"), "--device", "cpu", "--init-ckpt", path]
    args = cli.build_argparser().parse_args(argv)
    model, _, _ = cli.build_task(args, cli.resolve_config(args, None, torch.device("cpu")),
                                 None, torch.device("cpu"))
    fresh = init_weights(albef_tasks.AlbefNLVR(cfg.albef), 0)
    assert len(model.text_encoder.layer) == 18
    tree = ckpt_io.load_albef_pretrain(path, cfg.albef)
    grafted = 0
    for (name, path_, transform, p), q in zip(flax_leaves(model), fresh.parameters()):
        node = tree
        for key in path_:
            node = node.get(key) if isinstance(node, dict) else None
        layer = int(name.split(".")[2]) if name.startswith("text_encoder.layer.") else None
        if node is None:
            assert torch.equal(p, q), name
            assert layer is None or layer >= 12, name
        else:
            np.testing.assert_array_equal(p.detach().numpy(), transform(np.asarray(node)))
            assert layer is None or layer < 12, name
            grafted += 1
    assert f"{grafted} tensors grafted" in capsys.readouterr().out
    summary = cli.main(argv + ["--steps", "1"])
    assert np.isfinite(summary["losses"]).all()
