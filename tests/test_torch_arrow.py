"""The port's arrow data path (``--arrow``, ``data/arrow.py``) against the
JAX package's, on tables written by the JAX package's own writer
(``vqattack_tpu/data/arrow_writer.py::write_vqa_arrow``).

- ``VQAv2ArrowDataset``: every item (pixels, question, qid, answers, answer
  labels and soft scores) equal to the JAX dataset's, over one table and
  over two concatenated;
- ``run.py --pipeline vlmo --arrow ... --device cpu``: the setup of JAX's
  ``tests/test_run_cli.py::test_cli_vlmo_arrow_path`` with a second
  question whose stored surrogate answer is not a max-score answer, run
  through both CLIs: both attack the first question, and the alignment
  guard, which reads the arrow items' ``answer_scores``, skips the second
  in both.  (The two CLIs draw their random weights differently, so the
  images themselves are not compared.)

Pixels are compared exactly (the JAX package's NHWC against the port's
NCHW): both packages decode the same bytes with PIL and apply the same
bicubic resize and normalisation in float32.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import pytest
import torch

pytest.importorskip("PIL")
pytest.importorskip("pyarrow")

from PIL import Image  # noqa: E402

from torch_port_util import nchw  # noqa: E402
from vqattack_tpu import config as jcfg  # noqa: E402
from vqattack_tpu.data.arrow import VQAv2ArrowDataset as JArrowDataset  # noqa: E402
from vqattack_tpu.data.arrow_writer import write_vqa_arrow  # noqa: E402
from vqattack_tpu.data.transforms import test_transform as jax_transform  # noqa: E402
from vqattack_tpu.text.tokenizer import SPECIAL_TOKENS  # noqa: E402
from vqattack_tpu_torch import config as tcfg  # noqa: E402
from vqattack_tpu_torch import run as port_run  # noqa: E402
from vqattack_tpu_torch.data.arrow import VQAv2ArrowDataset  # noqa: E402
from vqattack_tpu_torch.data.transforms import test_transform as port_transform  # noqa: E402

WORDS = ["what", "color", "is", "the", "dog", "cat", "red", "blue"]


def _write_table(tmp_path, name: str, questions, annotations, images) -> str:
    """A VQAv2 arrow table by the JAX writer: ``images`` maps image ids to
    seeds of random 40 px JPEGs."""
    img_dir = tmp_path / f"{name}_img"
    img_dir.mkdir()
    for image_id, seed in images.items():
        rng = np.random.default_rng(seed)
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), np.uint8)).save(
            img_dir / f"COCO_val2014_{image_id:012d}.jpg")
    (tmp_path / f"{name}_q.json").write_text(json.dumps({"questions": questions}))
    (tmp_path / f"{name}_a.json").write_text(json.dumps({"annotations": annotations}))
    path = tmp_path / f"{name}.arrow"
    write_vqa_arrow(str(tmp_path / f"{name}_q.json"), str(tmp_path / f"{name}_a.json"),
                    str(img_dir), str(path))
    return str(path)


def _q(qid, image_id, text):
    return {"question": text, "question_id": qid, "image_id": image_id}


def _a(qid, answers):
    return {"question_id": qid, "answers": [{"answer": a} for a in answers]}


@pytest.fixture
def tables(tmp_path):
    """Two tables: two images with two and one questions, then one image
    with one question whose answers are mixed."""
    first = _write_table(
        tmp_path, "first",
        [_q(500, 1, "what color is the dog?"), _q(501, 1, "what color is the cat?"),
         _q(502, 2, "is the dog red?")],
        [_a(500, ["red"] * 10), _a(501, ["blue"] * 7 + ["red"] * 3), _a(502, ["yes"] * 7)],
        {1: 0, 2: 1})
    second = _write_table(tmp_path, "second", [_q(600, 3, "what is the dog?")],
                          [_a(600, ["cat"] * 2 + ["dog"] * 3)], {3: 2})
    return first, second


@pytest.mark.parametrize("which", ["one", "two"])
def test_arrow_items_equal_jax(tables, which):
    paths = list(tables[:1] if which == "one" else tables)
    t = VQAv2ArrowDataset(paths, port_transform(32))
    j = JArrowDataset(paths, jax_transform(32))
    assert len(t) == len(j) == (3 if which == "one" else 4)
    assert t.index_mapper == j.index_mapper
    items = list(t)
    assert len(items) == len(t)
    for i, item in enumerate(items):
        ref = j[i]
        assert set(item) == set(ref) == {"pixels", "question", "qid", "answers",
                                         "answer_labels", "answer_scores"}
        assert item["pixels"].shape == (1, 3, 32, 32) and item["pixels"].dtype == np.float32
        # the JAX package's pixels are NHWC, the port's NCHW
        np.testing.assert_array_equal(item["pixels"], nchw(ref["pixels"]))
        for key in ("question", "qid", "answers", "answer_labels", "answer_scores"):
            assert item[key] == ref[key], key
    assert items[0]["question"] == "what color is the dog?"  # VLMo keeps its '?'


def _write_vocab(path) -> int:
    toks = list(SPECIAL_TOKENS) + WORDS
    for c in "abcdefghijklmnopqrstuvwxyz":
        toks += [c, f"##{c}"]
    path.write_text("\n".join(toks) + "\n")
    return len(toks)


def test_cli_vlmo_arrow_path_matches_the_jax_cli(tmp_path, tables, capsys):
    """Both CLIs over the first table with the side tables of questions 500
    and 501: 500 is attacked (one artifact, its adversarial text), 501 is
    skipped by the alignment guard ("red" scores 0.9 there, under "blue"'s
    1.0), 502 is not in the subset."""
    from vqattack_tpu.run import main as jmain

    vocab_size = _write_vocab(tmp_path / "vocab.txt")
    side = {"right.txt": "500\n501\n", "sur.json": {"500": "red", "501": "red"},
            "tgt.json": {"500": "red", "501": "red"},
            "para.json": {"500": ["red", "the dog is red"], "501": ["red", "the cat is red"]},
            "allc.json": {"500": ["red"], "501": ["red", "blue"]}}
    for name, obj in side.items():
        (tmp_path / name).write_text(obj if isinstance(obj, str) else json.dumps(obj))
    # two VLMo blocks (a split block, then the VL expert): the JAX attack
    # programs' compiles scale with depth
    base = jcfg.tiny_test_config()
    j_cfg = dataclasses.replace(
        base, vlmo=dataclasses.replace(base.vlmo, vocab_size=vocab_size, depth=2,
                                       vlffn_start_layer=1),
        albef=dataclasses.replace(base.albef, bert=dataclasses.replace(
            base.albef.bert, vocab_size=vocab_size)),
        data=dataclasses.replace(base.data, image_size=32), eval_every=1)
    jcfg.save_config(j_cfg, str(tmp_path / "jcfg.json"))
    t_cfg = tcfg.tiny_test_config(vocab_size=vocab_size)
    t_cfg = dataclasses.replace(t_cfg, eval_every=1, vlmo=dataclasses.replace(
        t_cfg.vlmo, depth=2, vlffn_start_layer=1))
    tcfg.save_config(t_cfg, str(tmp_path / "tcfg.json"))
    common = ["--pipeline", "vlmo", "--vocab", str(tmp_path / "vocab.txt"),
              "--arrow", tables[0], "--right-part", str(tmp_path / "right.txt"),
              "--surrogate-ans", str(tmp_path / "sur.json"),
              "--target-ans", str(tmp_path / "tgt.json"),
              "--paraphrases", str(tmp_path / "para.json"),
              "--all-correct", str(tmp_path / "allc.json")]
    jmain(common + ["--config", str(tmp_path / "jcfg.json"), "--output", str(tmp_path / "j"),
                    "--no-pallas"])
    summary = port_run.main(common + ["--config", str(tmp_path / "tcfg.json"),
                                      "--output", str(tmp_path / "t"), "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == summary
    assert summary["samples"] == 1 and summary["pipeline"] == "vlmo"
    for out in ("j", "t"):
        assert sorted(p.name for p in (tmp_path / out).iterdir()) == [
            "500.npy", "500.pt", "adv_txt_dict.json"], out
    j_img, t_img = np.load(tmp_path / "j" / "500.npy"), np.load(tmp_path / "t" / "500.npy")
    assert t_img.shape == j_img.shape == (1, 32, 32, 3)
    clean = VQAv2ArrowDataset([tables[0]], port_transform(32))[0]["pixels"]
    assert np.abs(torch.load(tmp_path / "t" / "500.pt").numpy() - clean).max() <= \
        t_cfg.attack.eps + 1e-6
    j_txt = json.loads((tmp_path / "j" / "adv_txt_dict.json").read_text())
    t_txt = json.loads((tmp_path / "t" / "adv_txt_dict.json").read_text())
    assert set(j_txt) == set(t_txt) == {"500"}
