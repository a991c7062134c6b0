"""The port's CLI on the CPU with checkpoints: ``--surrogate-ckpt``,
``--victim-ckpt``, ``--bert-mlm`` and ``--calibrate-gate`` for ALBEF, the
first three for VLMo, on a tiny ``--config`` with synthetic checkpoints in
the reference's names (``checkpoint/synthetic.py``).  The loaded modules
hold the files' tensors, the summary has no ``attack_accuracy_note`` when a
victim checkpoint is given, and each load prints its seconds."""

from __future__ import annotations

import json

import pytest
import torch

from torch_port_util import synth_cli_assets
from vqattack_tpu_torch import config as tcfg
from vqattack_tpu_torch import run as port_run
from vqattack_tpu_torch.checkpoint import synthetic

SAMPLES = [(1001, "what color is the dog", "red", "the dog is red"),
           (1002, "what is the man holding", "frisbee", None)]


def _run_capturing_pipeline(monkeypatch, argv):
    """``run.main(argv)`` and the pipeline its ``_build_pipeline`` built."""
    built = []
    build = port_run._build_pipeline
    monkeypatch.setattr(port_run, "_build_pipeline",
                        lambda *a: built.append(build(*a)) or built[-1])
    return port_run.main(argv), built[0]


def _bert_dir(tmp_path, cfg):
    sd = synthetic.hf_bert_mlm_state_dict(cfg.albef.bert, seed=5)
    synthetic.save_hf_bert_dir(str(tmp_path / "bert"), cfg.albef.bert, sd)
    return sd


@pytest.mark.parametrize("victim", [True, False])
def test_cli_albef_with_checkpoints_on_cpu(tmp_path, capsys, monkeypatch, victim):
    argv = synth_cli_assets(tmp_path, SAMPLES)
    cfg = tcfg.load_config(argv[argv.index("--config") + 1])
    sur = synthetic.albef_pretrain_state_dict(cfg.albef, seed=1, src_image_size=224)
    torch.save({"model": sur, "config": {"image_res": 224}}, tmp_path / "ALBEF.pth")
    vic = synthetic.albef_vqa_state_dict(cfg.albef, seed=2, src_image_size=384)
    torch.save({"model": vic}, tmp_path / "vqa.pth")
    mlm = _bert_dir(tmp_path, cfg)
    argv += ["--surrogate-ckpt", str(tmp_path / "ALBEF.pth"), "--bert-mlm",
             str(tmp_path / "bert"), "--calibrate-gate"]
    if victim:
        argv += ["--victim-ckpt", str(tmp_path / "vqa.pth")]

    summary, pipe = _run_capturing_pipeline(monkeypatch, argv)
    out = capsys.readouterr().out
    assert summary["samples"] == 2 and summary["device"] == "cpu"
    assert ("attack_accuracy_note" in summary) == (not victim)
    assert json.loads(out.strip().splitlines()[-1]) == summary
    for what in ("surrogate", "candidate MLM") + (("victim",) if victim else ()):
        assert f"{what} checkpoint " in out and " s\n" in out
    assert "substitution" in out and "suggested threshold: " in out

    s = pipe.surrogate
    assert torch.equal(s.text_encoder.layer[3].crossattention_self.value.weight,
                       sur["text_encoder.bert.encoder.layer.3.crossattention.self.value.weight"])
    assert torch.equal(s.visual_encoder.blocks[1].attn.key.bias,
                       sur["visual_encoder.blocks.1.attn.qkv.bias"][32:64])
    assert torch.equal(pipe.mlm_model.embeddings.LayerNorm.weight,
                       mlm["bert.embeddings.LayerNorm.gamma"])
    assert torch.equal(pipe.mlm_model.mlm_head.decoder.weight,
                       mlm["bert.embeddings.word_embeddings.weight"])
    dec = pipe.victim.text_decoder.layer[1].crossattention_self.query.weight
    loaded = torch.equal(dec, vic["text_decoder.bert.encoder.layer.1.crossattention.self.query.weight"])
    assert loaded == victim


@pytest.mark.parametrize("victim", [True, False])
def test_cli_vlmo_with_checkpoints_on_cpu(tmp_path, capsys, monkeypatch, victim):
    """A pre-trained surrogate at 224 px in a deepspeed envelope (no VQA
    classifier) and a victim at the run's size with an NLVR2 head beside its
    VQA classifier, ``--batch-size 2 --attn flash``: the victim is a second
    module, the heads line names what was kept and dropped.  Without
    ``--victim-ckpt`` the surrogate module is the victim."""
    argv = synth_cli_assets(tmp_path, [(q, t + "?", a, p) for q, t, a, p in SAMPLES])
    i = argv.index("--answer-list")
    del argv[i : i + 2]
    (tmp_path / "id2answer.json").write_text(json.dumps({str(i): f"ans{i}" for i in range(16)}))
    cfg = tcfg.load_config(argv[argv.index("--config") + 1])
    sur = synthetic.vlmo_state_dict(cfg.vlmo, seed=3, src_image_size=224)
    torch.save({"module": {f"module.{k}": v for k, v in sur.items()}}, tmp_path / "vlmo.pt")
    vic = synthetic.vlmo_state_dict(cfg.vlmo, seed=4,
                                    heads=("vqa_classifier", "nlvr2_classifier"))
    torch.save({"state_dict": vic}, tmp_path / "vlmo_vqa.pt")
    _bert_dir(tmp_path, cfg)
    argv += ["--pipeline", "vlmo", "--id2answer", str(tmp_path / "id2answer.json"),
             "--surrogate-ckpt", str(tmp_path / "vlmo.pt"), "--bert-mlm", str(tmp_path / "bert"),
             "--batch-size", "2", "--attn", "flash"]
    if victim:
        argv += ["--victim-ckpt", str(tmp_path / "vlmo_vqa.pt")]

    summary, pipe = _run_capturing_pipeline(monkeypatch, argv)
    out = capsys.readouterr().out
    assert summary["samples"] == 2 and summary["pipeline"] == "vlmo"
    assert ("attack_accuracy_note" in summary) == (not victim)
    assert "vlmo.pt: heads absent from the checkpoint, kept at their initial values: " \
           "vqa_classifier; checkpoint heads with no module, dropped: none" in out
    assert torch.equal(pipe.model.blocks[2].attn.value.bias, sur["transformer.blocks.2.attn.v_bias"])
    assert torch.equal(pipe.model.mlm_score.decoder.weight, sur["mlm_score.decoder.weight"])
    assert pipe.model.relative_position_bias_table.shape == vic["relative_position_bias_table"].shape
    if not victim:
        assert pipe.victim is pipe.model and "vlmo_vqa.pt" not in out
        return
    assert ("vlmo_vqa.pt: heads absent from the checkpoint, kept at their initial values: "
            "mlm_score, itm_score, itc_text_proj, itc_image_proj, itc_vl_text_proj, "
            "itc_vl_image_proj, logit_scale, logit_vl_scale; checkpoint heads with no module, "
            "dropped: nlvr2_classifier") in out
    assert pipe.victim is not pipe.model
    assert torch.equal(pipe.victim.vqa_classifier.fc2.weight, vic["vqa_classifier.3.weight"])
    assert torch.equal(pipe.victim.relative_position_bias_table, vic["relative_position_bias_table"])
