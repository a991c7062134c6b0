#!/usr/bin/env python3
"""How close float32 gets to VLMo's table gradient on the fine-tuning
tasks: flash (K3 with dbias) and xla (product + softmax), each against the
same step computed in float64.

    python3 scripts/table_grad_f64.py

For ``vlmo_irtr --preset task_finetune_irtr_f30k_base_image384`` and
``vlmo_nlvr2 --preset task_finetune_nlvr2_base_image384`` at batch 8 (the
CLI's model from seed 0, its first batch of ``chip_smoke.py``'s synthetic
annotations, the same caption offsets in every pass through
``chip_smoke.ReplayKey``), the first step's relative-position table
gradient three ways: flash in float32, xla in float32, and xla with every
layer in float64 (the model and the batch cast, the LayerNorms, softmaxes
and attention terms too).  Each float32 gradient against the float64 one
and against the other: the largest absolute difference, and the largest
over ``chip_smoke.TABLE_GRAD_TOL`` of the entry's mass (the float64 pass's
|bias gradients| gathered into it) or 1e-6 of the largest entry, with that
entry's table row, layer and head (``chip_smoke.py`` holds the kernel
against float64 attention by attention).  Prints one ``TABLE_GRAD_F64``
JSON line with the card's name and power limit.  Needs one CUDA device and the
kernels (built at first use).
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import tempfile

import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from vqattack_tpu_torch.models import layers  # noqa: E402
from vqattack_tpu_torch.ops import attention  # noqa: E402
from vqattack_tpu_torch.rng import TorchKey  # noqa: E402
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer  # noqa: E402
from vqattack_tpu_torch.train import cli as train_cli  # noqa: E402

TASKS = (("vlmo_irtr", cs.IRTR_PRESET), ("vlmo_nlvr2", cs.NLVR2_PRESET))


def _layer_norm_f64(self, x):
    return F.layer_norm(x.double(), self.normalized_shape, self.weight.double(),
                        self.bias.double(), self.eps)


def _to_f64(model):
    """A float64 copy of ``model``: parameters, compute and softmax dtypes."""
    m = copy.deepcopy(model).double()
    for mod in m.modules():
        for attr in ("compute_dtype", "softmax_dtype"):
            if hasattr(mod, attr):
                setattr(mod, attr, torch.float64)
    return m


def _worst(a, b, mass, h):
    """(largest |a - b|, largest |a - b| over its entry's tolerance, where)."""
    d = (a - b).abs()
    ratio = d / (cs.TABLE_GRAD_TOL * mass + 1e-6 * float(b.abs().max()))
    row, col = divmod(int(ratio.argmax()), ratio.shape[1])
    return {"max_abs": float(d.max()), "of_tol": float(ratio.max()),
            "entries_over": int((ratio > 1).sum()),
            "at": {"row": row, "layer": col // h, "head": col % h}}


def probe(task, preset, tmp, vocab, tokenizer):
    ann, pixels = cs.write_finetune_ann(tmp, task, 2 * cs.TRAIN_BATCH * cs.TRAIN_STEPS,
                                        cs.FINETUNE_SIZE, 1700)
    argv = ["--task", task, "--preset", preset, "--ann", ann, "--vocab", vocab,
            "--image-root", tmp, "--batch-size", str(cs.TRAIN_BATCH), "--device", "cuda",
            "--seed", str(cs.SEED)]
    parser = train_cli.build_argparser()
    args = parser.parse_args(argv)
    preset_cfg = train_cli.apply_preset(parser, args)
    cfg = train_cli.resolve_config(args, preset_cfg, torch.device("cuda"))
    model, loss_fn, collate = train_cli.build_task(args, cfg, tokenizer, torch.device("cuda"),
                                                   preset_cfg)
    with cs.served_pixels(pixels):
        dataset = train_cli.build_dataset(args, cfg.vlmo.image_size)
        batch = collate(next(train_cli._batches(dataset, args.batch_size, args.seed)))
    h = cfg.vlmo.num_heads
    key = cs.ReplayKey(TorchKey(cs.SEED, torch.device("cuda")))
    grads, layer_norm = {}, layers.LayerNorm.forward
    for impl in ("flash", "xla", "f64"):
        m, b = model, batch
        if impl == "f64":
            m = _to_f64(model)
            b = {k: v.double() if v.is_floating_point() else v for k, v in batch.items()}
            layers.LayerNorm.forward = _layer_norm_f64
        biases, kinds, table = [], [], m.relative_position_bias_table

        def gathered_bias(layer, kind, m=m, biases=biases, kinds=kinds, table=table):
            idx = getattr(m, f"_rel_index_{kind}")
            bias = table[:, layer * h:(layer + 1) * h][idx].permute(2, 0, 1)[None]
            biases.append(bias if impl == "f64" else bias.float())
            kinds.append((layer, kind))
            return biases[-1]

        m._rel_bias = gathered_bias
        try:
            with attention.attention_impl("flash" if impl == "flash" else "xla"):
                loss, _ = loss_fn(m, b, key)
                g, *layer_grads = torch.autograd.grad(loss, [table] + biases)
        finally:
            layers.LayerNorm.forward = layer_norm
        key.replay()
        grads[impl] = g.double()
    # the float64 pass's |bias gradients| gathered into each entry
    mass = cs._gathered(m, kinds, [x.abs() for x in layer_grads], h)
    out = {"task": task}
    truth = grads["f64"]
    out["largest"] = float(truth.abs().max())
    for a, b in (("flash", "f64"), ("xla", "f64"), ("flash", "xla")):
        out[f"{a}_vs_{b}"] = _worst(grads[a], grads[b], mass, h)
    out["rows"] = int(truth.shape[0])
    out["loss"] = loss.item()
    del model
    torch.cuda.empty_cache()
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("table_grad_f64: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    tmp = tempfile.mkdtemp(prefix="vqattack_table_grad_")
    paths = cs.write_assets(tmp)
    tokenizer = WordPieceTokenizer.from_file(paths["vocab"])
    results = [probe(task, preset, tmp, paths["vocab"], tokenizer) for task, preset in TASKS]
    print("TABLE_GRAD_F64 " + json.dumps({"results": results, "card": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
