"""The attack CLI of the port::

    python -m vqattack_tpu_torch.run --pipeline albef --vocab vocab.txt \\
        --ann vqa_val.json --image-root /data/val2014 --answer-list answers.json \\
        --right-part right.txt --surrogate-ans sur.json --target-ans tgt.json \\
        --paraphrases para.json --all-correct allc.json --output attack_out \\
        --surrogate-ckpt ALBEF.pth --victim-ckpt vqa.pth --bert-mlm bert-base-uncased/

Port of the ALBEF and VLMo paths of ``vqattack_tpu/run.py``: subset and
alignment guards -> the attack -> black-box victim check every
``eval_every`` samples -> artifacts.  ``--pipeline albef`` attacks the ALBEF
surrogate and ranks ``--answer-list`` with the ALBEF victim; ``--pipeline
vlmo`` attacks VLMo (``vlmo_attack_config``, or the geometry of
``--named-config``) and checks its 3,129-way VQA classifier, decoded through
``--id2answer``; a ``--config`` whose ``vlmo`` is ``config.vilt_base_config()``
attacks ViLT-B/32 (one shared FFN a block, 185 joint tokens at 384 px) the
same way.  ``--batch-size 1`` attacks one sample at a time; a larger
batch buffers ``--buffer-factor`` batches of samples and runs them through
the lockstep engine (``attacks/batched.py``), ``--pipeline-depth`` chunks at
a time; ``--mesh-devices N`` shards each chunk over N devices
(``parallel/mesh.py``: the first N cards, or N replicas on the CPU with
``--device cpu``).  ``--distributed`` runs one rank of several that
``python -m torch.distributed.run --nproc_per_node R -m
vqattack_tpu_torch.run ... --distributed`` starts: each rank takes its
round-robin share of the samples, on ``cuda:{LOCAL_RANK}``, and the ranks
write one artifact directory.  ``--attn flash`` sends every attention
over at least 128 queries (ALBEF's ViT, VLMo's joint trunk) through the
flash kernel, which takes a
head dim of 64 or 34 (VLMo-base+, ``--named-config
task_finetune_vqa_base_plus_image480``).  ``--dtype bfloat16`` computes
the surrogate trunk in bf16
(the JAX package's mixed policy: the image, its gradient, the L-inf update,
the losses, the ALBEF victim and the candidate MLM stay float32; VLMo's
victim runs in the surrogate's dtype, as the JAX CLI runs it);
``--softmax-dtype`` and ``--tap-dtype`` set the attention softmax's dtype
and that of the stored clean feature targets.  Runs on ``cuda`` unless
``--device cpu``.

Weights: ``--surrogate-ckpt`` and ``--victim-ckpt`` load the reference's
``.pth`` files (``checkpoint/io.py``; VLMo's surrogate from 224 px, its
victim at the run's size, a separate module), ``--bert-mlm`` a Hugging Face
BERT directory as the candidate MLM; what no flag loads is random, drawn
from ``--seed``.  ``--calibrate-gate`` prints the similarity gate's score
profile and a suggested ``--bert-threshold`` before the attack.

Data: ``--ann`` VQA json annotations with ``--image-root`` JPEGs, or, with
``--pipeline vlmo``, ``--arrow`` VQAv2 tables of the reference's schema
(``data/arrow.py``; pyarrow and PIL needed), whose items carry the answers'
soft scores, which the alignment guard then weighs; either is decoded on
4 threads ahead of the attack (``iter_batches``).  The USE gate is not
ported.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
from typing import Optional

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="VQAttack on PyTorch + CUDA")
    p.add_argument("--pipeline", choices=["albef", "vlmo"], default="albef")
    p.add_argument("--config", default=None, help="RunConfig json")
    p.add_argument("--named-config", nargs="*", default=[],
                   help="VLMo named-config presets composed left to right (the "
                        "reference's `run.py with <names>`, e.g. "
                        "task_finetune_vqa_base_image480); sets the VLMo geometry")
    p.add_argument("--surrogate-ckpt", default=None,
                   help="the surrogate's .pth checkpoint (ALBEF pre-trained; VLMo at 224 px)")
    p.add_argument("--victim-ckpt", default=None,
                   help="the victim's .pth checkpoint (ALBEF VQA; VLMo VQA at the run's size)")
    p.add_argument("--bert-mlm", default=None,
                   help="Hugging Face BertForMaskedLM directory for the candidate MLM: "
                        "config.json with model.safetensors or pytorch_model.bin")
    p.add_argument("--arrow", nargs="*", default=[],
                   help="VLMo: VQAv2 arrow tables (the reference's make_arrow schema) "
                        "instead of --ann/--image-root")
    p.add_argument("--id2answer", default=None,
                   help="VLMo classifier index -> answer (json, or the reference's "
                        "dill pickle)")
    p.add_argument("--vocab", required=True, help="WordPiece vocab.txt")
    p.add_argument("--ann", nargs="*", default=[], help="VQA annotation json(s)")
    p.add_argument("--image-root", default="")
    p.add_argument("--answer-list", default=None)
    p.add_argument("--right-part", nargs="*", default=[])
    p.add_argument("--surrogate-ans", nargs="*", default=[])
    p.add_argument("--target-ans", nargs="*", default=[])
    p.add_argument("--paraphrases", nargs="*", default=[])
    p.add_argument("--all-correct", nargs="*", default=[])
    p.add_argument("--output", default="attack_out")
    p.add_argument("--answer-max-len", type=int, default=16,
                   help="token budget of the answer-list tokenization")
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--resume", action="store_true",
                   help="skip qids whose artifact already exists in --output")
    p.add_argument("--bert-threshold", type=float, default=None,
                   help="operating point of the BertMeanPoolGate in its own space")
    p.add_argument("--calibrate-gate", action="store_true",
                   help="before the attack, print the similarity gate's score profile "
                        "over the dataset's questions and a suggested --bert-threshold")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default=None,
                   help="surrogate trunk compute dtype (default: the config's "
                        "compute_dtype, float32); the image, its gradient, the L-inf "
                        "update and the losses stay float32 either way")
    p.add_argument("--softmax-dtype", choices=["float32", "bfloat16"], default=None,
                   help="dtype of the attention softmax over the scores on the product "
                        "+ softmax path (default: the config's, float32)")
    p.add_argument("--tap-dtype", choices=["float32", "bfloat16"], default=None,
                   help="storage dtype of the clean feature-target stacks the loss "
                        "reads every iteration (default: the config's, float32)")
    p.add_argument("--attn", choices=["xla", "flash"], default="xla",
                   help="attention over >= 128 queries: the explicit product + "
                        "softmax (xla) or the flash kernel (flash)")
    p.add_argument("--batch-size", type=int, default=1,
                   help=">1 runs same-schedule samples in lockstep batches "
                        "(attacks/batched.py)")
    p.add_argument("--buffer-factor", type=int, default=16,
                   help="buffer this many batches of samples before bucketing "
                        "them by (old_alg, k) and running them")
    p.add_argument("--pipeline-depth", type=int, default=4,
                   help="chunks in flight at once: one chunk's host text work "
                        "overlaps the next one's device work; 1 runs them in order")
    p.add_argument("--mesh-devices", type=int, default=0,
                   help="shard each lockstep chunk over a data mesh of this many devices "
                        "(the first N cards; N replicas with --device cpu); 0 = no mesh. "
                        "Needs --batch-size > 1, best a multiple of N")
    p.add_argument("--distributed", action="store_true",
                   help="one rank of `python -m torch.distributed.run`: a gloo group "
                        "from its environment, the rank's round-robin share of the "
                        "samples on cuda:LOCAL_RANK, one shared artifact directory")
    return p


def resolve_config(args):
    """--config if given, else the pipeline's attack preset; then VLMo's
    --named-config geometry, --seed, --output, the precision flags as the
    JAX ``resolve_config`` applies them (``--dtype`` -> ``compute_dtype``,
    ``--softmax-dtype`` -> the ViT's, BERT's and VLMo's ``softmax_dtype``,
    ``--tap-dtype`` -> ``attack.tap_dtype``), and the ALBEF path's kernel
    switch: the ViT's residual+LayerNorm sites take the fused kernel
    (``vit.fused_ln``) on the card (VLMo's blocks have plain LayerNorms, as
    in the JAX package).  Refuses ``--arrow`` outside the VLMo pipeline, and
    ``--attn flash`` on the card for a head dim the flash kernel does not
    take."""
    from vqattack_tpu_torch import config as cfg_mod
    from vqattack_tpu_torch.ops.attention import HEAD_DIMS

    if args.arrow and args.pipeline != "vlmo":
        raise SystemExit("--arrow: the arrow tables are the VLMo pipeline's data "
                         "(--pipeline vlmo); ALBEF reads --ann")
    if args.config:
        cfg = cfg_mod.load_config(args.config)
    elif args.pipeline == "vlmo":
        cfg = cfg_mod.vlmo_attack_config()
    else:
        cfg = cfg_mod.albef_attack_config()
    if args.named_config:
        if args.pipeline != "vlmo":
            raise SystemExit("--named-config presets are the VLMo pipeline's sacred surface; "
                             "use --config for the ALBEF pipeline")
        from vqattack_tpu_torch.named_configs import vlmo_config_from_named, vlmo_named_config

        vlmo = vlmo_config_from_named(vlmo_named_config(*args.named_config))
        cfg = dataclasses.replace(cfg, vlmo=dataclasses.replace(
            vlmo, remat=cfg.vlmo.remat, remat_scores=cfg.vlmo.remat_scores))
    cfg = dataclasses.replace(cfg, output_dir=args.output, seed=args.seed)
    if args.dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=args.dtype)
    if args.softmax_dtype:
        sm = args.softmax_dtype
        cfg = dataclasses.replace(cfg, albef=dataclasses.replace(
            cfg.albef, vit=dataclasses.replace(cfg.albef.vit, softmax_dtype=sm),
            bert=dataclasses.replace(cfg.albef.bert, softmax_dtype=sm)),
            vlmo=dataclasses.replace(cfg.vlmo, softmax_dtype=sm))
    if args.tap_dtype:
        cfg = dataclasses.replace(cfg, attack=dataclasses.replace(
            cfg.attack, tap_dtype=args.tap_dtype))
    if args.attn == "flash" and args.device == "cuda":
        hidden, heads, what = ((cfg.vlmo.hidden_size, cfg.vlmo.num_heads, "VLMo trunk")
                               if args.pipeline == "vlmo" else
                               (cfg.albef.vit.hidden_size, cfg.albef.vit.num_heads, "ALBEF ViT"))
        if hidden // heads not in HEAD_DIMS:
            raise SystemExit(f"--attn flash: the flash-attention kernel takes head dims "
                             f"{HEAD_DIMS}; the {what} has head dim {hidden // heads} ({hidden} "
                             f"over {heads} heads): run it with --attn xla")
    if args.device == "cuda" and args.pipeline == "albef":
        vit = dataclasses.replace(cfg.albef.vit, fused_ln=True)
        cfg = dataclasses.replace(cfg, albef=dataclasses.replace(cfg.albef, vit=vit))
    return cfg


def _load_checkpoint(what: str, loader, path: str, *args, **kw):
    """``loader(path, *args, **kw)``, its seconds printed on one line."""
    t0 = time.perf_counter()
    out = loader(path, *args, **kw)
    print(f"{what} checkpoint {path}: loaded in {time.perf_counter() - t0:.2f} s", flush=True)
    return out


_LAUNCHER_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def _init_distributed(args) -> str:
    """``--distributed``: join the gloo group of the ranks that
    ``python -m torch.distributed.run`` started (``init_method="env://"``);
    the group carries host values only (barriers, meter sums, the text
    merge).  Returns the rank's device: ``cuda:{LOCAL_RANK % cards}``, or
    ``cpu`` with ``--device cpu``.  Exits without the launcher's variables;
    raises without a card unless ``--device cpu``."""
    import torch.distributed as dist

    from vqattack_tpu_torch.device import resolve_device

    missing = [k for k in _LAUNCHER_ENV if k not in os.environ]
    if missing:
        raise SystemExit(f"--distributed: {', '.join(missing)} not set; start the ranks with "
                         f"python -m torch.distributed.run --nproc_per_node N -m "
                         f"vqattack_tpu_torch.run ... --distributed")
    if args.mesh_devices:
        raise SystemExit("--distributed runs one card a rank; --mesh-devices shards one "
                         "process's chunks over several: use one or the other")
    device = resolve_device(args.device)
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ["LOCAL_RANK"]) % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group(backend="gloo", init_method="env://")
    print(f"rank {dist.get_rank()} of {dist.get_world_size()}: device {device}, backend "
          f"{dist.get_backend()}", flush=True)
    return str(device)


def _build_pipeline(args, cfg, tokenizer, device=None):
    """Surrogate, victim and candidate MLM on ``args.device``, random from
    ``--seed`` and then loaded from whichever of ``--surrogate-ckpt``,
    ``--victim-ckpt`` and ``--bert-mlm`` are given; the BertMeanPoolGate
    over the surrogate's text tower; the pipeline.  Without
    ``--victim-ckpt`` VLMo's victim is its surrogate module, with the VQA
    head (the JAX CLI's victim without it).  The surrogate computes in
    ``cfg.compute_dtype``, and so does VLMo's victim (the JAX CLI applies
    the victim's parameters to the surrogate's module); the ALBEF victim
    and the candidate MLM stay float32.  ``device`` (a rank's card) takes
    the place of ``--device``."""
    from vqattack_tpu_torch.checkpoint import io as ckpt_io
    from vqattack_tpu_torch.device import resolve_device
    from vqattack_tpu_torch.models.albef import init_weights
    from vqattack_tpu_torch.models.bert import FusionBert
    from vqattack_tpu_torch.text.similarity import make_gate

    device = resolve_device(device or args.device)
    mlm_cfg = dataclasses.replace(cfg.albef.bert, fusion_layer=cfg.albef.bert.num_layers)
    kw = {}
    if args.bert_threshold is not None:
        kw["bert_threshold"] = args.bert_threshold
    if args.pipeline == "vlmo":
        from vqattack_tpu_torch.attacks.vlmo_orchestrator import (VlmoAttackPipeline,
                                                                  load_id2answer)
        from vqattack_tpu_torch.models.vlmo import VLMo, init_vlmo_weights

        with torch.device(device):
            model = init_vlmo_weights(VLMo(cfg.vlmo, dtype=cfg.compute_dtype), seed=args.seed)
            victim = (init_vlmo_weights(VLMo(cfg.vlmo, dtype=cfg.compute_dtype),
                                        seed=args.seed + 3)
                      if args.victim_ckpt else None)
            mlm = init_weights(FusionBert(mlm_cfg, with_mlm_head=True), seed=args.seed + 1)
        if args.surrogate_ckpt:  # the pre-trained surrogate is a 224 px checkpoint
            _load_checkpoint("surrogate", ckpt_io.load_vlmo, args.surrogate_ckpt, cfg.vlmo,
                             src_image_size=224, into=model)
        if args.victim_ckpt:
            _load_checkpoint("victim", ckpt_io.load_vlmo, args.victim_ckpt, cfg.vlmo,
                             into=victim)
        if args.bert_mlm:
            _load_checkpoint("candidate MLM", ckpt_io.load_hf_bert_mlm, args.bert_mlm, into=mlm)

        @torch.no_grad()
        def vlmo_text(ids, mask):
            return model.infer_text(ids, mask)["text_feats"]

        gate = make_gate("bert", embed_fn=vlmo_text, tokenizer=tokenizer,
                         max_length=cfg.vlmo.max_text_len, device=device, **kw)
        id2answer = load_id2answer(args.id2answer) if args.id2answer else {}
        return VlmoAttackPipeline(cfg, model, tokenizer, gate, victim=victim, mlm_model=mlm,
                                  id2answer=id2answer, device=device)

    from vqattack_tpu_torch.attacks.orchestrator import AlbefAttackPipeline
    from vqattack_tpu_torch.models.albef import AlbefPretrain, AlbefVQA

    with torch.device(device):
        surrogate = init_weights(AlbefPretrain(cfg.albef, dtype=cfg.compute_dtype),
                                 seed=args.seed)
        victim = init_weights(AlbefVQA(cfg.albef), seed=args.seed + 3)
        mlm = init_weights(FusionBert(mlm_cfg, with_mlm_head=True), seed=args.seed + 1)
    if args.surrogate_ckpt:
        _load_checkpoint("surrogate", ckpt_io.load_albef_pretrain, args.surrogate_ckpt,
                         cfg.albef, into=surrogate)
    if args.victim_ckpt:
        _load_checkpoint("victim", ckpt_io.load_albef_vqa, args.victim_ckpt, cfg.albef,
                         into=victim)
    if args.bert_mlm:
        _load_checkpoint("candidate MLM", ckpt_io.load_hf_bert_mlm, args.bert_mlm, into=mlm)

    @torch.no_grad()
    def embed_fn(ids, mask):
        return surrogate.text_tower(ids, mask)

    gate = make_gate("bert", embed_fn=embed_fn, tokenizer=tokenizer,
                     max_length=cfg.attack.max_text_len, device=device, **kw)
    return AlbefAttackPipeline(cfg, surrogate, tokenizer, gate, victim=victim,
                               mlm_model=mlm, device=device)


def main(argv: Optional[list] = None) -> dict:
    args = build_argparser().parse_args(argv)
    from vqattack_tpu_torch.ops.attention import attention_impl

    device = _init_distributed(args) if args.distributed else None
    try:
        with attention_impl(args.attn):
            return _main(args, device)
    finally:
        if args.distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


def _mesh(args, device: torch.device):
    """The data mesh of ``--mesh-devices``: the first N cards, or N replicas
    on the CPU; none at batch size 1 (the engine is not used), as in the
    JAX CLI."""
    if not args.mesh_devices or args.batch_size <= 1:
        return None
    from vqattack_tpu_torch.parallel.mesh import make_mesh

    if device.type == "cpu":
        return make_mesh(devices=[device] * args.mesh_devices)
    return make_mesh(args.mesh_devices)


def _main(args, device: Optional[str] = None) -> dict:
    from vqattack_tpu_torch.attacks.batched import BatchedAlbefAttack, BatchedVlmoAttack
    from vqattack_tpu_torch.attacks.orchestrator import save_artifacts
    from vqattack_tpu_torch.data.side_tables import SideTables
    from vqattack_tpu_torch.data.transforms import test_transform
    from vqattack_tpu_torch.data.vqa import VQADataset
    from vqattack_tpu_torch.eval.metrics import AttackAccuracy, all_reduce_mean
    from vqattack_tpu_torch.rng import TorchKey
    from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer

    cfg = resolve_config(args)
    tokenizer = WordPieceTokenizer.from_file(args.vocab)
    side = None
    if args.right_part:
        side = SideTables.load(args.right_part, args.surrogate_ans, args.target_ans,
                               args.paraphrases, args.all_correct)
    vlmo = args.pipeline == "vlmo"
    group = None
    if args.distributed:
        import torch.distributed as dist

        group = dist.group.WORLD
    pipeline = _build_pipeline(args, cfg, tokenizer, device)
    size = cfg.vlmo.image_size if vlmo else cfg.albef.vit.image_size
    if args.arrow:
        from vqattack_tpu_torch.data.arrow import VQAv2ArrowDataset

        dataset = VQAv2ArrowDataset(args.arrow, test_transform(size))
    else:
        dataset = VQADataset(args.ann, args.image_root, test_transform(size),
                             answer_list=args.answer_list)
    if args.calibrate_gate:
        from vqattack_tpu_torch.text.calibrate import gate_score_profile, suggest_threshold

        questions = [dataset[i]["question"] for i in range(min(len(dataset), 64))]
        profile = gate_score_profile(pipeline.gate, questions)
        print(profile.table())
        try:
            print(f"suggested threshold: {suggest_threshold(profile):.4f}")
        except ValueError:
            print("suggested threshold: n/a (not enough probe data)")
    if not vlmo:
        if not dataset.answer_list:
            raise SystemExit("--answer-list is required for --pipeline albef: the ALBEF "
                             "victim ranks a fixed candidate-answer list (model_vqa.py:149)")
        ids, mask = tokenizer.encode_batch([a + "[SEP]" for a in dataset.answer_list],
                                           max_length=args.answer_max_len)
        answer_ids = torch.as_tensor(ids, dtype=torch.long, device=pipeline.device)
        answer_mask = torch.as_tensor(mask, dtype=torch.long, device=pipeline.device)

    flip = AttackAccuracy(print_every=50)
    key = TorchKey(cfg.seed, pipeline.device)
    batched = None
    if args.batch_size > 1:
        batched = (BatchedVlmoAttack if vlmo else BatchedAlbefAttack)(
            pipeline, mesh=_mesh(args, pipeline.device))
    results, pending, attack_s, occupancy = [], [], [], []
    sample_buffer: list = []

    def eval_pending():
        # one victim call per chunk of at most 16 pairs: ALBEF's rank_answer
        # holds batch x k decoder rows in its second pass
        todo = [(r, clean) for r, clean in pending if clean is not None]
        for start in range(0, len(todo), 16):
            chunk = todo[start : start + 16]
            images, texts = [r.adv_image for r, _ in chunk], [r.adv_text for r, _ in chunk]
            if vlmo:
                preds = [a for _, a in pipeline.evaluate_victim_batch(images, texts)]
            else:
                topk_ids, _ = pipeline.evaluate_victim_batch(images, texts, answer_ids,
                                                             answer_mask)
                preds = [dataset.answer_list[int(row[0])] for row in topk_ids]
            for (_, clean), pred in zip(chunk, preds):
                flip.update(pred, clean)
                flip.maybe_log()
        pending.clear()

    def flush_buffer():
        if not sample_buffer:
            return
        t0 = time.perf_counter()
        out = batched.run(sample_buffer, batch_size=args.batch_size, rng=key,
                          pipeline_depth=args.pipeline_depth)
        dt = (time.perf_counter() - t0) / max(1, len(out))
        occupancy.append(batched.last_occupancy)
        clean_of = {s["qid"]: s["surrogate_answer"] for s in sample_buffer}
        for r in out:
            attack_s.append(dt)
            results.append(r)
            pending.append((r, clean_of[r.qid]))
        sample_buffer.clear()
        if len(pending) >= cfg.eval_every:
            eval_pending()

    # a rank's share: every world-th item of the raw stream from its rank,
    # counted before the subset and alignment filters, as the JAX CLI's
    # (n_seen - 1) % world == rank; a rank decodes only its own items
    rank, world = ((dist.get_rank(group), dist.get_world_size(group)) if group is not None
                   else (0, 1))
    items = dataset.iter_batches(range(rank, len(dataset), world))
    with contextlib.closing(items):
        for item in items:
            qid = item["qid"]
            info = side.attack_inputs(qid) if side else {
                "paraphrase": None, "target_answer": None,
                "all_correct_answers": [], "surrogate_answer": None,
            }
            if info is None:
                continue  # not in the attack subset
            # alignment guard (adv_attack.py:416-427; VLMo's test_step,
            # vlmo_module.py:1735-1741): the stored surrogate answer must be a
            # max-weight ground-truth answer, else the sample is skipped.  json
            # items carry weights, arrow items answer_scores; without either,
            # uniform weights make the guard a membership check
            if side and item.get("answers"):
                answers = item["answers"]
                weights = (item.get("weights") or item.get("answer_scores")
                           or [1.0] * len(answers))
                if not side.alignment_ok(qid, answers, weights):
                    continue
            if args.resume and os.path.exists(os.path.join(args.output, f"{qid}.pt")):
                continue
            if batched is not None:
                sample_buffer.append({
                    "qid": str(qid), "pixels": item["pixels"], "question": item["question"],
                    "paraphrase": info["paraphrase"], "target_answer": info["target_answer"],
                    "all_correct_answers": info["all_correct_answers"],
                    "surrogate_answer": info["surrogate_answer"],
                })
                if len(sample_buffer) >= args.buffer_factor * args.batch_size:
                    flush_buffer()
                if args.limit and len(results) + len(sample_buffer) >= args.limit:
                    flush_buffer()
                    break
                continue
            t0 = time.perf_counter()
            res = pipeline.attack_sample(
                item["pixels"], item["question"], str(qid), info["paraphrase"],
                info["target_answer"], info["all_correct_answers"], key=key,
            )
            attack_s.append(time.perf_counter() - t0)
            results.append(res)
            pending.append((res, info["surrogate_answer"]))
            if len(pending) >= cfg.eval_every:
                eval_pending()
            if args.limit and len(results) >= args.limit:
                break
    if batched is not None:
        flush_buffer()
    eval_pending()
    save_artifacts(results, args.output, group=group)
    summary = {"samples": len(results), "attack_accuracy": flip.value}
    if group is not None:
        counts = torch.tensor([len(results)], dtype=torch.float64)
        dist.all_reduce(counts, group=group)
        summary.update({"rank": rank, "world_size": world,
                        "samples_all_ranks": int(counts.item()),
                        "attack_accuracy_all_ranks": all_reduce_mean(flip.flips, group)})
    if not args.victim_ckpt:
        summary["attack_accuracy_note"] = ("random-weight victim (no --victim-ckpt): flips are "
                                           "no evidence of attack success")
    summary.update({
        "mean_attack_s": float(np.mean(attack_s)) if attack_s else 0.0,
        "device": str(pipeline.device),
        "pipeline": args.pipeline,
        "output": args.output,
    })
    if batched is not None and batched.mesh is not None:
        summary["mesh_devices"] = [str(d) for d in batched.mesh.devices]
    if occupancy:
        # real rows over padded rows of every chunk the engine ran
        summary["bucket_occupancy"] = float(np.mean(occupancy))
    if batched is not None and batched._timer.acc:
        summary["phase_s"] = dict(sorted(batched._timer.acc.items(), key=lambda kv: -kv[1]))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
