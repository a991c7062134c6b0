"""Batched multi-sample attack: the sweep's throughput engine.

Port of ``vqattack_tpu/attacks/batched.py``: the ALBEF engine and its VLMo
subclass, which swaps the target and ``aux`` adapters and the text dialect.
Samples that share a block schedule run in lockstep: one PGD loop advances
the whole batch, the VL step harvests every sample's text-embedding
gradients at once, and the candidate sentences of all samples are embedded
and gated in single device calls.  The host does the WordPiece bookkeeping
between blocks.

Mesh (``mesh=``, ``parallel/mesh.py``): each PGD block runs one row
slice of the chunk on each device of the mesh's data axis at once, one host
thread a device, each on its own replica of the surrogate; on a data x
model mesh each replica's parameters are cut column-wise over its row
(``parallel/tensor.py``) and its activations gathered on the row's first
device.  Every draw is
made at the whole chunk's size and sliced (``rng.py::RowsKey``), so a
sample's start and masks do not depend on the mesh.  The host text attack
between blocks works on the gathered chunk.  A chunk whose rows do not
divide by the data axis runs whole on the mesh's first device (warned).

Bucketing: the schedule is fixed by ``k``, the number of substitutable
words (``compute_iter_schedule``), so a bucket is the samples with equal
``(old_alg, k)``.  A bucket's last chunk pads to the next power of two by
repeating its last sample; the padding results are dropped.

MAR-label alignment can drift per sample mid-attack (a substitution changes
the masked paraphrase's token count); such a bucket switches its second PGD
step to a per-sample convex mix ``w*MAR + (1-w)*feature``.

Every block takes the fused block forms of ``attacks/pgd.py`` (clean targets
inside block 0, the VL step at the end of each block but the last).  The
keys follow the JAX engine's structure (a ``fold_in`` per chunk, a ``split``
per block), so the tests can replay the JAX draws.  A chunk pads to the
next power of two, floored at the data axis and rounded up to a multiple of
it, and capped at the batch size, as the JAX engine pads.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import os
import threading
import time
from collections import defaultdict, deque
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vqattack_tpu_torch.attacks import albef as albef_losses
from vqattack_tpu_torch.attacks import vlmo as vlmo_losses
from vqattack_tpu_torch.attacks.mar_labels import MarLabels, build_mar_labels
from vqattack_tpu_torch.attacks.orchestrator import AlbefAttackPipeline, AttackResult
from vqattack_tpu_torch.attacks.pgd import pgd_alternating_block, pgd_feature_block
from vqattack_tpu_torch.attacks.text_attack import (
    SubstitutionRequest,
    WordCandidates,
    apply_substitutions_to_paraphrase,
    generate_candidates_batch,
    select_substitutions_multi,
)
from vqattack_tpu_torch.models.albef import AlbefPretrain
from vqattack_tpu_torch.models.vlmo import VLMo
from vqattack_tpu_torch.parallel.mesh import DATA_AXIS, map_shards, shard_params, shard_rows
from vqattack_tpu_torch.rng import RowsKey, TorchKey, clone_key
from vqattack_tpu_torch.text.similarity import next_pow2


class PhaseTimer:
    """Wall-clock attribution of the sweep's phases.  Enabled with
    ``VQATTACK_PHASE_TIMING=1``; a phase entered with ``sync=True``
    synchronizes the CUDA device before it is charged, so asynchronous
    device work counts in the phase that launched it."""

    def __init__(self, enabled: bool, device: Optional[torch.device] = None):
        self.enabled = enabled
        self.device = device
        self.acc: Dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()  # pipelined buckets time concurrently

    def add(self, name: str, seconds: float) -> None:
        if self.enabled:
            with self._lock:
                self.acc[name] += seconds

    @contextlib.contextmanager
    def phase(self, name: str, sync: bool = False):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync and self.device is not None and self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.add(name, time.perf_counter() - t0)

    def report(self, log_fn=print) -> None:
        if not self.enabled or not self.acc:
            return
        total = sum(self.acc.values())
        parts = ", ".join(
            f"{k}={v:.2f}s" for k, v in sorted(self.acc.items(), key=lambda kv: -kv[1])
        )
        log_fn(f"phase timing: {parts} (sum {total:.2f}s)")


def _make_timer(device: Optional[torch.device] = None) -> PhaseTimer:
    return PhaseTimer(os.environ.get("VQATTACK_PHASE_TIMING") == "1", device)


# sweep preparation batches the candidate-MLM forwards and the question
# embeddings this many samples per device call
_PREPARE_CHUNK = 64


def _mixed_loss(feat, mlm):
    """Per-sample convex mix of the MAR loss ``mlm`` and the feature loss
    ``feat``, weighted by ``aux['mlm_weight'] [B]``: the batched form of the
    reference's per-sample shape fallback (``fgm:102-118``)."""

    def loss_fn(adv_px, key, aux):
        k1, k2 = key.split(2)
        _, ps_feat = feat(adv_px, k1, aux)
        _, ps_mlm = mlm(adv_px, k2, aux)
        w = aux["mlm_weight"]
        ps = w * ps_mlm + (1.0 - w) * ps_feat
        return ps.sum(), ps

    return loss_fn


@functools.lru_cache(maxsize=None)
def make_mixed_second_loss(model: AlbefPretrain):
    """The mixed second loss of ALBEF buckets (:func:`_mixed_loss`)."""
    return _mixed_loss(albef_losses.make_feature_loss(model), albef_losses.make_mlm_loss(model))


@functools.lru_cache(maxsize=None)
def make_vlmo_mixed_second_loss(model: VLMo):
    """The mixed second loss of VLMo buckets (:func:`_mixed_loss`)."""
    return _mixed_loss(vlmo_losses.make_feature_loss(model), vlmo_losses.make_mlm_loss(model))


@dataclasses.dataclass
class _SampleState:
    qid: str
    question: str
    adv_text: str
    mar: MarLabels
    mar_words: List[str]
    cands: WordCandidates
    ori_emb: np.ndarray
    substitutions: List[Tuple[str, str]]


class BatchedAlbefAttack:
    """Lockstep attack over buckets of same-schedule samples.  Subclassed by
    :class:`BatchedVlmoAttack`, which swaps the adapters below."""

    _target_keys = ("tgt_img", "tgt_txt")
    # text dialect: VLMo strips and re-appends '?' around questions and ends
    # every encoded paraphrase sentence with '.' (vlmo_module.py:1539,1644,
    # 1756,1802); ALBEF's text arrives pre_question-normalized, no appends
    _question_suffix = ""
    _sentence_suffix = ""

    def __init__(self, pipeline: AlbefAttackPipeline, mesh=None):
        """``mesh``: a ``parallel/mesh.py`` mesh; each chunk's rows shard
        over its data axis, each position with its own replica of the
        surrogate, cut over its row where the model axis is above 1 (the
        victim and the candidate MLM stay on the pipeline's device)."""
        self.p = pipeline
        self.mesh = mesh
        self._mixed_loss = self._mixed_second_loss(pipeline)
        self._timer = _make_timer(pipeline.device)
        self.last_occupancy = 1.0
        self.last_chunk_sizes: List[int] = []
        # (pipeline view, its mixed second loss) of each data-axis device
        self._replicas: List[Tuple[Any, Any]] = []
        if mesh is not None:
            for device, module in zip(mesh.devices,
                                      shard_params(self._surrogate(pipeline), mesh)):
                view = pipeline.replica(module, device)
                self._replicas.append((view, _mixed_loss(view._feature_loss, view._mlm_loss)))

    @staticmethod
    def _surrogate(pipeline):
        return pipeline.surrogate

    @staticmethod
    def _mixed_second_loss(pipeline):
        return make_mixed_second_loss(pipeline.surrogate)

    @property
    def _max_text_len(self) -> int:
        return self.p.cfg.attack.max_text_len

    def _tensor(self, a, dtype=torch.long) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.p.device)

    def _block_aux(self, targets, ids, mask, n):
        """``targets=None`` (block 0) omits the target entries: the block
        computes them from the original question."""
        token_mask = (np.arange(self._max_text_len)[None] < n[:, None]).astype(np.float32)
        aux = {
            "text_ids": self._tensor(ids),
            "text_mask": self._tensor(mask),
            "txt_token_mask": self._tensor(token_mask, torch.float32),
            "special_ids": self.p._special,
        }
        if targets is not None:
            aux.update(targets)
        return aux

    # ------------------------------------------------------------------ prep

    def _prepare_many(self, samples: Sequence[Dict[str, Any]]) -> List[_SampleState]:
        """Per-sample attack state for the whole sweep at once: the
        candidate-MLM forwards (:func:`generate_candidates_batch`) and the
        question embeddings batch ``_PREPARE_CHUNK`` samples per device
        call.  Results are those of the per-sample path."""
        p, atk = self.p, self.p.cfg.attack
        mars = []
        for sample in samples:
            if sample.get("paraphrase") and sample.get("target_answer"):
                mars.append(build_mar_labels(
                    sample["paraphrase"], sample["target_answer"],
                    sample.get("all_correct_answers", ()),
                    p.tokenizer, self._max_text_len, atk.max_answers,
                    sentence_suffix=self._sentence_suffix,
                ))
            else:
                mars.append(MarLabels(1, None, None, None, [], [], [], 0))
        if p.mlm_model is not None:
            qs = [s["question"].strip(self._question_suffix) if self._question_suffix
                  else s["question"] for s in samples]
            cands_list = generate_candidates_batch(
                qs, p.tokenizer, p.candidate_mlm_topk,
                p.filter_words, total_iters=atk.num_iters, top_k=atk.mlm_top_k,
                score_threshold=atk.mlm_score_threshold, max_mlm_batch=_PREPARE_CHUNK,
            )
        else:
            # no candidate MLM: image-only attack, one full-budget PGD block
            cands_list = [WordCandidates([], [], [], []) for _ in samples]
        ori_embs: List[np.ndarray] = []
        for start in range(0, len(samples), _PREPARE_CHUNK):
            texts = [s["question"] for s in samples[start : start + _PREPARE_CHUNK]]
            ori_embs.extend(np.asarray(p.embed_texts(texts)))
        return [
            _SampleState(
                qid=str(sample["qid"]), question=sample["question"],
                adv_text=sample["question"], mar=mar,
                mar_words=list(mar.paraphrase_words), cands=cands,
                ori_emb=ori_emb, substitutions=[],
            )
            for sample, mar, cands, ori_emb in zip(samples, mars, cands_list, ori_embs)
        ]

    @staticmethod
    def bucket_key(state: _SampleState) -> Tuple[int, int]:
        return (state.mar.old_alg, len(state.cands.iter_list))

    # ---------------------------------------------------------------- attack

    def _mlm_aux(self, states: List[_SampleState], aux: Dict[str, Any]) -> bool:
        """Add the MAR entries to ``aux``; True where the second loss is the
        per-sample mix (some sample's labels no longer align), False where
        it is the MLM loss."""
        tok = self.p.tokenizer
        mlm_ids, mlm_mask, weights = [], [], []
        for s in states:
            ci, cm = tok.encode(" ".join(s.mar_words) + self._sentence_suffix,
                                self._max_text_len)
            mlm_ids.append(ci)
            mlm_mask.append(cm)
            weights.append(1.0 if int(cm.sum()) == s.mar.true_len else 0.0)
        aux["mlm_ids"] = self._tensor(np.stack(mlm_ids))
        aux["mlm_mask"] = self._tensor(np.stack(mlm_mask))
        aux["mlm_labels"] = self._tensor(np.stack([s.mar.labels for s in states]))
        if all(w == 1.0 for w in weights):
            return False
        aux["mlm_weight"] = self._tensor(weights, torch.float32)
        return True

    def _shards(self, b: int):
        """``(pipeline, lo, hi, mixed second loss)`` of each row shard of a
        ``b``-row chunk: the whole chunk on the pipeline without a mesh."""
        if self.mesh is None:
            return [(self.p, 0, b, self._mixed_loss)]
        return [(view, lo, hi, mixed) for (view, mixed), (_, lo, hi)
                in zip(self._replicas, shard_rows(self.mesh, b))]

    @staticmethod
    def _place(aux: Dict[str, Any], view, lo: int, hi: int) -> Dict[str, Any]:
        """A shard's ``aux``: the rows ``lo:hi`` of every batch entry on the
        shard's device; the relative-position biases its replica's own; the
        special ids as they are."""
        out = {}
        for k, v in aux.items():
            if k == "rel_biases":
                out[k] = view._rel_biases
            elif isinstance(v, torch.Tensor):
                out[k] = v[lo:hi].to(view.device)
            else:
                out[k] = v
        return out

    def attack_bucket(self, pixels: np.ndarray, states: List[_SampleState], rng
                      ) -> List[AttackResult]:
        """Attack one bucket: ``pixels [B, 3, H, W]``, one state per row,
        ``rng`` an ``rng.py`` key."""
        p, atk = self.p, self.p.cfg.attack
        b = len(states)
        if pixels.shape[0] != b:
            raise ValueError(f"{pixels.shape[0]} images for {b} states")
        if any(self.bucket_key(s) != self.bucket_key(states[0]) for s in states):
            raise ValueError("a bucket's samples must share (old_alg, k)")
        old_alg = states[0].mar.old_alg
        iter_list = states[0].cands.iter_list or [atk.num_iters]

        shards = self._shards(b)
        # each shard's images, and its keys: without a mesh the chunk's key,
        # on a mesh a copy of it a shard drawing the whole chunk's rows
        ori_px = [torch.as_tensor(pixels[lo:hi], dtype=torch.float32, device=view.device)
                  for view, lo, hi, _ in shards]
        adv_px = list(ori_px)
        keys = ([rng] if self.mesh is None else
                [RowsKey(clone_key(rng), lo, hi, b, view.device) for view, lo, hi, _ in shards])
        ori_ids, ori_mask = p.tokenizer.encode_batch([s.question for s in states],
                                                     self._max_text_len)
        n_ori = np.asarray(ori_mask).sum(1)
        r_tgt, r_pgd = _split(keys)
        targets: List[Optional[Dict[str, torch.Tensor]]] = [None] * len(shards)  # block 0
        feat_losses: List[List[np.ndarray]] = [[] for _ in range(b)]
        mlm_losses: List[List[np.ndarray]] = [[] for _ in range(b)]
        vl_steps = 0

        # VL-step gather width [B, P]: floored at max_sub_words and rounded
        # up to a power of two, as the JAX engine's program lattice does
        max_p = max((len(s.cands.attack_positions) for s in states), default=0)
        if max_p > 0:
            max_p = next_pow2(max(max_p, atk.max_sub_words))
        pos = np.zeros((b, max(max_p, 1)), np.int64)
        for j, s in enumerate(states):
            ap = s.cands.attack_positions
            pos[j, : len(ap)] = ap
        positions = self._tensor(pos)
        kw = dict(eps=atk.eps, eps_iter=atk.step_size, clip_min=atk.clip_min,
                  clip_max=atk.clip_max, norm=atk.norm)

        for block_idx, block_iters in enumerate(iter_list):
            with self._timer.phase("block_prep"):
                ids, mask = p.tokenizer.encode_batch([s.adv_text for s in states],
                                                     self._max_text_len)
                n = np.minimum(np.asarray(mask).sum(1), n_ori)
                aux = self._block_aux(None, ids, mask, n)
                if block_idx == 0:
                    aux["ori_ids"] = self._tensor(ori_ids)
                    aux["ori_mask"] = self._tensor(ori_mask)
                mixed = old_alg != 1 and self._mlm_aux(states, aux)
            r_pgd, r_block = _split(r_pgd)
            r_pgd, r_vl = _split(r_pgd)
            if block_iters > atk.num_iters:
                raise ValueError(f"block_iters={block_iters} exceeds the attack budget "
                                 f"num_iters={atk.num_iters}")
            is_last = block_idx == len(iter_list) - 1 or max_p == 0

            def block(i):
                view, lo, hi, mixed_loss = shards[i]
                aux_i = self._place(aux, view, lo, hi)
                if targets[i] is not None:
                    aux_i.update(targets[i])
                common = dict(
                    x=adv_px[i], ori_x=ori_px[i], key=r_block[i], vl_key=r_vl[i],
                    tgt_key=r_tgt[i], rand_init=block_idx == 0 and atk.rand_init,
                    do_vl=not is_last, positions=positions[lo:hi].to(view.device), aux=aux_i,
                    target_keys=self._target_keys, **kw,
                )
                targets_fn = view._targets_fn if block_idx == 0 else None
                if old_alg == 1:
                    adv, losses, tgf, tgts = pgd_feature_block(
                        view._feature_loss, view._vl_loss, view._embed_text, targets_fn,
                        nb_iter=block_iters, max_iter=atk.num_iters, **common)
                    return adv, losses.cpu().numpy(), None, tgf, tgts
                second = mixed_loss if mixed else view._mlm_loss
                adv, fl, ml, tgf, tgts = pgd_alternating_block(
                    view._feature_loss, second, view._vl_loss, view._embed_text, targets_fn,
                    nb_iter=block_iters // 2, max_iter=atk.num_iters // 2, **common)
                return adv, fl.cpu().numpy(), ml.cpu().numpy(), tgf, tgts

            with self._timer.phase("pgd", sync=True):
                outs = map_shards(block, len(shards))
                fln = np.concatenate([o[1] for o in outs], axis=1)
                for j in range(b):
                    feat_losses[j].append(fln[:, j])
                if old_alg != 1:
                    mln = np.concatenate([o[2] for o in outs], axis=1)
                    for j in range(b):
                        mlm_losses[j].append(mln[:, j])
                adv_px = [o[0] for o in outs]
                if block_idx == 0:
                    targets = [dict(zip(self._target_keys, o[4])) for o in outs]
            if is_last:
                break
            vl_steps += 1
            with self._timer.phase("vl_step"):
                tg = np.concatenate([o[3].cpu().numpy() for o in outs])

            # substitution selection on the host; the bucket's candidate
            # embeddings and gate rounds batch into single device calls
            with self._timer.phase("substitution"):
                thr = p.gate.operating_point(atk.sim_threshold)
                reqs, req_j = [], []
                for j, s in enumerate(states):
                    if not s.cands.attack_word_indices:
                        continue
                    reqs.append(SubstitutionRequest(
                        s.adv_text, s.question, tg[j, : len(s.cands.attack_positions)],
                        s.cands, s.ori_emb, thr,
                    ))
                    req_j.append(j)
                outs = select_substitutions_multi(
                    reqs, p.embed_texts, p.gate.scores_pairs,
                    max_length=self._max_text_len, question_suffix=self._question_suffix,
                    timer=self._timer,
                ) if reqs else []
                for j, (new_text, ops) in zip(req_j, outs):
                    s = states[j]
                    s.adv_text = new_text
                    s.substitutions.extend(ops)
                    if old_alg == 0 and ops:
                        s.mar_words = apply_substitutions_to_paraphrase(s.mar_words, ops)

        adv_np = np.concatenate([a.cpu().numpy() for a in adv_px])
        return [
            AttackResult(
                qid=s.qid,
                adv_image=adv_np[j : j + 1],
                adv_text=s.adv_text,
                old_alg=old_alg,
                feat_losses=np.concatenate(feat_losses[j]) if feat_losses[j] else np.zeros(0),
                mlm_losses=np.concatenate(mlm_losses[j]) if mlm_losses[j] else None,
                num_blocks=len(iter_list),
                substitutions=s.substitutions,
                vl_steps=vl_steps,
            )
            for j, s in enumerate(states)
        ]

    # ------------------------------------------------------------------ sweep

    def _run_chunk(self, chunk: List[Tuple[_SampleState, dict]], n_real: int, rng
                   ) -> List[AttackResult]:
        """Assemble one padded bucket's pixels and states and attack it.
        The pixels are stacked here, inside the worker when pipelined, so
        only ``pipeline_depth`` buckets of pixels are resident at once."""
        px = np.concatenate([np.asarray(s["pixels"], np.float32) for _, s in chunk])
        # padding copies get fresh mutable state, so their (discarded)
        # substitutions cannot leak into the real sample they repeat
        states = [
            dataclasses.replace(st, mar_words=list(st.mar_words), substitutions=[])
            if idx >= n_real else st
            for idx, (st, _) in enumerate(chunk)
        ]
        return self.attack_bucket(px, states, rng)[:n_real]

    def run(self, samples: Sequence[Dict[str, Any]], batch_size: int = 8, rng=None,
            pipeline_depth: int = 1) -> List[AttackResult]:
        """Bucket by ``(old_alg, k)``, cut each bucket into chunks of
        ``batch_size`` (the last one padded to the next power of two by
        repeating its last sample), attack the chunks, drop the padding.
        Each sample is ``{qid, pixels [1, 3, H, W], question, paraphrase,
        target_answer, all_correct_answers}``; ``rng`` defaults to
        ``TorchKey(cfg.seed)``.

        ``pipeline_depth > 1`` runs that many chunks at once on a thread
        pool, so one chunk's host text work overlaps the next one's device
        work.  Each chunk depends only on its own state and its folded key,
        so the results equal the serial order's."""
        if rng is None:
            rng = TorchKey(self.p.cfg.seed, self.p.device)
        with self._timer.phase("prepare"):
            prepared = list(zip(self._prepare_many(samples), samples))
        buckets: Dict[Tuple[int, int], List[Tuple[_SampleState, dict]]] = {}
        for st, s in prepared:
            buckets.setdefault(self.bucket_key(st), []).append((st, s))

        # a chunk on a mesh pads at least to the data axis, to a multiple of
        # it (an indivisible chunk runs whole on the mesh's first device)
        min_b = 1 if self.mesh is None else self.mesh.shape[DATA_AXIS]
        chunks = []
        step = n_padded_rows = 0
        for key in sorted(buckets):
            entries = buckets[key]
            for i in range(0, len(entries), batch_size):
                chunk = entries[i : i + batch_size]
                n_real = len(chunk)
                target = max(next_pow2(n_real), min_b)
                target = min(batch_size, -(-target // min_b) * min_b)
                chunk += [chunk[-1]] * (target - n_real)
                step += 1
                n_padded_rows += target
                chunks.append((chunk, n_real, rng.fold_in(step)))
        # device time scales with padded rows: a low occupancy means the
        # caller's buffer is small for the spread of bucket keys
        self.last_occupancy = len(samples) / max(n_padded_rows, 1)
        self.last_chunk_sizes = [len(c) for c, _, _ in chunks]

        results: List[AttackResult] = []
        if pipeline_depth <= 1 or len(chunks) <= 1:
            for chunk, n_real, key in chunks:
                results.extend(self._run_chunk(chunk, n_real, key))
        else:
            with ThreadPoolExecutor(max_workers=pipeline_depth) as ex:
                pending = deque()
                for chunk, n_real, key in chunks:
                    if len(pending) >= pipeline_depth:
                        results.extend(pending.popleft().result())
                    pending.append(ex.submit(self._run_chunk, chunk, n_real, key))
                while pending:
                    results.extend(pending.popleft().result())
        self._timer.report()
        return results


def _split(keys) -> Tuple[list, list]:
    """Each shard's key split in two: (the first halves, the second
    halves)."""
    pairs = [k.split(2) for k in keys]
    return [a for a, _ in pairs], [b for _, b in pairs]


class BatchedVlmoAttack(BatchedAlbefAttack):
    """Lockstep VLMo buckets: the same block loop over a
    :class:`~vqattack_tpu_torch.attacks.vlmo_orchestrator.VlmoAttackPipeline`,
    with VLMo's targets (``tgt_layer_cls``/``tgt_tokens``/``tgt_token_mask``),
    its ``aux`` (the relative-position biases instead of ALBEF's token mask
    and special ids) and its text dialect."""

    _target_keys = ("tgt_layer_cls", "tgt_tokens", "tgt_token_mask")
    _question_suffix = "?"
    _sentence_suffix = "."

    @staticmethod
    def _surrogate(pipeline):
        return pipeline.model

    @staticmethod
    def _mixed_second_loss(pipeline):
        return make_vlmo_mixed_second_loss(pipeline.model)

    @property
    def _max_text_len(self) -> int:
        return self.p.max_text_len

    def _block_aux(self, targets, ids, mask, n):
        del n  # VLMo masks tokens by tgt_token_mask x the adversarial mask
        aux = {
            "text_ids": self._tensor(ids),
            "text_mask": self._tensor(mask),
            "rel_biases": self.p._rel_biases,
        }
        if targets is not None:
            aux.update(targets)
        return aux
