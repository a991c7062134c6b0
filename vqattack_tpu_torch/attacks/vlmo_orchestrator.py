"""The VLMo attack orchestrator: the per-sample attack and the victim check.

Port of ``vqattack_tpu/attacks/vlmo_orchestrator.py`` (the reference's
``VLMo.test_step``, ``vlmo_module.py:1725-2093``).  Against the ALBEF
pipeline:

- text is fixed-length (``max_text_len`` = 40), and the VLMo text dialect
  holds: the question's trailing ``?`` is stripped before word-splitting and
  re-appended to every candidate sentence, and every encoded paraphrase
  sentence ends with ``.``;
- the clean targets are the per-layer cls stack and the masked token
  stack (``Gen_ori_feats``, ``vlmo_module.py:1287-1312``), deterministic;
- the relative-position biases are gathered once per pipeline
  (``VLMo.precompute_joint_biases``) and ride in every loss's ``aux``;
- the victim is the 3,129-way VQA classifier over the joint trunk
  (``vqa_test_step_after_pgd``, ``objectives.py:812-829``), by default the
  surrogate module itself, as the JAX CLI uses the surrogate's parameters
  when no victim checkpoint is given.

Every block takes the fused block forms of ``attacks/pgd.py``.  The keys
follow the JAX pipeline: a ``fold_in`` by qid, then one ``split`` per block
and one per VL step.
"""

from __future__ import annotations

import copy
import json
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vqattack_tpu_torch.attacks import vlmo as vlmo_losses
from vqattack_tpu_torch.attacks.losses import stacked
from vqattack_tpu_torch.attacks.mar_labels import MarLabels, build_mar_labels
from vqattack_tpu_torch.attacks.orchestrator import AttackResult, _frozen, pad_eval_batch
from vqattack_tpu_torch.attacks.pgd import pgd_alternating_block, pgd_feature_block
from vqattack_tpu_torch.attacks.text_attack import (
    apply_substitutions_to_paraphrase,
    generate_candidates,
    select_substitutions,
)
from vqattack_tpu_torch.config import RunConfig
from vqattack_tpu_torch.device import resolve_device
from vqattack_tpu_torch.models.bert import FusionBert
from vqattack_tpu_torch.models.vlmo import VLMo
from vqattack_tpu_torch.rng import TorchKey
from vqattack_tpu_torch.text.similarity import SimilarityGate, pad_to_bucket
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer

QUESTION_SUFFIX = "?"
SENTENCE_SUFFIX = "."


class VlmoAttackPipeline:
    def __init__(
        self,
        cfg: RunConfig,
        model: VLMo,
        tokenizer: WordPieceTokenizer,
        gate: SimilarityGate,
        victim: Optional[VLMo] = None,
        mlm_model: Optional[FusionBert] = None,
        id2answer: Optional[Dict[int, str]] = None,
        filter_words: Optional[frozenset] = None,
        device=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = _frozen(model, self.device)
        self.victim = self.model if victim is None else _frozen(victim, self.device)
        self.mlm_model = _frozen(mlm_model, self.device)
        self.tokenizer = tokenizer
        self.gate = gate
        self.id2answer = id2answer or {}
        if filter_words is None:
            from vqattack_tpu_torch.text.filter_words import default_filter_words

            filter_words = default_filter_words()
        self.filter_words = filter_words
        self._bind_model(self.model)
        self._victim_rel_biases = (self._rel_biases if self.victim is self.model
                                   else self.victim.precompute_joint_biases())
        self._target_keys = ("tgt_layer_cls", "tgt_tokens", "tgt_token_mask")

    def _bind_model(self, model: VLMo) -> None:
        self.model = model
        # parameter-only gathers, once (VLMo.precompute_joint_biases)
        self._rel_biases = model.precompute_joint_biases()
        self._feature_loss = vlmo_losses.make_feature_loss(model)
        self._mlm_loss = vlmo_losses.make_mlm_loss(model)
        self._vl_loss = vlmo_losses.make_vl_loss(model)

    def replica(self, model: VLMo, device) -> "VlmoAttackPipeline":
        """A view of this pipeline over ``model``, the surrogate's copy of
        one data-axis position of a mesh (``parallel/mesh.py::shard_params``),
        whose row starts at ``device``: the attack's losses, clean targets,
        relative-position biases (from the gathered table of a cut copy)
        and text embeddings bound to the copy, its inputs on ``device``;
        the victim (and its biases), the candidate MLM, the tokenizer and
        the gate shared."""
        view = copy.copy(self)
        view.device = torch.device(device)
        view._bind_model(model)
        return view

    # ------------------------------------------------------------------ utils

    @property
    def max_text_len(self) -> int:
        return self.model.cfg.max_text_len

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)

    def encode(self, text: str) -> Tuple[torch.Tensor, torch.Tensor]:
        ids, mask = self.tokenizer.encode(text, self.max_text_len)
        return self._ids(ids[None]), self._ids(mask[None])

    def _embed_text(self, ids: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.model.embed_text(ids)

    @torch.no_grad()
    def clean_targets(self, pixels, text_ids, text_mask):
        """``(tgt_layer_cls, tgt_tokens, tgt_token_mask)`` of the clean pair
        (``Gen_ori_feats``); the tokens stacked with a ``fused_feats``
        model too."""
        _, layer_cls, tokens, token_mask = self.model.attack_feats(
            pixels, text_ids, text_mask, self._rel_biases)
        tap = torch.bfloat16 if self.cfg.attack.tap_dtype == "bfloat16" else None
        return stacked(layer_cls, tap), stacked(tokens, tap), token_mask.float()

    def _targets_fn(self, ori_px, key, aux) -> Dict[str, torch.Tensor]:
        """The clean targets of the original question, for a first block;
        ``key`` is unused (VLMo's targets draw nothing)."""
        del key
        return dict(zip(self._target_keys,
                        self.clean_targets(ori_px, aux["ori_ids"], aux["ori_mask"])))

    @torch.no_grad()
    def candidate_mlm_topk(self, ids: np.ndarray, mask: np.ndarray):
        """(scores [B,S,K], ids [B,S,K]) of the candidate MLM, with the top-k
        taken on the device."""
        logits = self.mlm_model(self._ids(ids), self._ids(mask), mode="text")[2]
        s, i = torch.topk(logits, self.cfg.attack.mlm_top_k, dim=-1)
        return s.float().cpu().numpy(), i.cpu().numpy()

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        padded, n = pad_to_bucket(texts)
        ids, _ = self.tokenizer.encode_batch(padded, self.max_text_len)
        return self._embed_text(self._ids(ids))[:n].float().cpu().numpy()

    # ---------------------------------------------------------------- attack

    def attack_sample(
        self,
        pixels,                       # [1, 3, H, W] in [-1, 1], numpy or tensor
        question: str,
        qid: str,
        paraphrase: Optional[str],
        target_answer: Optional[str],
        all_correct_answers: Sequence[str] = (),
        key=None,
    ) -> AttackResult:
        """The full per-sample attack; ``key`` (an ``rng.py`` key) defaults to
        ``TorchKey(cfg.seed)`` on the pipeline's device."""
        atk = self.cfg.attack
        if key is None:
            key = TorchKey(self.cfg.seed, self.device)
        qid_fold = int(qid) if str(qid).isdigit() else zlib.crc32(str(qid).encode())
        r_pgd = key.fold_in(qid_fold % (2 ** 31))

        ori_px = torch.as_tensor(np.asarray(pixels), dtype=torch.float32, device=self.device)
        ori_text = adv_text = question
        if paraphrase is not None and target_answer is not None:
            mar = build_mar_labels(paraphrase, target_answer, all_correct_answers,
                                   self.tokenizer, self.max_text_len, atk.max_answers,
                                   sentence_suffix=SENTENCE_SUFFIX)
        else:
            mar = MarLabels(1, None, None, None, [], [], [], 0)
        old_alg = mar.old_alg

        ori_ids, ori_mask = self.encode(question)
        ori_emb = self._embed_text(ori_ids)[0].float().cpu().numpy()
        # the reference word-splits and substitutes on the question without
        # its '?' (vlmo_module.py:1539,1644,1923)
        cands = generate_candidates(
            question.strip(QUESTION_SUFFIX), self.tokenizer, self.candidate_mlm_topk,
            self.filter_words, total_iters=atk.num_iters, top_k=atk.mlm_top_k,
            score_threshold=atk.mlm_score_threshold,
        )
        iter_list = cands.iter_list if cands.iter_list else [atk.num_iters]
        mar_words = list(mar.paraphrase_words)

        adv_px = ori_px
        targets = None
        feat_losses: List[np.ndarray] = []
        mlm_losses: List[np.ndarray] = []
        all_ops: List[Tuple[str, str]] = []
        vl_steps = 0
        kw = dict(eps=atk.eps, eps_iter=atk.step_size, clip_min=atk.clip_min,
                  clip_max=atk.clip_max, norm=atk.norm)

        for block_idx, block_iters in enumerate(iter_list):
            first_block = block_idx == 0
            ids, mask = self.encode(adv_text)
            aux = {"text_ids": ids, "text_mask": mask, "rel_biases": self._rel_biases}
            if first_block:
                aux["ori_ids"], aux["ori_mask"] = ori_ids, ori_mask
            else:
                aux.update(zip(self._target_keys, targets))
            r_pgd, r_block = r_pgd.split(2)
            r_pgd, r_vl = r_pgd.split(2)
            if block_iters > atk.num_iters:
                raise ValueError(f"block_iters={block_iters} exceeds num_iters={atk.num_iters}")
            is_last = block_idx == len(iter_list) - 1 or not cands.attack_word_indices
            common = dict(
                x=adv_px, ori_x=ori_px, key=r_block, vl_key=r_vl, tgt_key=r_block,
                rand_init=first_block and atk.rand_init, do_vl=not is_last,
                positions=self._ids([cands.attack_positions or [0]]), aux=aux,
                target_keys=self._target_keys, **kw,
            )
            targets_fn = self._targets_fn if first_block else None
            if old_alg == 1:
                adv_px, losses, tg, tgts = pgd_feature_block(
                    self._feature_loss, self._vl_loss, self._embed_text, targets_fn,
                    nb_iter=block_iters, max_iter=atk.num_iters, **common)
                feat_losses.append(losses[:, 0].cpu().numpy())
            else:
                # label-alignment guard: a substitution that changes the
                # masked paraphrase's token count unaligns the labels, and
                # the MLM step falls back to the feature loss
                cur_ids, cur_mask = self.tokenizer.encode(
                    " ".join(mar_words) + SENTENCE_SUFFIX, self.max_text_len)
                aligned = int(cur_mask.sum()) == mar.true_len
                aux["mlm_ids"] = self._ids(cur_ids[None])
                aux["mlm_mask"] = self._ids(cur_mask[None])
                aux["mlm_labels"] = self._ids(mar.labels[None])
                second_loss = self._mlm_loss if aligned else self._feature_loss
                adv_px, fl, ml, tg, tgts = pgd_alternating_block(
                    self._feature_loss, second_loss, self._vl_loss, self._embed_text,
                    targets_fn, nb_iter=block_iters // 2, max_iter=atk.num_iters // 2,
                    **common)
                feat_losses.append(fl[:, 0].cpu().numpy())
                mlm_losses.append(ml[:, 0].cpu().numpy())
            if first_block:
                targets = tgts
            if is_last:
                break
            vl_steps += 1
            adv_text, ops = select_substitutions(
                adv_text, ori_text, tg[0].cpu().numpy(), cands, ori_emb,
                self.embed_texts, self.gate.scores,
                sim_threshold=self.gate.operating_point(atk.sim_threshold),
                max_length=self.max_text_len, question_suffix=QUESTION_SUFFIX,
            )
            all_ops.extend(ops)
            if old_alg == 0 and ops:
                mar_words = apply_substitutions_to_paraphrase(mar_words, ops)

        return AttackResult(
            qid=str(qid),
            adv_image=adv_px.cpu().numpy(),
            adv_text=adv_text,
            old_alg=old_alg,
            feat_losses=np.concatenate(feat_losses) if feat_losses else np.zeros(0),
            mlm_losses=np.concatenate(mlm_losses) if mlm_losses else None,
            num_blocks=len(iter_list),
            substitutions=all_ops,
            vl_steps=vl_steps,
        )

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def recover_answer_probe(self, adv_px, mar: MarLabels) -> Optional[str]:
        """The MLM answer-recovery diagnostic (``vlmo_module.py:2036-2051``):
        argmax-decode the masked paraphrase positions on the adversarial
        image; None on the feature-only path."""
        if mar.old_alg == 1:
            return None
        px = torch.as_tensor(np.asarray(adv_px), dtype=torch.float32, device=self.device)
        logits, _, _, _ = self.model.attack_mlm(px, self._ids(mar.mlm_ids[None]),
                                                self._ids(mar.mlm_mask[None]), self._rel_biases)
        out_ids = np.asarray(mar.mlm_ids).copy()
        pos = np.where(out_ids == self.tokenizer.mask_token_id)[0]
        pred = logits[0].argmax(-1).cpu().numpy()
        out_ids[pos] = pred[pos]
        return self.tokenizer.decode(out_ids[1:])

    def evaluate_victim(self, adv_image, adv_text: str) -> Tuple[int, str]:
        """The black-box check: the classifier's argmax -> id2answer
        (``vlmo_module.py:2063-2091``)."""
        return self.evaluate_victim_batch([adv_image], [adv_text])[0]

    @torch.no_grad()
    def evaluate_victim_batch(self, adv_images: Sequence[np.ndarray],
                              adv_texts: Sequence[str]) -> List[Tuple[int, str]]:
        """:meth:`evaluate_victim` for N pairs (each image ``[1, 3, H, W]``) in
        ONE classifier call over the power-of-two-padded batch."""
        if not adv_texts:
            return []
        px, ids, mask, n = pad_eval_batch(adv_images, adv_texts, self.tokenizer,
                                          self.max_text_len, self.device)
        logits = self.victim.vqa_logits(px, ids, mask, self._victim_rel_biases)
        preds = logits.argmax(-1)[:n].cpu().numpy()
        return [(int(p), self.id2answer.get(int(p), str(int(p)))) for p in preds]


def load_id2answer(path: str) -> Dict[int, str]:
    """``id2answer.txt``: the reference stores a dill-pickled defaultdict
    (``objectives.py:818-820``); JSON is read too."""
    try:
        with open(path) as f:
            d = json.load(f)
    except (UnicodeDecodeError, json.JSONDecodeError):
        # dill first: the reference's defaultdict factory is a lambda, which
        # the standard pickle cannot load
        try:
            import dill as pickle
        except ImportError:
            import pickle

        with open(path, "rb") as f:
            d = pickle.load(f)
    return {int(k): v for k, v in d.items()}
