"""The ALBEF attack orchestrator: the per-sample attack and the victim check.

Port of ``vqattack_tpu/attacks/orchestrator.py``.  For each sample the PGD
budget runs as ``k+1`` blocks (``adv_attack.py:385-715``) under the fused
block contract of the JAX package's production path (``dynamic_pgd`` +
``fused_block``): clean targets on block 0, rand-init on the first block
only, the VL joint step at the end of every block but the last.  Between
blocks the host runs the word substitution.

The pipeline holds the three resident models (surrogate, victim, candidate
MLM) on one device.  Their parameters are frozen: the attack differentiates
with respect to the pixels and the text embeddings only.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from vqattack_tpu_torch.attacks import albef as albef_losses
from vqattack_tpu_torch.attacks.mar_labels import MarLabels, build_mar_labels
from vqattack_tpu_torch.attacks.pgd import pgd_alternating_block, pgd_feature_block
from vqattack_tpu_torch.attacks.text_attack import (
    apply_substitutions_to_paraphrase,
    generate_candidates,
    select_substitutions,
)
from vqattack_tpu_torch.config import RunConfig
from vqattack_tpu_torch.device import resolve_device
from vqattack_tpu_torch.models.albef import AlbefPretrain, AlbefVQA, mlm_random_mask
from vqattack_tpu_torch.models.bert import FusionBert
from vqattack_tpu_torch.rng import TorchKey
from vqattack_tpu_torch.text.similarity import SimilarityGate, pad_to_bucket
from vqattack_tpu_torch.text.tokenizer import WordPieceTokenizer


@dataclasses.dataclass
class AttackResult:
    qid: str
    adv_image: np.ndarray          # [1, 3, H, W] float32
    adv_text: str
    old_alg: int
    feat_losses: np.ndarray        # per-iteration feature losses, all blocks
    mlm_losses: Optional[np.ndarray]
    num_blocks: int
    substitutions: List[Tuple[str, str]]
    vl_steps: int = 0              # VL joint steps taken (one per non-last block)


def _frozen(module: Optional[torch.nn.Module], device: torch.device):
    if module is None:
        return None
    module.to(device).eval()
    module.requires_grad_(False)
    return module


class AlbefAttackPipeline:
    def __init__(
        self,
        cfg: RunConfig,
        surrogate: AlbefPretrain,
        tokenizer: WordPieceTokenizer,
        gate: SimilarityGate,
        victim: Optional[AlbefVQA] = None,
        mlm_model: Optional[FusionBert] = None,
        filter_words: Optional[frozenset] = None,
        device=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.surrogate = _frozen(surrogate, self.device)
        self.victim = _frozen(victim, self.device)
        self.mlm_model = _frozen(mlm_model, self.device)
        self.tokenizer = tokenizer
        self.gate = gate
        if filter_words is None:
            from vqattack_tpu_torch.text.filter_words import default_filter_words

            filter_words = default_filter_words()
        self.filter_words = filter_words
        self._special = (tokenizer.mask_token_id, tokenizer.pad_token_id,
                         tokenizer.cls_token_id)
        self._feature_loss = albef_losses.make_feature_loss(self.surrogate)
        self._mlm_loss = albef_losses.make_mlm_loss(self.surrogate)
        self._vl_loss = albef_losses.make_vl_loss(self.surrogate)
        self._target_keys = ("tgt_img", "tgt_txt")

    # ------------------------------------------------------------------ utils

    def _ids(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.long, device=self.device)

    def encode(self, text: str) -> Tuple[torch.Tensor, torch.Tensor]:
        ids, mask = self.tokenizer.encode(text, self.cfg.attack.max_text_len)
        return self._ids(ids[None]), self._ids(mask[None])

    def _embed_text(self, ids: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.surrogate.embed_text(ids)

    def _targets_fn(self, ori_px, key, aux) -> Dict[str, torch.Tensor]:
        """Clean per-layer feature stacks of the original question
        (``Gen_ori_feats``, ``adv_attack.py:111-118``), masked with ``key``."""
        sur = self.surrogate
        masked_ids, _ = mlm_random_mask(
            key, aux["ori_ids"], vocab_size=sur.cfg.bert.vocab_size,
            mask_token_id=self._special[0], pad_token_id=self._special[1],
            cls_token_id=self._special[2], mlm_probability=sur.cfg.mlm_probability,
        )
        with torch.no_grad():
            img_f, txt_f, _ = sur.gen_feats(ori_px, masked_ids, aux["ori_mask"])
        if self.cfg.attack.tap_dtype == "bfloat16":
            img_f, txt_f = img_f.bfloat16(), txt_f.bfloat16()
        return {"tgt_img": img_f, "tgt_txt": txt_f}

    @torch.no_grad()
    def candidate_mlm_topk(self, ids: np.ndarray, mask: np.ndarray):
        """(scores [B,S,K], ids [B,S,K]) of the candidate MLM, with the top-k
        taken on the device."""
        logits = self.mlm_model(self._ids(ids), self._ids(mask), mode="text")[2]
        s, i = torch.topk(logits, self.cfg.attack.mlm_top_k, dim=-1)
        return s.float().cpu().numpy(), i.cpu().numpy()

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        padded, n = pad_to_bucket(texts)
        ids, _ = self.tokenizer.encode_batch(padded, self.cfg.attack.max_text_len)
        emb = self._embed_text(self._ids(ids))
        return emb[:n, : self.cfg.attack.max_text_len].float().cpu().numpy()

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
        """The full per-sample attack (``Adv_attack.evaluate`` body,
        ``adv_attack.py:415-715``).  ``key`` (an ``rng.py`` key) defaults to
        ``TorchKey(cfg.seed)`` on the pipeline's device."""
        atk = self.cfg.attack
        if key is None:
            key = TorchKey(self.cfg.seed, self.device)
        qid_fold = int(qid) if str(qid).isdigit() else zlib.crc32(str(qid).encode())
        r_tgt, r_pgd = key.fold_in(qid_fold % (2 ** 31)).split(2)

        ori_px = torch.as_tensor(np.asarray(pixels), dtype=torch.float32,
                                 device=self.device)
        ori_text = adv_text = question

        # MAR labels (old_alg==0 iff an answer word appears in the paraphrase)
        if paraphrase is not None and target_answer is not None:
            mar = build_mar_labels(paraphrase, target_answer, all_correct_answers,
                                   self.tokenizer, atk.max_text_len, atk.max_answers)
        else:
            mar = MarLabels(1, None, None, None, [], [], [], 0)
        old_alg = mar.old_alg

        ori_ids, ori_mask = self.encode(question)
        ori_emb = self._embed_text(ori_ids)[0].float().cpu().numpy()
        n_ori = int(ori_mask.sum())

        cands = generate_candidates(
            question, self.tokenizer, self.candidate_mlm_topk, self.filter_words,
            total_iters=atk.num_iters, top_k=atk.mlm_top_k,
            score_threshold=atk.mlm_score_threshold,
        )
        iter_list = cands.iter_list if cands.iter_list else [atk.num_iters]
        mar_words = list(mar.paraphrase_words)

        adv_px = ori_px
        tgt_img = tgt_txt = None
        feat_losses: List[np.ndarray] = []
        mlm_losses: List[np.ndarray] = []
        all_ops: List[Tuple[str, str]] = []
        vl_steps = 0
        kw = dict(eps=atk.eps, eps_iter=atk.step_size, clip_min=atk.clip_min,
                  clip_max=atk.clip_max, norm=atk.norm)

        for block_idx, block_iters in enumerate(iter_list):
            first_block = block_idx == 0
            ids, mask = self.encode(adv_text)
            # min-true-length cosine mask (fgm:121-126 ragged truncation)
            n = min(int(mask.sum()), n_ori)
            token_mask = (torch.arange(atk.max_text_len, device=self.device) < n)
            aux = {
                "text_ids": ids,
                "text_mask": mask,
                "txt_token_mask": token_mask.float()[None],
                "special_ids": self._special,
            }
            if first_block:
                aux["ori_ids"], aux["ori_mask"] = ori_ids, ori_mask
            else:
                aux["tgt_txt"], aux["tgt_img"] = tgt_txt, tgt_img
            r_pgd, r_block = r_pgd.split(2)
            r_pgd, r_vl = r_pgd.split(2)
            if block_iters > atk.num_iters:
                raise ValueError(f"block_iters={block_iters} exceeds num_iters={atk.num_iters}")
            is_last = block_idx == len(iter_list) - 1 or not cands.attack_word_indices
            positions = self._ids([cands.attack_positions or [0]])
            common = dict(
                x=adv_px, ori_x=ori_px, key=r_block, vl_key=r_vl, tgt_key=r_tgt,
                rand_init=first_block and atk.rand_init, do_vl=not is_last,
                positions=positions, aux=aux, target_keys=self._target_keys, **kw,
            )
            targets_fn = self._targets_fn if first_block else None
            if old_alg == 1:
                adv_px, losses, tg, tgts = pgd_feature_block(
                    self._feature_loss, self._vl_loss, self._embed_text, targets_fn,
                    nb_iter=block_iters, max_iter=atk.num_iters, **common)
                feat_losses.append(losses[:, 0].cpu().numpy())
            else:
                # label-alignment guard: if substitution changed the masked
                # paraphrase's token count, the labels no longer align and the
                # MLM step falls back to the feature loss (fgm:102-118)
                cur_ids, cur_mask = self.tokenizer.encode(" ".join(mar_words),
                                                          atk.max_text_len)
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
                tgt_img, tgt_txt = tgts
            if is_last:
                break
            vl_steps += 1

            # between blocks: word substitution from the harvested text grad
            adv_text, ops = select_substitutions(
                adv_text, ori_text, tg[0].cpu().numpy(), cands, ori_emb,
                self.embed_texts, self.gate.scores,
                sim_threshold=self.gate.operating_point(atk.sim_threshold),
                max_length=atk.max_text_len,
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
    def evaluate_victim(self, adv_image, adv_text: str, answer_ids: torch.Tensor,
                        answer_mask: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
        """The victim's ranked answers on the adversarial pair
        (``adv_attack.py:717-733``); ``k_test`` clamps to the answer count."""
        ids, mask = self.encode(adv_text)
        k = min(self.cfg.k_test, int(answer_ids.shape[0]))
        px = torch.as_tensor(np.asarray(adv_image), dtype=torch.float32, device=self.device)
        topk_ids, topk_probs = self.victim(px, ids, mask, answer_ids.to(self.device),
                                           answer_mask.to(self.device), k)
        return topk_ids.cpu().numpy(), topk_probs.cpu().numpy()


def save_artifacts(results: Sequence[AttackResult], out_dir: str,
                   txt_name: str = "adv_txt_dict.json") -> None:
    """Persist adversarial artifacts in the reference's layout
    (``adv_attack.py:713-715``): per qid a ``.pt`` NCHW tensor (what the
    reference's transfer scripts read) and a ``.npy`` NHWC array (the JAX
    package's layout), plus one adversarial-text JSON merged into any
    existing one."""
    os.makedirs(out_dir, exist_ok=True)
    txt: Dict[str, str] = {}
    for r in results:
        img = np.asarray(r.adv_image, np.float32)
        torch.save(torch.from_numpy(img.copy()), os.path.join(out_dir, f"{r.qid}.pt"))
        np.save(os.path.join(out_dir, f"{r.qid}.npy"), img.transpose(0, 2, 3, 1))
        txt[r.qid] = r.adv_text
    path = os.path.join(out_dir, txt_name)
    existing = {}
    if os.path.exists(path):
        with open(path) as f:
            existing = json.load(f)
    existing.update(txt)
    with open(path, "w") as f:
        f.write(json.dumps(existing))
