"""The attack's precomputed side tables, byte-compatible with the reference.

Five table families (``adv_attack.py:53-80``; ``vlmo_module.py:140-165``):

- ``right_part{,_after}.txt``      — newline-separated qids the surrogate
                                     answers correctly (the attack subset);
- ``{albef,vlmo}_ans_table*.txt``  — JSON {qid: surrogate answer};
- ``vilt_ans_table_for_chatgpt*``  — JSON {qid: target-model answer};
- ``chatgpt_all_5k*.txt``          — JSON {qid: [answer, paraphrase, ...]};
- ``all_correct_ans*.txt``         — JSON {qid: [acceptable answers]}.

Multiple files per family merge in order (the reference loads the base file
then ``update()``s the ``_after`` variant).  A copy of
``vqattack_tpu/data/side_tables.py``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
from typing import Dict, List, Optional, Sequence


def _load_json_merged(paths: Sequence[str]) -> Dict[str, object]:
    out: Dict[str, object] = {}
    for p in paths:
        with open(p) as f:
            out.update(json.load(f))
    return out


def _load_id_list(paths: Sequence[str]) -> List[int]:
    ids: List[int] = []
    for p in paths:
        with open(p) as f:
            ids.extend(int(line.strip()) for line in f if line.strip())
    return ids


@dataclasses.dataclass
class SideTables:
    correct_qids: List[int]
    surrogate_answers: Dict[str, str]
    target_answers: Dict[str, str]
    paraphrases: Dict[str, List[str]]
    all_correct_answers: Dict[str, List[str]]

    @classmethod
    def load(
        cls,
        right_part: Sequence[str],
        surrogate_ans_table: Sequence[str],
        target_ans_table: Sequence[str],
        chatgpt_paraphrases: Sequence[str],
        all_correct_ans: Sequence[str],
    ) -> "SideTables":
        return cls(
            correct_qids=_load_id_list(right_part),
            surrogate_answers=_load_json_merged(surrogate_ans_table),
            target_answers=_load_json_merged(target_ans_table),
            paraphrases=_load_json_merged(chatgpt_paraphrases),
            all_correct_answers=_load_json_merged(all_correct_ans),
        )

    def alignment_ok(self, qid, answers: Sequence[str], weights: Sequence[float]) -> bool:
        """The reference's per-sample guards (``adv_attack.py:419-427``): the
        stored surrogate answer must be among the ground-truth answers AND
        carry the max frequency weight."""
        pred = self.surrogate_answers.get(str(qid))
        if pred is None or pred not in answers:
            return False
        return weights[list(answers).index(pred)] == max(weights)

    @functools.cached_property
    def _correct_qid_set(self) -> frozenset:
        return frozenset(self.correct_qids)

    def attack_inputs(self, qid) -> Optional[dict]:
        """(paraphrase, target answer, acceptable answers) for one qid."""
        key = str(int(qid))
        if int(qid) not in self._correct_qid_set:
            return None
        para = self.paraphrases.get(key)
        return {
            "paraphrase": para[1] if para and len(para) > 1 else None,
            "target_answer": self.target_answers.get(key),
            "all_correct_answers": self.all_correct_answers.get(key, []),
            "surrogate_answer": self.surrogate_answers.get(key),
        }
