"""Official VQA evaluation: annotation api, answer normalization, accuracy.

Port of ``vqattack_tpu/eval/vqa_eval.py`` (pure Python; a copy, since the
port imports nothing of the JAX package).  Reference:
``ALBEF_attack/vqaTools/``: :class:`VQA` is the official annotation api
(``vqa.py:24-160``: question/answer indices, ``getQuesIds``/``getImgIds``/
``loadQA``/``load_res``); the normalization pipeline is contraction
restoration, punctuation rules, number-word mapping and article removal;
accuracy is the leave-one-annotator-out soft score (``vqaEval.py:84-121``)
with per-question-type and per-answer-type breakdowns.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Union

# The official VQA-spec contraction table, vendored verbatim
# (``vqaTools/vqaEval.py:20-40``) — including its quirks: capitalized keys
# ("Im", "Id've", …) are unreachable after the lower() in
# process_digit_article, identity entries ("let's", "she's"), and the
# reversed "somebody'd" -> "somebodyd" mapping.  These are part of the
# evaluation specification, not style choices.
_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}
_NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
_ARTICLES = {"a", "an", "the"}
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
_PUNCT = ";/[]\"{}()=+\\_-><@`,?!"  # the official evaluator's char set


def process_punctuation(text: str) -> str:
    """Official rule: a punctuation char adjacent to a space (or any
    digit,comma,digit pattern present) is deleted; otherwise it becomes a
    space.  Periods not inside numbers are deleted."""
    out = text
    for p in _PUNCT:
        if (p + " " in text or " " + p in text) or re.search(_COMMA_STRIP, text):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = _PERIOD_STRIP.sub("", out)
    return out


def process_digit_article(text: str) -> str:
    out: List[str] = []
    for word in text.lower().split():
        word = _NUMBER_MAP.get(word, word)
        if word in _ARTICLES:
            continue
        out.append(_CONTRACTIONS.get(word, word))
    return " ".join(out)


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(ans))


def vqa_soft_accuracy(pred: str, gt_answers: Sequence[str]) -> float:
    """The official leave-one-annotator-out accuracy (``vqaEval.py:84-105``):
    for each of the n human answers, count the prediction's matches among
    the OTHER n-1 and take min(1, matches/3); average the n values.  This is
    NOT min(1, total_matches/3): with k total matches the official value is
    (k*min(1,(k-1)/3) + (n-k)*min(1,k/3)) / n — e.g. k=3 of 10 scores 0.9,
    not 1.0.

    Normalization follows the official quirk: the prediction gets the full
    punctuation + digit/article pipeline, ground truths only the punctuation
    pass, and only when the answer set is non-unanimous."""
    p = normalize_answer(pred)
    gts = list(gt_answers)
    if len(set(gts)) > 1:
        gts = [process_punctuation(a) for a in gts]
    n = len(gts)
    if n == 0:
        return 0.0
    k = sum(1 for g in gts if g == p)
    acc_when_match_left_out = min(1.0, (k - 1) / 3.0)
    acc_when_other_left_out = min(1.0, k / 3.0)
    return (k * acc_when_match_left_out + (n - k) * acc_when_other_left_out) / n


def _load_json(src: Union[str, dict, list, None]):
    if src is None or isinstance(src, (dict, list)):
        return src
    with open(src) as f:
        return json.load(f)


class VQA:
    """The official VQA annotation api (``vqaTools/vqa.py:24-160``).

    Accepts file paths or already-parsed dicts for the annotation json
    (``{"annotations": [...]}``) and question json (``{"questions": [...]}``).
    """

    def __init__(self, annotation_file=None, question_file=None):
        self.dataset = _load_json(annotation_file) or {}
        self.questions = _load_json(question_file) or {}
        self.qa: Dict[Any, dict] = {}
        self.qqa: Dict[Any, dict] = {}
        self.imgToQA: Dict[Any, List[dict]] = defaultdict(list)
        if self.dataset:
            self.create_index()

    def create_index(self) -> None:
        for ann in self.dataset.get("annotations", []):
            self.qa[ann["question_id"]] = ann
            self.imgToQA[ann["image_id"]].append(ann)
        for q in self.questions.get("questions", []):
            self.qqa[q["question_id"]] = q

    @staticmethod
    def _filter(anns: List[dict], ques_types, ans_types) -> List[dict]:
        if ques_types:
            anns = [a for a in anns if a.get("question_type") in set(ques_types)]
        if ans_types:
            anns = [a for a in anns if a.get("answer_type") in set(ans_types)]
        return anns

    def getQuesIds(self, imgIds=(), quesTypes=(), ansTypes=()) -> List[Any]:
        if imgIds:
            anns = [a for i in imgIds for a in self.imgToQA.get(i, [])]
        else:
            anns = list(self.dataset.get("annotations", []))
        return [a["question_id"] for a in self._filter(anns, quesTypes, ansTypes)]

    def getImgIds(self, quesIds=(), quesTypes=(), ansTypes=()) -> List[Any]:
        if quesIds:
            anns = [self.qa[q] for q in quesIds if q in self.qa]
        else:
            anns = list(self.dataset.get("annotations", []))
        return [a["image_id"] for a in self._filter(anns, quesTypes, ansTypes)]

    def loadQA(self, ids=()) -> List[dict]:
        if isinstance(ids, (int, str)):
            ids = [ids]
        return [self.qa[i] for i in ids]

    def load_res(self, res_file) -> "VQA":
        """Result-set VQA (``vqa.py:144-160``): one ``{"question_id",
        "answer"}`` record per question, with image id and type fields
        copied from this (ground-truth) instance."""
        res = VQA()
        res.questions = self.questions
        anns = _load_json(res_file)
        if isinstance(anns, dict):
            anns = anns.get("annotations", [])
        out = []
        for ann in anns:
            qid = ann["question_id"]
            gt = self.qa[qid]
            out.append({
                "question_id": qid,
                "answer": ann["answer"],
                "image_id": gt["image_id"],
                "question_type": gt.get("question_type"),
                "answer_type": gt.get("answer_type"),
            })
        res.dataset = {"annotations": out}
        res.create_index()
        return res

    # PEP8 twins of the official camelCase names
    loadRes = load_res


class VQAEval:
    """Accumulating evaluator (``vqaTools/vqaEval.py`` interface), with the
    official per-question-type / per-answer-type breakdown."""

    def __init__(self):
        self.accuracies: List[float] = []
        self.per_question: Dict[str, float] = {}
        self._by_ques_type: Dict[str, List[float]] = defaultdict(list)
        self._by_ans_type: Dict[str, List[float]] = defaultdict(list)

    def update(self, qid, pred: str, gt_answers: Sequence[str],
               ques_type: Optional[str] = None,
               ans_type: Optional[str] = None) -> float:
        acc = vqa_soft_accuracy(pred, gt_answers)
        self.accuracies.append(acc)
        self.per_question[str(qid)] = acc
        if ques_type is not None:
            self._by_ques_type[ques_type].append(acc)
        if ans_type is not None:
            self._by_ans_type[ans_type].append(acc)
        return acc

    def evaluate(self, vqa: VQA, vqa_res: VQA, ques_ids=None) -> Dict[str, Any]:
        """The official evaluation loop (``vqaEval.py:68-121``): score every result
        question against the ground-truth api and return the accuracy dict
        ``{"overall", "perQuestionType", "perAnswerType"}`` (percentages)."""
        if ques_ids is None:
            ques_ids = vqa_res.getQuesIds()
        for qid in ques_ids:
            gt = vqa.qa[qid]
            self.update(
                qid, vqa_res.qa[qid]["answer"],
                [a["answer"] for a in gt.get("answers", [])],
                ques_type=gt.get("question_type"),
                ans_type=gt.get("answer_type"),
            )
        return {
            "overall": self.accuracy,
            "perQuestionType": {
                k: 100.0 * sum(v) / len(v)
                for k, v in self._by_ques_type.items()
            },
            "perAnswerType": {
                k: 100.0 * sum(v) / len(v)
                for k, v in self._by_ans_type.items()
            },
        }

    @property
    def accuracy(self) -> float:
        return 100.0 * sum(self.accuracies) / max(1, len(self.accuracies))
