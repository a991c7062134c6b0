"""Self-contained WordPiece tokenizer (BERT-uncased semantics).

The reference leans on HF ``BertTokenizer`` (vendored fork at
``ALBEF_attack/models/tokenization_bert.py`` + hub-downloaded
``bert-base-uncased`` vocab).  This implementation is dependency-free and
hub-free: point it at any ``vocab.txt`` (one token per line — the standard
BERT format); behavior matches HF for the ASCII question/answer text the
attack operates on (lowercase, accent strip, punctuation split, greedy
longest-match WordPiece with ``##`` continuations).

A copy of ``vqattack_tpu/text/tokenizer.py``: the port imports nothing of
the JAX package.

Special-token ids are resolved from the vocab, so both real bert-base-uncased
vocabs ([PAD]=0, [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103) and toy test
vocabs work.
"""

from __future__ import annotations

import re
import unicodedata
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"
SPECIAL_TOKENS = (PAD, UNK, CLS, SEP, MASK)

# split-on-special-tokens pattern (HF added-token-trie semantics: exact,
# case-sensitive match; the capture group keeps the token in the parts)
_SPECIAL_SPLIT = re.compile("(" + "|".join(re.escape(t) for t in SPECIAL_TOKENS) + ")")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """Clean + whitespace-split + punctuation-split (+ lowercase/strip accents)."""
    out_chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        out_chars.append(" " if ch.isspace() else ch)
    text = "".join(out_chars)

    tokens: List[str] = []
    for tok in text.split():
        if lowercase:
            tok = tok.lower()
            tok = "".join(
                c for c in unicodedata.normalize("NFD", tok)
                if unicodedata.category(c) != "Mn"
            )
        # split punctuation into standalone tokens
        cur: List[str] = []
        for ch in tok:
            if _is_punctuation(ch):
                if cur:
                    tokens.append("".join(cur))
                    cur = []
                tokens.append(ch)
            else:
                cur.append(ch)
        if cur:
            tokens.append("".join(cur))
    return tokens


class WordPieceTokenizer:
    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 max_chars_per_word: int = 100):
        self.vocab = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.lowercase = lowercase
        self.max_chars_per_word = max_chars_per_word
        self.pad_token_id = self.vocab.get(PAD, 0)
        self.unk_token_id = self.vocab.get(UNK, 1)
        self.cls_token_id = self.vocab.get(CLS, 2)
        self.sep_token_id = self.vocab.get(SEP, 3)
        self.mask_token_id = self.vocab.get(MASK, 4)

    # -- construction -------------------------------------------------------

    @classmethod
    def from_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    @classmethod
    def toy(cls, words: Iterable[str], with_pieces: bool = True) -> "WordPieceTokenizer":
        """Small vocab for tests: specials + whole words (+ char pieces)."""
        vocab = {t: i for i, t in enumerate(SPECIAL_TOKENS)}
        for w in words:
            if w not in vocab:
                vocab[w] = len(vocab)
        if with_pieces:
            for c in "abcdefghijklmnopqrstuvwxyz0123456789":
                for piece in (c, f"##{c}"):
                    if piece not in vocab:
                        vocab[piece] = len(vocab)
        return cls(vocab)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # -- tokenization -------------------------------------------------------

    def wordpiece(self, word: str) -> List[str]:
        """Greedy longest-match-first sub-tokenization."""
        if len(word) > self.max_chars_per_word:
            return [UNK]
        pieces: List[str] = []
        start = 0
        while start < len(word):
            end = len(word)
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [UNK]
            pieces.append(cur)
            start = end
        return pieces

    def _word_to_pieces(self, raw_word: str) -> List[str]:
        """Sub-tokenize one whitespace word, honoring special tokens
        (``[MASK]`` in masked paraphrases must stay atomic).

        Special tokens EMBEDDED in a word are split out exactly like HF's
        added-token trie: the reference's ALBEF answer list is built as
        ``answer + '[SEP]'`` with no space, which HF resolves to
        ``[..., '[SEP]']`` — naive wordpiece would shred it into
        ``'[', 'sep', ']'`` junk and corrupt every answer encoding."""
        if raw_word.upper() in SPECIAL_TOKENS:
            return [raw_word.upper()]
        out: List[str] = []
        parts = _SPECIAL_SPLIT.split(raw_word)
        for part in parts:
            if not part:
                continue
            if part in SPECIAL_TOKENS:
                out.append(part)
                continue
            for word in basic_tokenize(part, self.lowercase):
                out.extend(self.wordpiece(word))
        return out

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for raw_word in text.split():
            out.extend(self._word_to_pieces(raw_word))
        return out

    def convert_tokens_to_ids(self, tokens: Sequence[str]) -> List[int]:
        return [self.vocab.get(t, self.unk_token_id) for t in tokens]

    def convert_ids_to_tokens(self, ids: Sequence[int]) -> List[str]:
        return [self.inv_vocab.get(int(i), UNK) for i in ids]

    def convert_tokens_to_string(self, tokens: Sequence[str]) -> str:
        """Join, merging ``##`` continuations (HF semantics)."""
        text = " ".join(tokens).replace(" ##", "")
        return text.strip()

    # -- encoding -----------------------------------------------------------

    def encode(
        self,
        text: str,
        max_length: int = 25,
        pad_to_max: bool = True,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """[CLS] tokens [SEP], truncated to ``max_length`` total, padded.

        Returns ``(ids, attention_mask)`` int32 arrays of length
        ``max_length`` (or the true length if ``pad_to_max=False``) —
        mirroring the reference's
        ``tokenizer(..., padding='longest', truncation=True, max_length=25)``
        per-sample calls (``adv_attack.py:113``), made static-shape.
        """
        toks = self.tokenize(text)[: max_length - 2]
        ids = [self.cls_token_id] + self.convert_tokens_to_ids(toks) + [self.sep_token_id]
        n = len(ids)
        if pad_to_max:
            ids = ids + [self.pad_token_id] * (max_length - n)
        ids = np.asarray(ids, np.int32)
        mask = (np.arange(len(ids)) < n).astype(np.int32)
        return ids, mask

    def encode_batch(
        self, texts: Sequence[str], max_length: int = 25
    ) -> Tuple[np.ndarray, np.ndarray]:
        pairs = [self.encode(t, max_length) for t in texts]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    def decode(self, ids: Sequence[int], skip_special: bool = True) -> str:
        toks = self.convert_ids_to_tokens(ids)
        if skip_special:
            toks = [t for t in toks if t not in SPECIAL_TOKENS]
        return self.convert_tokens_to_string(toks)

    def word_spans(self, text: str) -> Tuple[List[str], List[str], List[Tuple[int, int]]]:
        """(words, sub_words, spans): per whitespace-word sub-token [start, end)
        ranges into the un-specialed sub-token list — the reference's
        ``_tokenize`` (``adv_attack.py:141-154``) used by the substitution
        machinery to map words to sub-token positions."""
        words = text.replace("\n", "").lower().split(" ") if self.lowercase else text.split(" ")
        words = [w for w in words if w != ""]
        sub_words: List[str] = []
        spans: List[Tuple[int, int]] = []
        idx = 0
        for w in words:
            subs = self._word_to_pieces(w)
            sub_words.extend(subs)
            spans.append((idx, idx + len(subs)))
            idx += len(subs)
        return words, sub_words, spans
