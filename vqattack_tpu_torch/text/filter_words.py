"""Word filter for the substitution attack.

Words on the filter list are never substitution targets.  The reference
builds its inventory as a hand-curated filler list
(``ALBEF_VQAttack/ALBEF_attack/filter_words.py:1``, 270 words) merged with
NLTK English stopwords plus ``['?', '.']`` (``adv_attack.py:27``).  Both
pieces are **data constants vendored verbatim** here so the substitutable-word
sets — and therefore the block schedules and every attack trajectory — match
the reference exactly (the NLTK corpus download needs network; its English
stopword inventory is fixed public data and is vendored below).

``default_filter_words()`` reproduces the reference inventory.  A copy of
``vqattack_tpu/text/filter_words.py`` (the port imports nothing of the JAX
package); the JAX side's opt-in ``extended_filter_words`` is not carried.
"""

from __future__ import annotations

from typing import FrozenSet, Iterable, Optional

# the reference's curated list, verbatim (filter_words.py:1; 270 words)
REFERENCE_FILTER_WORDS = (
    'hasn', 'except', 'most', 'amongst', 'anyway', 'can', 'sometime', 'what',
    "wouldn't", "hadn't", 't', 'something', 'beforehand', 'empty', 'moreover',
    'nowhere', 'whom', 'almost', 'would', 'cannot', 'here', 'ever', 'yourself',
    'onto', 'hereby', 'why', 'a', 'whereupon', 'none', 'd', 'during', 'been',
    'mostly', "aren't", 'thereafter', 'never', 'others', 'any', 'than',
    'therein', 'under', 'once', 'theirs', 'yourselves', 'even', 'there',
    'next', 'below', 'am', 'formerly', 'our', 'it', "haven't", 'itself',
    'along', 'no', 'to', "you're", 'are', 'just', 'them', 'needn', 'against',
    'hundred', 'toward', "that'll", 'about', 'wouldn', 'that', 'we', 'until',
    'afterwards', 'up', 'latterly', "shouldn't", "you'd", 'an', 'is', 'off',
    'anywhere', 'of', 'shan', 'this', 'those', 'whither', 'indeed',
    'nevertheless', 'whoever', 'himself', "shan't", 'nothing', 'too',
    'wherein', 'whence', 'shouldn', 'him', 'when', 'being', 'thereupon',
    'mustn', 'where', 'anyone', 'another', 'above', 'be', 'but', "hasn't",
    'therefore', 'herself', 'these', "wasn't", 'whether', 'whole', 'first',
    'already', "doesn't", 'my', 'your', 'latter', 'myself', 'without', 've',
    'between', 'somewhere', 'his', 'll', "needn't", "should've", 'although',
    'hadn', 'i', 'themselves', 'they', 'whereas', 'into', "she's", 'and',
    'their', 'doesn', 'everyone', 'aren', "isn't", 'again', 'noone',
    'otherwise', 'over', 'were', 'then', 'how', 'hereupon', "it's", 'may',
    "mightn't", 'same', 'more', 'thru', 'other', 'thence', 'enough',
    'whenever', 'meanwhile', 'which', "mustn't", 'yet', "you'll", 'used',
    'thereby', 'anything', 'don', 'else', 'through', 'by', 'wasn', 'within',
    'won', 'now', 'ain', 'whereby', 'on', 'before', 'across', 'hereafter',
    'however', 'for', 'the', 'thus', 'with', 'y', 'you', 'also', 'unless',
    'haven', 'whose', 'ours', 'could', 'as', 'besides', 'both', "you've",
    'beside', 'herein', 'whereafter', 'if', 'or', 's', 'isn', 'alone',
    'wherever', 'he', 'namely', 'o', 'least', 'she', 'in', 'weren', 'its',
    'per', 'please', 'mightn', 'one', 'everything', 'nobody', "couldn't",
    'was', 'who', 'such', 'whatever', 'elsewhere', 'beyond', 'couldn', 'back',
    'hers', 'somehow', 'only', 'out', 'towards', 'not', 'hence', 'have', 'me',
    'from', 'mine', 'didn', "don't", 'among', "won't", 'at', 'all', "didn't",
    'her', 'neither', 'yours', 'after', 'down', 'throughout', 'due', 'around',
    'former', 'nor', 'while', 'must', "weren't", 'ourselves', 'upon', 'either',
    'everywhere', 'anyhow', 'behind', 'left', 'right',
)

# NLTK English stopwords (corpora/stopwords/english, 179 words) — appended by
# the reference at adv_attack.py:27
NLTK_STOPWORDS_EN = (
    'i', 'me', 'my', 'myself', 'we', 'our', 'ours', 'ourselves', 'you',
    "you're", "you've", "you'll", "you'd", 'your', 'yours', 'yourself',
    'yourselves', 'he', 'him', 'his', 'himself', 'she', "she's", 'her', 'hers',
    'herself', 'it', "it's", 'its', 'itself', 'they', 'them', 'their',
    'theirs', 'themselves', 'what', 'which', 'who', 'whom', 'this', 'that',
    "that'll", 'these', 'those', 'am', 'is', 'are', 'was', 'were', 'be',
    'been', 'being', 'have', 'has', 'had', 'having', 'do', 'does', 'did',
    'doing', 'a', 'an', 'the', 'and', 'but', 'if', 'or', 'because', 'as',
    'until', 'while', 'of', 'at', 'by', 'for', 'with', 'about', 'against',
    'between', 'into', 'through', 'during', 'before', 'after', 'above',
    'below', 'to', 'from', 'up', 'down', 'in', 'out', 'on', 'off', 'over',
    'under', 'again', 'further', 'then', 'once', 'here', 'there', 'when',
    'where', 'why', 'how', 'all', 'any', 'both', 'each', 'few', 'more', 'most',
    'other', 'some', 'such', 'no', 'nor', 'not', 'only', 'own', 'same', 'so',
    'than', 'too', 'very', 's', 't', 'can', 'will', 'just', 'don', "don't",
    'should', "should've", 'now', 'd', 'll', 'm', 'o', 're', 've', 'y', 'ain',
    'aren', "aren't", 'couldn', "couldn't", 'didn', "didn't", 'doesn',
    "doesn't", 'hadn', "hadn't", 'hasn', "hasn't", 'haven', "haven't", 'isn',
    "isn't", 'ma', 'mightn', "mightn't", 'mustn', "mustn't", 'needn',
    "needn't", 'shan', "shan't", 'shouldn', "shouldn't", 'wasn', "wasn't",
    'weren', "weren't", 'won', "won't", 'wouldn', "wouldn't",
)

# punctuation appended by the reference (adv_attack.py:27: + ['?', '.'])
REFERENCE_PUNCT = ("?", ".")

def default_filter_words(extra: Optional[Iterable[str]] = None) -> FrozenSet[str]:
    """The reference's exact inventory: curated list + NLTK English stopwords
    + ``['?', '.']`` (``adv_attack.py:27``)."""
    words = set(REFERENCE_FILTER_WORDS) | set(NLTK_STOPWORDS_EN) | set(REFERENCE_PUNCT)
    if extra:
        words |= set(extra)
    return frozenset(words)


# the answer-word filter applied before paraphrase masking
# (``adv_attack.py:155-160`` strips these from answer word lists)
ANSWER_STOPWORDS = ("on", "and", "in", "his", "her", "its")


def filter_answer_words(words: Iterable[str]) -> list:
    return [w for w in words if w not in ANSWER_STOPWORDS]
