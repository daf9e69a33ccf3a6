"""Noun-phrase extraction from captions, the port's own copy of
``iuvl_tpu/data/nouns.py``: a rule-based chunker (determiner / adjective /
noun runs ending in a likely noun, closed-class stopwords and verb-like
suffixes as breaks) in the role of the reference's nltk noun phrases,
which need models that are not available offline.
"""

from __future__ import annotations

import re

_STOP = {
    "a", "an", "the", "of", "on", "in", "at", "by", "with", "and", "or",
    "to", "from", "is", "are", "was", "were", "be", "being", "been", "that",
    "this", "these", "those", "it", "its", "his", "her", "their", "my",
    "your", "our", "as", "for", "into", "onto", "over", "under", "near",
    "some", "two", "three", "four", "five", "several", "many", "few",
    "there", "here", "very", "while", "who", "which", "he", "she", "they",
    "we", "i", "you", "not", "no", "up", "down", "out", "off",
}
_VERBISH = re.compile(r".*(ing|ed)$")


def extract_noun_phrases(caption: str, max_phrases: int = 5) -> list[str]:
    words = re.findall(r"[a-z']+", caption.lower())
    phrases: list[str] = []
    current: list[str] = []
    for w in words:
        if w in _STOP or (_VERBISH.match(w) and len(w) > 5):
            if current:
                phrases.append(" ".join(current))
                current = []
        else:
            current.append(w)
    if current:
        phrases.append(" ".join(current))
    # dedupe, keep order, clip
    seen = set()
    out = []
    for p in phrases:
        if p not in seen and len(p) > 2:
            seen.add(p)
            out.append(p)
    return out[:max_phrases]


def noun_prompts(caption: str, max_phrases: int = 5) -> tuple[list[str], list[str]]:
    """Returns (phrases, prompted phrases) like the reference's
    (nouns, 'a photo of the {noun}.') pairing."""
    phrases = extract_noun_phrases(caption, max_phrases)
    return phrases, [f"a photo of the {p}." for p in phrases]
