"""VQA accuracy evaluator (the official VQAv2 protocol), the port's own
copy of ``iuvl_tpu/evaluation/vqa.py``: answer normalisation (punctuation,
articles, number words, contractions) and the accuracy
``min(#matching humans / 3, 1)``, averaged over the leave-one-out subsets
when there are 10 or more answers (pure Python and numpy).
"""

from __future__ import annotations

import re

import numpy as np

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "didnt": "didn't", "doesnt": "doesn't",
    "dont": "don't", "hadnt": "hadn't", "hasnt": "hasn't", "havent": "haven't",
    "hed": "he'd", "hes": "he's", "howd": "how'd", "howll": "how'll",
    "hows": "how's", "im": "i'm", "ive": "i've", "isnt": "isn't",
    "itd": "it'd", "itll": "it'll", "lets": "let's", "mightve": "might've",
    "mustve": "must've", "shant": "shan't", "shed": "she'd", "shes": "she's",
    "shouldve": "should've", "shouldnt": "shouldn't", "thats": "that's",
    "theres": "there's", "theyd": "they'd", "theyll": "they'll",
    "theyre": "they're", "theyve": "they've", "wasnt": "wasn't",
    "wed": "we'd", "weve": "we've", "werent": "weren't", "whatll": "what'll",
    "whats": "what's", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whod": "who'd", "wholl": "who'll", "whos": "who's",
    "whove": "who've", "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "yall": "y'all", "youd": "you'd", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}
_NUMBER_WORDS = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
_ARTICLES = {"a", "an", "the"}
_PUNCT_CHARS = list(";/[]\"{}()=+\\_-><@`,?!")
_PERIOD = re.compile(r"(?<!\d)\.(?!\d)")


def normalize_answer(ans: str) -> str:
    """Reference vqaEval.py processPunctuation + processDigitArticle."""
    ans = ans.replace("\n", " ").replace("\t", " ").strip().lower()
    # Official rule (vqaEval.py:132-136): a punctuation char adjacent to a
    # space (or any comma in the string) is deleted; otherwise it is
    # REPLACED BY A SPACE so 'black/white' token-matches 'black white'.
    out = ans
    for p in _PUNCT_CHARS:
        if (p + " " in ans) or (" " + p in ans) or ("," in ans):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    ans = out
    ans = _PERIOD.sub("", ans)
    words = []
    for w in ans.split():
        w = _NUMBER_WORDS.get(w, w)
        if w in _ARTICLES:
            continue
        w = _CONTRACTIONS.get(w, w)
        words.append(w)
    return " ".join(words)


class VQAEvaluator:
    def __init__(self):
        self.reset()

    def reset(self):
        self.scores: list[float] = []

    def process(self, prediction: str, gt_answers: list[str]):
        pred = normalize_answer(prediction)
        gts = [normalize_answer(a) for a in gt_answers]
        if len(gts) >= 10:
            # official rule: average over leave-one-out subsets
            accs = []
            for i in range(len(gts)):
                others = gts[:i] + gts[i + 1 :]
                accs.append(min(sum(a == pred for a in others) / 3.0, 1.0))
            self.scores.append(float(np.mean(accs)))
        else:
            self.scores.append(min(sum(a == pred for a in gts) / 3.0, 1.0))

    def merge(self, other):
        self.scores.extend(other.scores)

    def evaluate(self) -> dict[str, float]:
        if not self.scores:
            return {}
        return {"vqa_accuracy": 100.0 * float(np.mean(self.scores))}
