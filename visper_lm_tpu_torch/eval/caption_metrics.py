"""Native caption metrics: PTB-style tokenization, BLEU, ROUGE-L, CIDEr-D (a copy of
visper_lm_tpu/eval/caption_metrics.py, its imports pointed at the port).

The reference scores its caption tasks (coco_cap / flickr30k / nocaps /
textcaps) through pycocoevalcap (lmms-eval/lmms_eval/tasks/coco_cap/
utils.py:44-98): PTBTokenizer (a Stanford CoreNLP jar) normalizes both sides,
then Bleu/Rouge/Cider scorers aggregate over the whole result set. Neither
the jar nor the package is installable here, so this module implements the
same algorithms natively:

  * ``ptb_tokenize`` — PTB tokenization (clitic splitting, punctuation
    isolation, lowercasing) followed by pycocoevalcap's punctuation-token
    removal list. Exotic unicode or bracket-heavy input may tokenize
    differently from the jar; for caption-style English text the output is
    identical (fixtures pinned in tests/test_caption_metrics.py).
  * ``bleu_score`` — pycocoevalcap ``bleu_scorer.py`` semantics: corpus-level
    modified n-gram precision with per-image CLOSEST-reference effective
    length, tiny/small epsilon guards, and brevity penalty
    ``exp(1 - 1/ratio)`` applied to every order. Mathematically equal to
    NLTK ``corpus_bleu`` up to the epsilons — the test suite pins that.
  * ``rouge_l`` — pycocoevalcap ``rouge.py``: per-image max-over-references
    LCS F-measure with beta=1.2, mean over images.
  * ``cider_d`` — pycocoevalcap ``cider_scorer.py`` (the CIDEr-D variant the
    package ships as "CIDEr"): tf-idf weighted 1..4-gram cosine similarity
    with candidate-count clipping, gaussian length penalty (sigma=6), corpus
    document frequency from the reference set, log(N) ref-length norm, x10.

METEOR is NOT implemented: the reference runs the meteor-1.5 jar whose scores
depend on bundled synonym/paraphrase data files; reproducing it without those
files would silently disagree. docs/Evaluation.md records the disposition.

All scorers take ``gts``/``res`` dicts of image_id -> list[str] AFTER
tokenization, exactly like the pycocoevalcap compute_score API.
"""

from __future__ import annotations

import math
import re
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

# pycocoevalcap/tokenizer/ptbtokenizer.py PUNCTUATIONS (removed post-tokenize).
# The jar's -lowerCase output makes bracket escapes lowercase, so both cases
# are listed here.
_PUNCTUATIONS = frozenset({
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    "-lrb-", "-rrb-", "-lcb-", "-rcb-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
})

# clitics PTB splits off the preceding word ("don't" -> "do n't",
# "man's" -> "man 's")
_CLITIC_RE = re.compile(r"(\w)(n't|'s|'m|'re|'ve|'ll|'d)\b", re.IGNORECASE)

_TOKEN_RE = re.compile(
    r"\.\.\.|--|"
    r"n't\b|'(?:s|m|re|ve|ll|d)\b|"           # clitic tokens survive whole
    r"\d+(?:[.,]\d+)*|"                       # numbers keep , . separators
    r"[^\s.,;:!?\"'`()\[\]{}]+|"              # words (internal - and / kept)
    r"[.,;:!?\"'`()\[\]{}]",                  # isolated punctuation
    re.IGNORECASE,
)

_BRACKET_ESCAPES = {
    "(": "-lrb-", ")": "-rrb-", "{": "-lcb-", "}": "-rcb-",
    "[": "-lsb-", "]": "-rsb-",
}


def ptb_tokenize_caption(caption: str) -> str:
    """One caption -> space-joined PTB tokens with pycocoevalcap's punctuation
    tokens removed (PTBTokenizer.tokenize applied to a single string)."""
    s = caption.replace("\n", " ")
    s = _CLITIC_RE.sub(r"\1 \2", s)
    toks = []
    for t in _TOKEN_RE.findall(s):
        t = _BRACKET_ESCAPES.get(t, t).lower()
        if t == '"':
            continue  # the jar maps " to ``/'' — both removed
        if t in _PUNCTUATIONS:
            continue
        toks.append(t)
    return " ".join(toks)


def ptb_tokenize(captions: Dict[object, List[str]]) -> Dict[object, List[str]]:
    """pycocoevalcap PTBTokenizer.tokenize over an {id: [caption,...]} dict."""
    return {
        k: [ptb_tokenize_caption(c) for c in v] for k, v in captions.items()
    }


def _ngram_counts(words: Sequence[str], n: int) -> Dict[Tuple[str, ...], int]:
    counts: Dict[Tuple[str, ...], int] = defaultdict(int)
    for k in range(1, n + 1):
        for i in range(len(words) - k + 1):
            counts[tuple(words[i:i + k])] += 1
    return counts


# --------------------------------------------------------------------- BLEU


def bleu_score(
    gts: Dict[object, List[str]], res: Dict[object, List[str]], n: int = 4,
) -> Tuple[List[float], List[List[float]]]:
    """pycocoevalcap Bleu(4).compute_score (option='closest'): returns the
    corpus-level [Bleu_1..Bleu_n] plus per-image scores (the per-image list
    uses the same corpus semantics pycocoevalcap emits — per-image ratio)."""
    small, tiny = 1e-9, 1e-15
    total_guess = [0] * n
    total_correct = [0] * n
    total_testlen = 0
    total_reflen = 0
    per_image: List[List[float]] = [[] for _ in range(n)]

    comps = []
    for img_id in gts:
        hyp = res[img_id][0].split()
        refs = [r.split() for r in gts[img_id]]
        testlen = len(hyp)
        # closest effective reference length (ties -> shorter, min on tuple)
        reflen = min((abs(len(r) - testlen), len(r)) for r in refs)[1]
        # max reference count per n-gram, clip candidate counts
        maxcounts: Dict[Tuple[str, ...], int] = defaultdict(int)
        for r in refs:
            for ng, c in _ngram_counts(r, n).items():
                maxcounts[ng] = max(maxcounts[ng], c)
        guess = [max(0, testlen - k) for k in range(n)]
        correct = [0] * n
        for ng, c in _ngram_counts(hyp, n).items():
            correct[len(ng) - 1] += min(maxcounts.get(ng, 0), c)
        comps.append((testlen, reflen, guess, correct))
        total_testlen += testlen
        total_reflen += reflen
        for k in range(n):
            total_guess[k] += guess[k]
            total_correct[k] += correct[k]
        # per-image score with the same epsilon/BP recipe
        b = 1.0
        ratio = (testlen + tiny) / (reflen + small)
        for k in range(n):
            b *= (correct[k] + tiny) / (guess[k] + small)
            s = b ** (1.0 / (k + 1))
            if ratio < 1:
                s *= math.exp(1 - 1 / ratio)
            per_image[k].append(s)

    bleus = []
    b = 1.0
    ratio = (total_testlen + tiny) / (total_reflen + small)
    for k in range(n):
        b *= (total_correct[k] + tiny) / (total_guess[k] + small)
        s = b ** (1.0 / (k + 1))
        if ratio < 1:
            s *= math.exp(1 - 1 / ratio)
        bleus.append(s)
    return bleus, per_image


# ------------------------------------------------------------------ ROUGE-L


def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, start=1):
            cur.append(prev[j - 1] + 1 if x == y else max(cur[j - 1], prev[j]))
        prev = cur
    return prev[-1]


def rouge_l(
    gts: Dict[object, List[str]], res: Dict[object, List[str]],
    beta: float = 1.2,
) -> Tuple[float, List[float]]:
    """pycocoevalcap rouge.py: per image, max precision and max recall over
    references (independently), F_beta; corpus score is the mean."""
    scores = []
    for img_id in gts:
        hyp = res[img_id][0].split()
        prec, rec = [], []
        for ref in gts[img_id]:
            r = ref.split()
            lcs = _lcs_len(hyp, r)
            prec.append(lcs / len(hyp) if hyp else 0.0)
            rec.append(lcs / len(r) if r else 0.0)
        p, q = max(prec), max(rec)
        if p != 0 and q != 0:
            scores.append(((1 + beta ** 2) * p * q) / (q + beta ** 2 * p))
        else:
            scores.append(0.0)
    return (sum(scores) / len(scores) if scores else 0.0), scores


# ------------------------------------------------------------------ CIDEr-D


def cider_d(
    gts: Dict[object, List[str]], res: Dict[object, List[str]],
    n: int = 4, sigma: float = 6.0,
) -> Tuple[float, List[float]]:
    """pycocoevalcap cider_scorer.py: document frequency over the reference
    sets, tf-idf vectors per n-gram order, clipped cosine similarity with a
    gaussian length penalty, averaged over orders and references, x10."""
    img_ids = list(gts)
    # document frequency: number of IMAGES whose reference set contains the
    # n-gram (cider_scorer.compute_doc_freq)
    doc_freq: Dict[Tuple[str, ...], int] = defaultdict(int)
    ref_counts = {}
    for img_id in img_ids:
        counts = [_ngram_counts(r.split(), n) for r in gts[img_id]]
        ref_counts[img_id] = counts
        seen = set()
        for c in counts:
            seen.update(c.keys())
        for ng in seen:
            doc_freq[ng] += 1
    ref_len = math.log(float(len(img_ids)))

    def counts2vec(cnts):
        vec = [defaultdict(float) for _ in range(n)]
        norm = [0.0] * n
        length = 0
        for ng, tf in cnts.items():
            df = math.log(max(1.0, float(doc_freq[ng])))
            k = len(ng) - 1
            vec[k][ng] = float(tf) * (ref_len - df)
            norm[k] += vec[k][ng] ** 2
            if k == 1:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def sim(v_h, v_r, n_h, n_r, l_h, l_r):
        delta = float(l_h - l_r)
        val = [0.0] * n
        for k in range(n):
            for ng, w in v_h[k].items():
                # CIDEr-D count clipping: min(hyp, ref) * ref
                val[k] += min(w, v_r[k][ng]) * v_r[k][ng]
            if n_h[k] != 0 and n_r[k] != 0:
                val[k] /= n_h[k] * n_r[k]
            val[k] *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
        return val

    scores = []
    for img_id in img_ids:
        vec, norm, length = counts2vec(_ngram_counts(res[img_id][0].split(), n))
        acc = [0.0] * n
        for cnts in ref_counts[img_id]:
            v_r, n_r, l_r = counts2vec(cnts)
            for k, v in enumerate(sim(vec, v_r, norm, n_r, length, l_r)):
                acc[k] += v
        score = sum(acc) / n / len(ref_counts[img_id]) * 10.0
        scores.append(score)
    return (sum(scores) / len(scores) if scores else 0.0), scores


# -------------------------------------------------------- metric dispatch


def compute_caption_metric(
    metric: str,
    gts: Dict[object, List[str]], res: Dict[object, List[str]],
) -> float:
    """One pycocoevalcap-named metric over RAW (untokenized) caption dicts —
    the COCOEvalCap flow: PTB-tokenize both sides, run the scorer, pick the
    order for Bleu_k. Mirrors coco_aggregation_result (coco_cap/utils.py)."""
    tg, tr = ptb_tokenize(gts), ptb_tokenize(res)
    if metric.startswith("Bleu_"):
        k = int(metric.split("_")[-1])
        return bleu_score(tg, tr, n=4)[0][k - 1]
    if metric == "ROUGE_L":
        return rouge_l(tg, tr)[0]
    if metric == "CIDEr":
        return cider_d(tg, tr)[0]
    raise ValueError(f"unsupported caption metric: {metric}")
