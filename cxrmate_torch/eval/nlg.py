"""BLEU, ROUGE-L, CIDEr: pure-Python ports of the pycocoevalcap scorers the
reference evaluates with (its ``tools/metrics/coco.py:2-7``).

The port's own copy of ``cxrmate_tpu/eval/nlg.py``, score for score. BLEU
follows BleuScorer exactly (option 'closest', tiny/small fudge factors,
per-item and corpus scores); ROUGE-L is the LCS F-measure with beta=1.2;
CIDEr is the tf-idf n-gram cosine with the sigma=6 length gaussian and x10
scaling. METEOR lives in ``eval/meteor.py`` (staged exact -> stem -> synonym
alignment), SPICE in ``eval/spice.py`` (adapter)."""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


# ------------------------------------------------------------------------- BLEU
def _bleu_stats(hyp: List[str], refs: List[List[str]], n: int = 4):
    """(testlen, reflen_closest, guess[n], correct[n])"""
    testlen = len(hyp)
    reflens = [len(r) for r in refs]
    # option 'closest': ref length closest to testlen (ties → shorter)
    reflen = min(reflens, key=lambda rl: (abs(rl - testlen), rl))
    guess, correct = [], []
    for k in range(1, n + 1):
        hgrams = _ngrams(hyp, k)
        maxref: Counter = Counter()
        for r in refs:
            rgrams = _ngrams(r, k)
            for g, c in rgrams.items():
                maxref[g] = max(maxref[g], c)
        guess.append(max(0, testlen - k + 1))
        correct.append(sum(min(c, maxref[g]) for g, c in hgrams.items()))
    return testlen, reflen, guess, correct


def _bleu_from_stats(testlen, reflen, guess, correct, n=4):
    small, tiny = 1e-9, 1e-15
    bleus = []
    b = 1.0
    for k in range(n):
        b *= (correct[k] + tiny) / (guess[k] + small)
        bleus.append(b ** (1.0 / (k + 1)))
    ratio = (testlen + tiny) / (reflen + small)
    if ratio < 1:
        bp = math.exp(1 - 1 / ratio)
        bleus = [s * bp for s in bleus]
    return bleus


def bleu(
    gts: Dict, res: Dict, n: int = 4
) -> Tuple[List[float], List[List[float]]]:
    """pycocoevalcap-style: (corpus [b1..b4], per-item [[b1...],[b2...],...]).

    gts/res: {id: [tokenised string, ...]} / {id: [tokenised string]}"""
    total = [0, 0, [0] * n, [0] * n]
    per_item: List[List[float]] = [[] for _ in range(n)]
    for key in gts:
        hyp = res[key][0].split()
        refs = [r.split() for r in gts[key]]
        testlen, reflen, guess, correct = _bleu_stats(hyp, refs, n)
        total[0] += testlen
        total[1] += reflen
        for k in range(n):
            total[2][k] += guess[k]
            total[3][k] += correct[k]
        item = _bleu_from_stats(testlen, reflen, guess, correct, n)
        for k in range(n):
            per_item[k].append(item[k])
    corpus = _bleu_from_stats(total[0], total[1], total[2], total[3], n)
    return corpus, per_item


# ----------------------------------------------------------------------- ROUGE-L
def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    dp = [0] * (len(b) + 1)
    for x in a:
        prev = 0
        for j, y in enumerate(b, 1):
            cur = dp[j]
            dp[j] = prev + 1 if x == y else max(dp[j], dp[j - 1])
            prev = cur
    return dp[-1]


def rouge_l(gts: Dict, res: Dict, beta: float = 1.2) -> Tuple[float, List[float]]:
    scores = []
    for key in gts:
        hyp = res[key][0].split()
        prec, rec = [], []
        for ref_s in gts[key]:
            ref = ref_s.split()
            lcs = _lcs_len(hyp, ref)
            prec.append(lcs / len(hyp) if hyp else 0.0)
            rec.append(lcs / len(ref) if ref else 0.0)
        p, r = max(prec), max(rec)
        if p != 0 and r != 0:
            scores.append(((1 + beta**2) * p * r) / (r + beta**2 * p))
        else:
            scores.append(0.0)
    return float(sum(scores) / max(len(scores), 1)), scores


# ------------------------------------------------------------------------- CIDEr
def cider(gts: Dict, res: Dict, n: int = 4, sigma: float = 6.0) -> Tuple[float, List[float]]:
    """CIDEr-D as in pycocoevalcap (tf·idf cosine per n, length gaussian, ×10)."""
    crefs, ctest, keys = [], [], []
    for key in gts:
        crefs.append([_all_ngrams(r.split(), n) for r in gts[key]])
        ctest.append(_all_ngrams(res[key][0].split(), n))
        keys.append(key)

    # document frequency over reference *sets*
    doc_freq: Counter = Counter()
    for refs in crefs:
        for ng in set(g for ref in refs for g in ref):
            doc_freq[ng] += 1
    log_n = math.log(float(len(crefs)))

    def counts2vec(cnts):
        vec = [defaultdict(float) for _ in range(n)]
        norm = [0.0] * n
        length = 0
        for ng, tf in cnts.items():
            df = math.log(max(1.0, doc_freq[ng]))
            k = len(ng) - 1
            vec[k][ng] = tf * (log_n - df)
            norm[k] += vec[k][ng] ** 2
            if k == 0:
                length += tf
        return vec, [math.sqrt(x) for x in norm], length

    def sim(vh, nh, lh, vr, nr, lr):
        delta = float(lh - lr)
        val = [0.0] * n
        for k in range(n):
            for ng, w in vh[k].items():
                val[k] += min(w, vr[k][ng]) * vr[k][ng]
            if nh[k] != 0 and nr[k] != 0:
                val[k] /= nh[k] * nr[k]
            val[k] *= math.exp(-(delta**2) / (2 * sigma**2))
        return val

    scores = []
    for refs, test in zip(crefs, ctest):
        vh, nh, lh = counts2vec(test)
        score = [0.0] * n
        for ref in refs:
            vr, nr, lr = counts2vec(ref)
            s = sim(vh, nh, lh, vr, nr, lr)
            for k in range(n):
                score[k] += s[k]
        score_avg = sum(score) / n / len(refs) * 10.0
        scores.append(score_avg)
    return float(sum(scores) / max(len(scores), 1)), scores


def _all_ngrams(tokens: List[str], n: int) -> Counter:
    out: Counter = Counter()
    for k in range(1, n + 1):
        out.update(tuple(tokens[i : i + k]) for i in range(len(tokens) - k + 1))
    return out


