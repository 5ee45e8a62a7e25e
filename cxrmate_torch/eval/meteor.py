"""METEOR: staged-module alignment scoring, in place of the Java METEOR-1.5
jar the reference shells out to (pycocoevalcap, invoked from the reference's
``tools/metrics/coco.py:2-7,59``; jar: ``java -jar meteor-1.5.jar - - -stdio
-l en -norm``).

The port's own copy of ``cxrmate_tpu/eval/meteor.py``, score for score.
Faithful to METEOR 1.5 (Denkowski & Lavie 2014) for English:
  * matcher modules in stage order: **exact** -> **stem** (Snowball English,
    ``eval/stem.py``) -> **synonym** (on by default in the battery, like the
    jar's English module stack: ``default_synonyms()`` uses the nltk WordNet
    corpus when it loads, else the vendored curated table
    ``eval/data/synonyms_en.txt`` via ``load_synonym_table``) ->
    **paraphrase** (optional; phrase-to-phrase span matches from the jar's
    paraphrase table: pass ``paraphrases=load_paraphrase_table(path)``; the
    table ships with the jar and is not redistributable, so the stage is
    file-gated like the SPICE adapter, CXRMATE_METEOR_PARAPHRASES).
    Module weights 1.0 / 0.6 / 0.8 / 0.6.
  * English parameters: alpha=0.85, beta=0.2, gamma=0.6, delta=0.75.
  * content/function-word weighting: function words (a built-in list
    approximating the jar's corpus-derived function.words file; load the
    jar's file verbatim via ``load_function_words`` /
    CXRMATE_METEOR_FUNCTION_WORDS) weigh (1 - delta), content words delta.
  * alignment: one-to-one word alignment chosen by beam search maximising
    total matches, then minimising chunks, then minimising total match
    distance: the jar's Aligner resolution order.
  * corpus score from summed sufficient statistics (the jar's aggregate
    EVAL), per-segment scores from each segment's own statistics.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from cxrmate_torch.eval.stem import stem

ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
WEIGHT_EXACT, WEIGHT_STEM, WEIGHT_SYN, WEIGHT_PARA = 1.0, 0.6, 0.8, 0.6
_BEAM = 40


class ParaphraseTable:
    """Phrase → {paraphrase phrases} lookup (symmetric), the jar's paraphrase
    module data. Phrases are space-joined lowercase token sequences."""

    _EMPTY: frozenset = frozenset()

    def __init__(self, pairs):
        # values stay plain sets (never mutated after construction) — a
        # frozenset rebuild would transiently double peak memory for the
        # multi-million-pair paraphrase-en.gz case
        table: Dict[str, set] = {}
        for a, b in pairs:
            a, b = a.strip().lower(), b.strip().lower()
            if not a or not b or a == b:
                continue
            table.setdefault(a, set()).add(b)
            table.setdefault(b, set()).add(a)
        self._table = table
        self.max_len = max((len(k.split()) for k in self._table), default=0)

    def get(self, phrase: str):
        return self._table.get(phrase, self._EMPTY)

    def __len__(self) -> int:
        return len(self._table)


def load_paraphrase_table(path: str) -> ParaphraseTable:
    """Load a METEOR paraphrase table (the jar's ``data/paraphrase-en.gz``).
    Accepts gzip (detected by magic bytes, not suffix) or plain text; each line
    is ``phrase ||| paraphrase`` with an optional probability field on either
    end (``p ||| phrase ||| paraphrase`` or ``phrase ||| paraphrase ||| p``) —
    probabilities are ignored, the jar treats listed pairs as matched at the
    module weight. Fails loudly (ValueError) when the file yields no pairs or
    a substantial fraction of lines are unparseable, rather than silently
    running the metric with a corrupt or empty table (same loud-failure
    contract as the file-gated SPICE adapter)."""
    import gzip

    def _is_prob(s: str) -> bool:
        try:
            float(s)
            return True
        except ValueError:
            return False

    with open(path, "rb") as probe:
        is_gzip = probe.read(2) == b"\x1f\x8b"
    opener = gzip.open if is_gzip else open
    pairs = []
    n_lines = n_bad = 0
    with opener(path, "rt", encoding="utf-8", errors="replace") as f:
        for line in f:
            if not line.strip():
                continue
            n_lines += 1
            parts = [p.strip() for p in line.split("|||")]
            if len(parts) == 2 and parts[0] and parts[1]:
                pairs.append((parts[0], parts[1]))
            elif len(parts) == 3 and _is_prob(parts[0]) and parts[1] and parts[2]:
                pairs.append((parts[1], parts[2]))
            elif len(parts) == 3 and _is_prob(parts[2]) and parts[0] and parts[1]:
                pairs.append((parts[0], parts[1]))
            else:
                n_bad += 1
    if not pairs:
        raise ValueError(
            f"paraphrase table {path!r}: no 'phrase ||| paraphrase' pairs parsed "
            f"({n_lines} non-empty lines) — wrong file or unsupported format"
        )
    if n_bad * 2 > n_lines:
        raise ValueError(
            f"paraphrase table {path!r}: {n_bad}/{n_lines} lines unparseable — "
            "refusing to run the paraphrase stage on a mostly-corrupt table"
        )
    return ParaphraseTable(pairs)

# English function words: articles, conjunctions, prepositions, pronouns,
# auxiliaries/modals, common adverbs of degree — the classes the jar's
# frequency-derived function.words file contains.
FUNCTION_WORDS = frozenset("""
a an the and or but nor so yet for of in on at by to from with without within into onto
upon under over above below between among through during before after since until about
against along across behind beyond beneath beside besides despite down up off out near
than as if then else when whenever where wherever while because although though unless
whereas whether once that which who whom whose what this these those it its he him his
she her hers they them their theirs we us our ours you your yours i me my mine myself
yourself himself herself itself ourselves themselves is am are was were be been being
do does did done doing have has had having will would shall should may might can could
must ought not no nor never also very too quite rather just only even still there here
each every either neither both all any some such own same other another much many more
most few little less least
""".split())


def load_function_words(path: str) -> frozenset:
    """Load the jar's ``data/function.words`` verbatim (one lowercase word per
    line; blank lines and ``#`` comments ignored) so the δ-weighting uses the
    exact corpus-derived list instead of the built-in approximation. File-gated
    like the paraphrase table (CXRMATE_METEOR_FUNCTION_WORDS); fails loudly on
    an empty or wordless file."""
    words = set()
    with open(path, "rt", encoding="utf-8") as f:
        for line in f:
            w = line.strip().lower()
            if w and not w.startswith("#"):
                if len(w.split()) != 1:
                    raise ValueError(
                        f"function-word file {path!r}: multi-word line {w!r} — "
                        "expected one word per line (the jar's function.words format)"
                    )
                words.add(w)
    if not words:
        raise ValueError(f"function-word file {path!r}: no words parsed")
    return frozenset(words)


def _word_weight(w: str, delta: float = DELTA, function_words: frozenset = None) -> float:
    fw = FUNCTION_WORDS if function_words is None else function_words
    return (1.0 - delta) if w in fw else delta


def _candidate_matches(hyp: List[str], ref: List[str], synonyms,
                       weights: Sequence[float], paraphrases=None,
                       ) -> List[List[Tuple[int, int, int, float]]]:
    """For each hyp start index, the (hyp_len, ref_start, ref_len, module weight)
    span candidates, using the highest-priority module matching each pair.
    Single-word modules (exact/stem/synonym) emit 1×1 spans; the paraphrase
    module emits multi-word spans from the table. ``weights`` is (exact, stem,
    synonym) or (exact, stem, synonym, paraphrase); a 3-tuple uses the
    METEOR-1.5 paraphrase weight."""
    w_exact, w_stem, w_syn = weights[:3]
    w_para = weights[3] if len(weights) > 3 else WEIGHT_PARA
    hyp_stems = [stem(w) for w in hyp]
    ref_stems = [stem(w) for w in ref]
    cands: List[List[Tuple[int, int, int, float]]] = []
    for i, h in enumerate(hyp):
        row = []
        for j, r in enumerate(ref):
            if h == r:
                row.append((1, j, 1, w_exact))
            elif hyp_stems[i] == ref_stems[j]:
                row.append((1, j, 1, w_stem))
            elif synonyms is not None and synonyms(h, r):
                row.append((1, j, 1, w_syn))
        cands.append(row)
    if paraphrases is not None and paraphrases.max_len > 0:
        # ref phrase occurrences up to the table's longest phrase
        ref_spans: Dict[str, List[Tuple[int, int]]] = {}
        for j in range(len(ref)):
            for n in range(1, min(paraphrases.max_len, len(ref) - j) + 1):
                ref_spans.setdefault(" ".join(ref[j:j + n]), []).append((j, n))
        for i in range(len(hyp)):
            matched_1x1 = {j for hl, j, jl, _ in cands[i] if hl == 1 and jl == 1}
            for n in range(1, min(paraphrases.max_len, len(hyp) - i) + 1):
                phrase = " ".join(hyp[i:i + n])
                for q in paraphrases.get(phrase):
                    for j, jn in ref_spans.get(q, ()):
                        if n == 1 and jn == 1 and j in matched_1x1:
                            continue  # a higher-priority module already matched it
                        cands[i].append((n, j, jn, w_para))
    return cands


def _align(hyp: List[str], ref: List[str], synonyms,
           weights: Sequence[float] = (WEIGHT_EXACT, WEIGHT_STEM, WEIGHT_SYN),
           paraphrases=None,
           ) -> List[Tuple[int, int, int, int, float]]:
    """One-to-one span alignment via beam search: max matched words
    (hyp+ref), then min chunks, then min total |i−j| of span starts (the jar's
    Aligner resolution order). Returns [(hyp_start, hyp_len, ref_start,
    ref_len, module_weight)] sorted by hyp start. Without a paraphrase table
    every span is 1×1 and this reduces to the word aligner."""
    cands = _candidate_matches(hyp, ref, synonyms, weights, paraphrases)
    # beam state: (matched_words, last span end (i_end, j_end) or None, chunks,
    #              dist, used_ref_frozenset, align_list); states are bucketed by
    #              the hyp position they have consumed up to (span matches jump).
    frontier: Dict[int, Dict] = {0: {(frozenset(), None): (0, None, 0, 0, frozenset(), ())}}
    for i in range(len(hyp)):
        bucket = frontier.pop(i, None)
        if not bucket:
            continue
        states = sorted(bucket.values(), key=lambda s: (-s[0], s[2], s[3]))[:_BEAM]

        def push(pos, st):
            tgt = frontier.setdefault(pos, {})
            key = (st[4], st[1])
            old = tgt.get(key)
            if old is None or (-st[0], st[2], st[3]) < (-old[0], old[2], old[3]):
                tgt[key] = st

        for m, last, chunks, dist, used, al in states:
            # skip word i (breaks any running chunk)
            push(i + 1, (m, None, chunks, dist, used, al))
            for hl, j, jl, w in cands[i]:
                span = range(j, j + jl)
                if any(jj in used for jj in span):
                    continue
                new_chunks = chunks + (0 if last == (i, j) else 1)
                push(i + hl, (m + hl + jl, (i + hl, j + jl), new_chunks,
                              dist + abs(i - j), used | set(span),
                              al + ((i, hl, j, jl, w),)))
    final = frontier.get(len(hyp), {})
    best = min(final.values(), key=lambda s: (-s[0], s[2], s[3]))
    return list(best[5])


class SegmentStats:
    """Sufficient statistics of one (hyp, ref) pair — summable for the corpus score."""

    __slots__ = ("w_hyp", "w_ref", "wm_hyp", "wm_ref", "chunks", "matches")

    def __init__(self, w_hyp=0.0, w_ref=0.0, wm_hyp=0.0, wm_ref=0.0, chunks=0, matches=0.0):
        self.w_hyp, self.w_ref = w_hyp, w_ref
        self.wm_hyp, self.wm_ref = wm_hyp, wm_ref
        self.chunks, self.matches = chunks, matches

    def add(self, other: "SegmentStats") -> None:
        self.w_hyp += other.w_hyp
        self.w_ref += other.w_ref
        self.wm_hyp += other.wm_hyp
        self.wm_ref += other.wm_ref
        self.chunks += other.chunks
        self.matches += other.matches

    def score(self, alpha: float = ALPHA, beta: float = BETA, gamma: float = GAMMA) -> float:
        if self.wm_hyp == 0.0 or self.wm_ref == 0.0:
            return 0.0
        p = self.wm_hyp / self.w_hyp
        r = self.wm_ref / self.w_ref
        f = (p * r) / (alpha * p + (1.0 - alpha) * r)
        # fully-contiguous alignments take no penalty (single chunk covering
        # everything ⇒ ch/m minimal); the jar uses frag = ch/m directly
        frag = self.chunks / self.matches if self.matches else 0.0
        return (1.0 - gamma * (frag ** beta)) * f


def _segment_stats(hyp: List[str], ref: List[str], synonyms, delta: float = DELTA,
                   weights: Sequence[float] = (WEIGHT_EXACT, WEIGHT_STEM, WEIGHT_SYN),
                   paraphrases=None, function_words: Optional[frozenset] = None,
                   ) -> SegmentStats:
    if not hyp or not ref:
        return SegmentStats(
            w_hyp=sum(_word_weight(w, delta, function_words) for w in hyp),
            w_ref=sum(_word_weight(w, delta, function_words) for w in ref),
        )
    align = _align(hyp, ref, synonyms, weights, paraphrases)
    st = SegmentStats(
        w_hyp=sum(_word_weight(w, delta, function_words) for w in hyp),
        w_ref=sum(_word_weight(w, delta, function_words) for w in ref),
    )
    # matched-word count = average of hyp- and ref-side matched words (the
    # jar's MeteorStats averages the two; they only differ for phrase matches
    # of unequal span length — 1×1 spans keep matches == len(align))
    m_hyp = m_ref = 0
    last = None
    for i, hl, j, jl, w in align:
        st.wm_hyp += w * sum(_word_weight(x, delta, function_words) for x in hyp[i:i + hl])
        st.wm_ref += w * sum(_word_weight(x, delta, function_words) for x in ref[j:j + jl])
        m_hyp += hl
        m_ref += jl
        if last is None or (i, j) != last:
            st.chunks += 1
        last = (i + hl, j + jl)
    st.matches = (m_hyp + m_ref) / 2.0
    # literal identity zeroes the fragmentation penalty (the jar's special case)
    if hyp == ref:
        st.chunks = 0
    return st


def meteor(
    gts: Dict, res: Dict, synonyms: Optional[Callable[[str, str], bool]] = None,
    *,
    alpha: float = ALPHA, beta: float = BETA, gamma: float = GAMMA, delta: float = DELTA,
    weights: Sequence[float] = (WEIGHT_EXACT, WEIGHT_STEM, WEIGHT_SYN),
    paraphrases: Optional[ParaphraseTable] = None,
    function_words: Optional[frozenset] = None,
) -> Tuple[float, List[float]]:
    """pycocoevalcap-style interface: gts/res are {id: [tokenised string, ...]};
    returns (corpus score from summed stats, per-item scores). Inputs are expected
    PTB-tokenised + lowercased (the reference pipeline applies PTBTokenizer first;
    the jar's -norm flag additionally lowercases, reproduced here).

    The keyword parameters default to METEOR-1.5 English; alternative settings
    reproduce other members of the family — ``alpha=0.9, beta=3.0, gamma=0.5,
    delta=0.5, weights=(1, 1, 1)`` is METEOR-original (Lavie & Agarwal 2007, what
    nltk implements; δ=0.5 makes word weighting uniform), used by the
    cross-validation test against nltk (tests/test_meteor.py). ``weights`` takes
    an optional 4th element for the paraphrase module (default 0.6, METEOR-1.5),
    so alternative parameterizations apply to every stage."""
    agg = SegmentStats()
    per_item: List[float] = []
    for key in gts:
        hyp = res[key][0].lower().split()
        best: Optional[SegmentStats] = None
        # an empty reference list scores 0 (stats vs an empty reference),
        # matching the hyp=='' handling, instead of crashing on best=None
        for ref_s in gts[key] or [""]:
            st = _segment_stats(hyp, ref_s.lower().split(), synonyms, delta, weights,
                                paraphrases, function_words)
            if best is None or st.score(alpha, beta, gamma) > best.score(alpha, beta, gamma):
                best = st
        per_item.append(best.score(alpha, beta, gamma))
        agg.add(best)
    return agg.score(alpha, beta, gamma), per_item


def wordnet_synonyms(warn: bool = True) -> Optional[Callable[[str, str], bool]]:
    """WordNet-backed synonym module (the jar's third stage). Returns None —
    with a warning unless ``warn=False`` — when the nltk WordNet corpus is not
    installed; ``default_synonyms`` then falls back to the
    vendored table so the battery still runs the jar's full module stack."""
    try:
        from nltk.corpus import wordnet

        wordnet.synsets("test")  # force corpus load
    except (ImportError, LookupError):
        if warn:
            import warnings

            warnings.warn(
                "nltk WordNet corpus not installed — falling back to the vendored "
                "synonymy table (eval/data/synonyms_en.txt) via default_synonyms()",
                RuntimeWarning,
            )
        return None

    def related(a: str, b: str) -> bool:
        if a == b:
            return True
        sa = {l.name() for s in wordnet.synsets(a) for l in s.lemmas()}
        return b in sa or a in {l.name() for s in wordnet.synsets(b) for l in s.lemmas()}

    return related


class SynonymTable:
    """Synonymy from a grouped word list — the default synonym module when the
    WordNet corpus is absent.

    The table file has one synonym group per line (comma-separated lowercase
    lemmas; ``#`` comments and blank lines ignored). Lookup is keyed by surface
    form AND Snowball stem — the stem-keying stands in for the lemmatised
    (morphy) lookup WordNet-backed implementations do, so inflected forms
    ("persists"/"remained") still hit their lemma's group. Two words are
    synonymous when their key sets share a group id. Callable with the
    ``synonyms=`` signature ``(a, b) -> bool`` that ``meteor`` expects."""

    def __init__(self, groups):
        self.groups = [frozenset(g) for g in groups if len(g) >= 2]
        key_to_gids: Dict[str, set] = {}
        for gid, g in enumerate(self.groups):
            for w in g:
                key_to_gids.setdefault(w, set()).add(gid)
                key_to_gids.setdefault(stem(w), set()).add(gid)
        self._key_to_gids = {k: frozenset(v) for k, v in key_to_gids.items()}
        self._empty: frozenset = frozenset()

    def _gids(self, w: str) -> frozenset:
        direct = self._key_to_gids.get(w, self._empty)
        stemmed = self._key_to_gids.get(stem(w), self._empty)
        return direct | stemmed

    def __call__(self, a: str, b: str) -> bool:
        if a == b:
            return True
        ga = self._gids(a)
        return bool(ga) and not ga.isdisjoint(self._gids(b))

    def __len__(self) -> int:
        return len(self.groups)


def load_synonym_table(path: Optional[str] = None) -> SynonymTable:
    """Load a grouped synonymy file (default: the vendored
    ``eval/data/synonyms_en.txt`` — a curated approximation of the jar's
    WordNet-derived English synonymy, written for this project because neither
    the jar's database nor the WordNet corpus can ship with it; see the file
    header for provenance). Fails loudly on an
    empty or groupless file (same contract as ``load_paraphrase_table``)."""
    import os

    if path is None:
        path = os.path.join(os.path.dirname(__file__), "data", "synonyms_en.txt")
    groups = []
    with open(path, "rt", encoding="utf-8") as f:
        for line in f:
            line = line.strip().lower()
            if not line or line.startswith("#"):
                continue
            words = [w.strip() for w in line.split(",")]
            words = [w for w in words if w]
            if len(words) >= 2:
                groups.append(words)
    if not groups:
        raise ValueError(
            f"synonym table {path!r}: no groups parsed — expected one "
            "comma-separated synonym group per line"
        )
    return SynonymTable(groups)


_DEFAULT_SYNONYMS: Optional[Callable[[str, str], bool]] = None


def default_synonyms() -> Callable[[str, str], bool]:
    """The synonym module the battery runs BY DEFAULT, so a plain ``--test``
    executes the jar's full English module stack exact→stem→synonym
    (the reference's ``tools/metrics/coco.py:59``: the jar always enables the
    synonym stage for English): the real WordNet corpus when nltk can load it,
    else the vendored table. Cached after the first call."""
    global _DEFAULT_SYNONYMS
    if _DEFAULT_SYNONYMS is None:
        _DEFAULT_SYNONYMS = wordnet_synonyms(warn=False) or load_synonym_table()
    return _DEFAULT_SYNONYMS
