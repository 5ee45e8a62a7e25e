"""PTB tokenisation for captioning metrics.

The port's own copy of ``cxrmate_tpu/eval/ptb.py``. The reference pipes
reports through Stanford's PTBTokenizer jar with ``-preserveLines
-lowerCase`` and then drops punctuation tokens
(`pycocoevalcap/tokenizer/ptbtokenizer.py`). This is a pure-Python
reimplementation of the same Treebank tokenisation rules (the public PTB
sed-script regexes, as also ported by nltk's TreebankWordTokenizer) followed
by the identical punctuation-token filter: no Java required."""

from __future__ import annotations

import re
from typing import Dict, List

# Tokens pycocoevalcap removes after tokenisation.
PUNCTUATIONS = {
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

_RULES_1 = [
    (re.compile(r"^\""), r"`` "),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r'([ (\[{<])"'), r"\1 `` "),
]
_PUNCT = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]

# Word-final periods that STAY attached (Stanford PTBLexer's abbreviation
# handling): single initials ("j."), letter-period acronyms ("u.s.", "e.g.",
# "i.e.", "a.m."), and a lexicon of common abbreviations. Everything else
# ending in "." is split into word + "." wherever it occurs in the line — the
# original PTB sed script only handled the LINE-final period because its input
# was pre-split one sentence per line, but pycocoevalcap feeds the Stanford
# jar one whole (multi-sentence) caption per line with -preserveLines, and the
# jar splits every sentence-final period. Radiology reports are multi-sentence,
# so without this rule every mid-report sentence end produced a "word." token
# that could never match the reference battery's "word" (the split "." itself
# is dropped by PUNCTUATIONS, like pycocoevalcap does).
_ABBREV_KEEP = re.compile(
    r"(?i)^(?:"
    r"[a-z]\."  # single initial
    r"|(?:[a-z]\.){2,}"  # acronym: u.s., e.g., i.e., a.m., p.m.
    r"|(?:dr|drs|mr|mrs|ms|prof|rev|hon|sen|rep|gen|col|lt|sgt|capt|gov|"
    r"jr|sr|st|mt|vs|etc|al|inc|ltd|co|corp|bros|no|nos|fig|figs|cf|ca|"
    r"approx|dept|est|misc|min|max|vol|sec|jan|feb|mar|apr|jun|jul|aug|"
    r"sept|sep|oct|nov|dec)\."
    r")$"
)


_PERIOD_TRAIL = re.compile(r"^(.+)\.([\"']*)$")  # word. / word." / word.'


def _split_sentence_periods(text: str) -> str:
    out = []
    for tok in text.split():
        m = _PERIOD_TRAIL.match(tok)
        # m.group(1).strip("."): don't re-split an ellipsis ("..." is already
        # its own token here and PUNCTUATIONS drops it whole)
        if m and m.group(1).strip(".") and not _ABBREV_KEEP.match(m.group(1) + "."):
            head = m.group(1)
            periods = ["."]
            # double-period typos ("edema..", common in generated reports)
            # leave further trailing periods on the head — keep splitting
            # unless that would empty the word or break an abbreviation
            # ("etc.." keeps "etc." + ".")
            while head.endswith(".") and head.rstrip(".") and not _ABBREV_KEEP.match(head):
                head = head[:-1]
                periods.append(".")
            out.append(head)
            out.extend(periods)
            if m.group(2):
                out.append(m.group(2))
        else:
            out.append(tok)
    return " ".join(out)
_BRACKETS = [
    (re.compile(r"[\]\[\(\)\{\}<>]"), r" \g<0> "),
    (re.compile(r"\("), "-LRB-"),
    (re.compile(r"\)"), "-RRB-"),
    (re.compile(r"\["), "-LSB-"),
    (re.compile(r"\]"), "-RSB-"),
    (re.compile(r"\{"), "-LCB-"),
    (re.compile(r"\}"), "-RCB-"),
    (re.compile(r"--"), r" -- "),
]
_ENDQ = [
    (re.compile(r'"'), " '' "),
    (re.compile(r"(\S)('')"), r"\1 \2 "),
]
_CONTRACTIONS = [
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
_CLITICS = [
    (re.compile(r"(?i)\b(can)(not)\b"), r"\1 \2"),
    (re.compile(r"(?i)\b(d)('ye)\b"), r"\1 \2"),
    (re.compile(r"(?i)\b(gim)(me)\b"), r"\1 \2"),
    (re.compile(r"(?i)\b(gon)(na)\b"), r"\1 \2"),
    (re.compile(r"(?i)\b(got)(ta)\b"), r"\1 \2"),
    (re.compile(r"(?i)\b(lem)(me)\b"), r"\1 \2"),
    (re.compile(r"(?i)\b(more)('n)\b"), r"\1 \2"),
    (re.compile(r"(?i)\b(wan)(na)(?=\s)"), r"\1 \2"),
]


def ptb_tokenize_line(text: str, lowercase: bool = True) -> List[str]:
    text = str(text)
    for rx, sub in _RULES_1:
        text = rx.sub(sub, text)
    for rx, sub in _PUNCT:
        text = rx.sub(sub, text)
    for rx, sub in _BRACKETS:
        text = rx.sub(sub, text)
    text = _split_sentence_periods(text)
    text = f" {text} "
    for rx, sub in _ENDQ:
        text = rx.sub(sub, text)
    for rx, sub in _CONTRACTIONS:
        text = rx.sub(sub, text)
    for rx, sub in _CLITICS:
        text = rx.sub(sub, text)
    tokens = text.split()
    if lowercase:
        tokens = [t.lower() for t in tokens]
    return [t for t in tokens if t not in PUNCTUATIONS]


def ptb_tokenize(captions: Dict) -> Dict:
    """pycocoevalcap PTBTokenizer.tokenize(): {id: [{'caption': s}, ...]} →
    {id: [tokenised-string, ...]}."""
    return {
        k: [" ".join(ptb_tokenize_line(d["caption"])) for d in v]
        for k, v in captions.items()
    }
