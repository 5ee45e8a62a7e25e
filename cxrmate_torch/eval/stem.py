"""Snowball English ("Porter2") stemmer: pure Python, no dependencies.

The port's own copy of ``cxrmate_tpu/eval/stem.py``. This is the stemmer the
reference's METEOR jar uses for its "stem" module
(``org.tartarus.snowball.ext.englishStemmer``; the jar is invoked from the
reference's ``tools/metrics/coco.py:2-7`` via pycocoevalcap). Implemented from
the published algorithm (snowballstem.org/algorithms/english/stemmer.html)."""

from __future__ import annotations

_VOWELS = set("aeiouy")
_DOUBLES = ("bb", "dd", "ff", "gg", "mm", "nn", "pp", "rr", "tt")
_LI_ENDING = set("cdeghkmnrt")

_EXCEPTIONS = {
    "skis": "ski", "skies": "sky", "dying": "die", "lying": "lie", "tying": "tie",
    "idly": "idl", "gently": "gentl", "ugly": "ugli", "early": "earli",
    "only": "onli", "singly": "singl",
    # invariant forms
    "sky": "sky", "news": "news", "howe": "howe", "atlas": "atlas",
    "cosmos": "cosmos", "bias": "bias", "andes": "andes",
}

_EXCEPTIONS_1A = {"inning", "outing", "canning", "herring", "earring",
                  "proceed", "exceed", "succeed"}


def _is_vowel(word: str, i: int) -> bool:
    return word[i] in _VOWELS


def _r1_r2(word: str) -> tuple:
    """R1: region after the first non-vowel following a vowel. R2: same rule
    applied within R1. Special prefixes gener/commun/arsen pin R1."""
    r1 = len(word)
    for prefix in ("gener", "commun", "arsen"):
        if word.startswith(prefix):
            r1 = len(prefix)
            break
    else:
        for i in range(1, len(word)):
            if not _is_vowel(word, i) and _is_vowel(word, i - 1):
                r1 = i + 1
                break
    r2 = len(word)
    for i in range(r1 + 1, len(word)):
        if not _is_vowel(word, i) and _is_vowel(word, i - 1):
            r2 = i + 1
            break
    return r1, r2


def _ends_short_syllable(word: str) -> bool:
    """Short syllable: vowel + non-vowel(≠ w,x,Y) preceded by non-vowel; or a
    vowel at the start followed by a non-vowel."""
    n = len(word)
    if n == 2:
        return _is_vowel(word, 0) and not _is_vowel(word, 1)
    if n >= 3:
        return (
            not _is_vowel(word, n - 3)
            and _is_vowel(word, n - 2)
            and word[n - 1] not in _VOWELS
            and word[n - 1] not in "wxY"
        )
    return False


def _is_short(word: str, r1: int) -> bool:
    return r1 >= len(word) and _ends_short_syllable(word)


def stem(word: str) -> str:
    word = word.lower()
    if len(word) <= 2:
        return word
    if word.startswith("'"):
        word = word[1:]
    if word in _EXCEPTIONS:
        return _EXCEPTIONS[word]

    # mark consonant-y as Y (left-to-right on the evolving string: a y following
    # an already-marked Y is NOT after a vowel — Snowball's `goto v` semantics)
    chars = list(word)
    if chars[0] == "y":
        chars[0] = "Y"
    for i in range(1, len(chars)):
        if chars[i] == "y" and chars[i - 1] in _VOWELS:
            chars[i] = "Y"
    word = "".join(chars)

    r1, r2 = _r1_r2(word)

    # step 0: 's', 's, '
    for suf in ("'s'", "'s", "'"):
        if word.endswith(suf):
            word = word[: -len(suf)]
            break

    # step 1a
    if word.endswith("sses"):
        word = word[:-2]
    elif word.endswith(("ied", "ies")):
        word = word[:-3] + ("i" if len(word) > 4 else "ie")
    elif word.endswith(("us", "ss")):
        pass
    elif word.endswith("s"):
        if any(_is_vowel(word, i) for i in range(len(word) - 2)):
            word = word[:-1]

    if word in _EXCEPTIONS_1A:
        return word

    # step 1b
    if word.endswith(("eed", "eedly")):
        suf = "eedly" if word.endswith("eedly") else "eed"
        if len(word) - len(suf) >= r1:
            word = word[: -len(suf)] + "ee"
    else:
        for suf in ("ingly", "edly", "ing", "ed"):
            if word.endswith(suf):
                stem_part = word[: -len(suf)]
                if any(_is_vowel(stem_part, i) for i in range(len(stem_part))):
                    word = stem_part
                    if word.endswith(("at", "bl", "iz")):
                        word += "e"
                    elif word.endswith(_DOUBLES):
                        word = word[:-1]
                    elif _is_short(word, r1):
                        word += "e"
                break

    # step 1c: y/Y → i after a non-vowel that isn't the first letter
    if (
        len(word) > 2
        and word[-1] in "yY"
        and not _is_vowel(word, len(word) - 2)
    ):
        word = word[:-1] + "i"

    # step 2 (suffix found in R1)
    step2 = (
        ("ization", "ize"), ("ational", "ate"), ("fulness", "ful"),
        ("ousness", "ous"), ("iveness", "ive"), ("tional", "tion"),
        ("biliti", "ble"), ("lessli", "less"), ("entli", "ent"),
        ("ation", "ate"), ("alism", "al"), ("aliti", "al"), ("ousli", "ous"),
        ("iviti", "ive"), ("fulli", "ful"), ("enci", "ence"), ("anci", "ance"),
        ("abli", "able"), ("izer", "ize"), ("ator", "ate"), ("alli", "al"),
        ("bli", "ble"),
    )
    for suf, rep in step2:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                word = word[: -len(suf)] + rep
            break
    else:
        if word.endswith("ogi"):
            if len(word) - 3 >= r1 and len(word) >= 4 and word[-4] == "l":
                word = word[:-3] + "og"
        elif word.endswith("li"):
            if len(word) - 2 >= r1 and len(word) >= 3 and word[-3] in _LI_ENDING:
                word = word[:-2]

    # step 3 (suffix found in R1; 'ative' needs R2)
    step3 = (
        ("ational", "ate"), ("tional", "tion"), ("alize", "al"),
        ("icate", "ic"), ("iciti", "ic"), ("ical", "ic"),
        ("ful", ""), ("ness", ""),
    )
    for suf, rep in step3:
        if word.endswith(suf):
            if len(word) - len(suf) >= r1:
                word = word[: -len(suf)] + rep
            break
    else:
        if word.endswith("ative") and len(word) - 5 >= r2:
            word = word[:-5]

    # step 4 (suffix found in R2)
    step4 = ("ement", "ance", "ence", "able", "ible", "ment",
             "ant", "ent", "ism", "ate", "iti", "ous", "ive", "ize",
             "al", "er", "ic")
    for suf in step4:
        if word.endswith(suf):
            if len(word) - len(suf) >= r2:
                word = word[: -len(suf)]
            break
    else:
        if word.endswith("ion") and len(word) - 3 >= r2 and len(word) >= 4 and word[-4] in "st":
            word = word[:-3]

    # step 5
    if word.endswith("e"):
        if len(word) - 1 >= r2 or (
            len(word) - 1 >= r1 and not _ends_short_syllable(word[:-1])
        ):
            word = word[:-1]
    elif word.endswith("l") and len(word) - 1 >= r2 and len(word) >= 2 and word[-2] == "l":
        word = word[:-1]

    return word.replace("Y", "y")
