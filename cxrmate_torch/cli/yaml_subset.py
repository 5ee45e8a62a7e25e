"""A reader for the subset of YAML that the task configs and their
``key=value`` overrides use, typed as ``yaml.safe_load`` types it.

The subset:

  * block mappings (``key: value``, ``key:`` with a nested block or nothing)
    and block sequences of scalars (``- item``), indented with spaces;
  * flow sequences of scalars (``[a, b, "c"]``);
  * ``#`` comments;
  * single- and double-quoted strings on one line, and plain strings;
  * YAML 1.1 plain scalars as PyYAML resolves them: ints (decimal, ``0b``,
    ``0x``, leading-zero octal, ``:`` base 60, ``_`` separators), floats
    only with a dot (``5.0e-6`` is a float, ``1e-4`` and ``1.0e6`` strings),
    ``.inf``/``.nan``, ``true/false/yes/no/on/off`` in their three cases,
    ``null``, ``~`` and the empty scalar.

Anything else (flow mappings, anchors, aliases, tags, block scalars,
multi-line scalars, dates, documents markers, tabs in indentation) raises
``ValueError`` naming the line: the reader never guesses.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Optional, Tuple

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                  |[-+]?0[0-7_]+
                  |[-+]?(?:0|[1-9][0-9_]*)
                  |[-+]?0x[0-9a-fA-F_]+
                  |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                        |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?
                        (?:[Tt]|[ \t]+)[0-9][0-9]?
                        :[0-9][0-9]:[0-9][0-9](?:\.[0-9]*)?
                        (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X)
# a plain scalar may not start with these (YAML 1.1 indicators)
_BAD_START = set("&*!|>%@`{}[],#'\"")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _fail(lineno: int, line: str, why: str):
    raise ValueError(f"line {lineno}: {why} (outside the YAML subset this reader "
                     f"takes): {line.strip()!r}")


def _sexagesimal(value: str, conv) -> Any:
    digits = [conv(part) for part in value.split(":")]
    base, out = 1, 0
    for d in reversed(digits):
        out += d * base
        base *= 60
    return out


def _to_int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    if value == "0":
        return 0
    if value.startswith("0b"):
        return sign * int(value[2:], 2)
    if value.startswith("0x"):
        return sign * int(value[2:], 16)
    if value[0] == "0":
        return sign * int(value, 8)
    if ":" in value:
        return sign * _sexagesimal(value, int)
    return sign * int(value)


def _to_float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    if value[0] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * math.inf
    if value == ".nan":
        return math.nan
    if ":" in value:
        return sign * _sexagesimal(value, float)
    return sign * float(value)


def plain_scalar(text: str, lineno: int = 1, line: Optional[str] = None) -> Any:
    """Type one plain scalar (already stripped) as PyYAML's resolvers do."""
    line = text if line is None else line
    if _NULL.match(text):
        return None
    if text[0] in _BAD_START:
        _fail(lineno, line, f"a plain scalar starting with {text[0]!r}")
    if text in ("-", "?", ":") or text[:2] in ("- ", "? ") or text.endswith(":") \
            or ": " in text or "\t" in text:
        _fail(lineno, line, "a mapping or sequence where a scalar belongs")
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        return _to_float(text)
    if _INT.match(text):
        try:
            return _to_int(text)
        except ValueError:  # "0x_", "0b_": safe_load's own int() fails on them too
            _fail(lineno, line, "an integer without digits")
    if _TIMESTAMP.match(text) or text in ("=", "<<"):
        _fail(lineno, line, "a timestamp, value or merge key")
    return text


def _quoted(text: str, lineno: int, line: str) -> Tuple[str, str]:
    """A quoted scalar at the start of ``text`` -> (its value, the rest)."""
    q = text[0]
    out, i = [], 1
    while i < len(text):
        c = text[i]
        if q == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), text[i + 1:]
            out.append(c)
            i += 1
            continue
        if c == '"':
            return "".join(out), text[i + 1:]
        if c == "\\":
            e = text[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                digits = text[i + 2:i + 2 + n]
                if len(digits) != n or not all(d in "0123456789abcdefABCDEF" for d in digits):
                    _fail(lineno, line, "a malformed escape")
                out.append(chr(int(digits, 16)))
                i += 2 + n
            else:
                _fail(lineno, line, "an unknown escape")
            continue
        out.append(c)
        i += 1
    _fail(lineno, line, "a quoted string that does not end on its line")


def _starts_value(text: str, i: int) -> bool:
    """Whether ``text[i]`` starts a value: at the start of the content,
    after ``- `` or after ``: ``."""
    prev = text[:i].rstrip(" ")
    stem = prev.strip()
    return stem == "" or ((stem == "-" or stem.endswith(":")) and len(prev) < i)


def _strip_comment(text: str) -> str:
    """``text`` without a trailing ``#`` comment (a ``#`` at the start or
    after whitespace, outside quotes), right-stripped. A quote opens a
    quoted scalar where a value starts or after a flow sequence's ``[`` or
    ``,``; a ``[`` opens a flow sequence only where a value starts (inside a
    plain scalar both are text)."""
    q, flow = None, False
    for i, c in enumerate(text):
        if q:
            if c == q:
                q = None
        elif c in "'\"" and (_starts_value(text, i)
                             or (flow and text[:i].rstrip(" ").endswith(("[", ",")))):
            q = c
        elif c == "[" and _starts_value(text, i):
            flow = True
        elif c == "]":
            flow = False
        elif c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _flow_sequence(text: str, lineno: int, line: str) -> List[Any]:
    inner = text[1:]
    items: List[Any] = []
    expect_item = True
    while True:
        inner = inner.lstrip(" ")
        if not inner:
            _fail(lineno, line, "a flow sequence that does not end on its line")
        if inner[0] == "]":
            if inner[1:].strip():
                _fail(lineno, line, "text after a flow sequence")
            return items
        if not expect_item:
            if inner[0] != ",":
                _fail(lineno, line, "a missing ',' in a flow sequence")
            inner, expect_item = inner[1:], True
            continue
        if inner[0] in "[{":
            _fail(lineno, line, "a nested flow collection")
        if inner[0] == ",":
            _fail(lineno, line, "an empty flow sequence item")
        if inner[0] in "'\"":
            value, inner = _quoted(inner, lineno, line)
        else:
            end = min((inner.find(c) for c in ",]" if c in inner), default=len(inner))
            token = inner[:end].rstrip()
            if any(c in token for c in "[]{}"):
                _fail(lineno, line, "a flow indicator inside a flow scalar")
            if token[0] in "?:":  # PyYAML reads these as indicators in a flow
                _fail(lineno, line, f"a flow scalar starting with {token[0]!r}")
            value, inner = plain_scalar(token, lineno, line), inner[end:]
        items.append(value)
        expect_item = False


def scalar(text: str, lineno: int = 1, line: Optional[str] = None) -> Any:
    """A value on one line (comment already stripped): quoted, flow sequence
    or plain."""
    line = text if line is None else line
    text = text.strip()
    if not text:
        return None
    if text[0] in "'\"":
        value, rest = _quoted(text, lineno, line)
        if rest.strip():
            _fail(lineno, line, "text after a quoted string")
        return value
    if text[0] == "[":
        return _flow_sequence(text, lineno, line)
    return plain_scalar(text, lineno, line)


def _split_key(content: str, lineno: int, line: str) -> Optional[Tuple[Any, str]]:
    """``key: rest`` -> (typed key, rest); None when ``content`` is no
    mapping entry."""
    if content[0] in "[{":  # a flow collection is a value here, never a key
        return None
    if content[0] in "'\"":
        key, rest = _quoted(content, lineno, line)
        rest = rest.lstrip(" ")
        if not rest.startswith(":") or rest[1:2] not in ("", " "):
            return None
        return key, rest[1:]
    m = re.search(r":(?: |$)", content)
    if m is None:
        return None
    key = content[:m.start()].rstrip()
    if not key:
        _fail(lineno, line, "an empty key")
    return plain_scalar(key, lineno, line), content[m.end():]


def load(text: str) -> Any:
    """Parse ``text`` (one document of the subset) -> its value, as
    ``yaml.safe_load`` gives it. Raises ``ValueError`` naming the line for
    anything outside the subset."""
    lines = []  # (lineno, indent, content, raw line)
    for n, raw in enumerate(text.splitlines(), 1):
        body = _strip_comment(raw)
        if not body.strip():
            continue
        stripped = body.lstrip(" ")
        if stripped.startswith("\t"):
            _fail(n, raw, "a tab in the indentation")
        if (stripped.startswith(("---", "...")) and stripped[3:4] in ("", " ")) \
                or (len(stripped) == len(body) and stripped.startswith("%")):
            _fail(n, raw, "a document marker or directive")
        lines.append((n, len(body) - len(stripped), stripped, raw))
    if not lines:
        return None
    value, pos = _block(lines, 0, lines[0][1])
    if pos != len(lines):
        n, _, _, raw = lines[pos]
        _fail(n, raw, "unexpected indentation")
    return value


def _is_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _block(lines, pos: int, indent: int) -> Tuple[Any, int]:
    n, ind, content, raw = lines[pos]
    if ind != indent:
        _fail(n, raw, "unexpected indentation")
    if _is_item(content):
        return _sequence(lines, pos, indent)
    if _split_key(content, n, raw) is not None:
        return _mapping(lines, pos, indent)
    if pos + 1 < len(lines):
        _fail(lines[pos + 1][0], lines[pos + 1][3], "a scalar that spans lines")
    return scalar(content, n, raw), pos + 1


def _sequence(lines, pos: int, indent: int) -> Tuple[List[Any], int]:
    out = []
    while pos < len(lines) and lines[pos][1] == indent and _is_item(lines[pos][2]):
        n, _, content, raw = lines[pos]
        item = content[1:].strip()
        if not item or item.startswith("- ") or item == "-" or \
                (item[0] not in "'\"[" and _split_key(item, n, raw) is not None):
            _fail(n, raw, "a sequence item that is not a scalar")
        out.append(scalar(item, n, raw))
        pos += 1
    if pos < len(lines) and lines[pos][1] > indent:
        _fail(lines[pos][0], lines[pos][3], "unexpected indentation")
    return out, pos


def _mapping(lines, pos: int, indent: int) -> Tuple[dict, int]:
    out = {}
    while pos < len(lines) and lines[pos][1] == indent:
        n, _, content, raw = lines[pos]
        if _is_item(content):
            _fail(n, raw, "a sequence item inside a mapping")
        split = _split_key(content, n, raw)
        if split is None:
            _fail(n, raw, "a line that is not 'key: value'")
        key, rest = split
        try:
            hash(key)
        except TypeError:
            _fail(n, raw, "an unhashable key")
        pos += 1
        if rest.strip():
            out[key] = scalar(rest, n, raw)
            continue
        nxt = lines[pos] if pos < len(lines) else None
        if nxt is not None and (nxt[1] > indent or (nxt[1] == indent and _is_item(nxt[2]))):
            out[key], pos = _block(lines, pos, nxt[1])
        else:
            out[key] = None
    if pos < len(lines) and lines[pos][1] > indent:
        _fail(lines[pos][0], lines[pos][3], "unexpected indentation")
    return out, pos
