"""A small column table: what ``data/index.py`` and ``data/datasets.py`` ask
of pandas, with pandas' results, so that the port runs where pandas is absent.

Columns are numpy arrays: ``int64``, ``float64`` (missing values are NaN), or
``object`` holding ``str`` (missing values are ``float('nan')``), as
``pandas.read_csv`` types them. This is no general DataFrame: it has the row
masks, ``isin``, ``dropna``, ``drop_duplicates`` (keep the first),
``value_counts``, ``groupby(...)[col].apply(list)`` in sorted key order, a
stable multi-column ``sort_values`` (NaN last, as pandas' multi-key lexsort),
inner ``merge`` in pandas' row order (each left row in turn, its matches in
the right's order), the regex ``replace`` of index.py, and ``read_csv`` /
``to_csv(index=False)`` with pandas' type inference and bytes.
"""

from __future__ import annotations

import csv
import gzip
import io
import math
import re
from typing import Dict, Iterable, Iterator, List, Sequence, Union

import numpy as np

# pandas' default missing-value strings (pandas/_libs/parsers.pyx STR_NA_VALUES)
NA_STRINGS = frozenset({
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND", "1.#QNAN",
    "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
})
_INT = re.compile(r"[+-]?\d+\Z")
_FLOAT = re.compile(r"[+-]?(\d+\.?\d*([eE][+-]?\d+)?|\.\d+([eE][+-]?\d+)?|inf|infinity)\Z",
                    re.IGNORECASE)


def isna(values: np.ndarray) -> np.ndarray:
    """Missing values of a column: NaN or None."""
    if values.dtype.kind == "f":
        return np.isnan(values)
    if values.dtype.kind == "O":
        return np.fromiter((v is None or (isinstance(v, float) and math.isnan(v))
                            for v in values), bool, len(values))
    return np.zeros(len(values), bool)


def _column(cells: List[str]) -> np.ndarray:
    """One column of CSV cells typed as ``read_csv`` types it."""
    na = [c in NA_STRINGS for c in cells]
    present = [c for c, m in zip(cells, na) if not m]
    if present and all(_INT.match(c) for c in present) and not any(na):
        return np.array([int(c) for c in cells], np.int64)
    if all(_INT.match(c) or _FLOAT.match(c) for c in present):
        return np.array([math.nan if m else float(c) for c, m in zip(cells, na)], np.float64)
    return _objects([math.nan if m else c for c, m in zip(cells, na)])


def _objects(values: Iterable) -> np.ndarray:
    values = list(values)
    out = np.empty(len(values), object)
    out[:] = values
    return out


class Table:
    """Named columns of equal length, in order."""

    def __init__(self, columns: Dict[str, Union[np.ndarray, Sequence]]):
        self._cols: Dict[str, np.ndarray] = {}
        for name, values in columns.items():
            arr = values if isinstance(values, np.ndarray) else np.asarray(values)
            if arr.dtype.kind in "US":
                arr = _objects(arr.tolist())
            self._cols[name] = arr
        n = {len(v) for v in self._cols.values()}
        if len(n) > 1:
            raise ValueError(f"columns of different lengths: {sorted(n)}")

    @classmethod
    def from_rows(cls, rows: Sequence[Dict]) -> "Table":
        """Rows (dicts with the same keys, in order) -> a table, typed as
        ``pandas.DataFrame(rows)`` types them (ints, floats, strings)."""
        names = list(rows[0]) if rows else []
        cols = {}
        for n in names:
            vals = [r[n] for r in rows]
            if all(isinstance(v, (int, np.integer)) and not isinstance(v, bool) for v in vals):
                cols[n] = np.array(vals, np.int64)
            elif all(isinstance(v, (int, float, np.integer, np.floating)) for v in vals):
                cols[n] = np.array(vals, np.float64)
            else:
                cols[n] = _objects(vals)
        return cls(cols)

    # -- access
    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return len(next(iter(self._cols.values()))) if self._cols else 0

    def __getitem__(self, key):
        """A column by name; a sub-table by a list of names; the rows where a
        boolean mask is true; the rows at an integer index array."""
        if isinstance(key, str):
            return self._cols[key]
        if isinstance(key, list):
            return Table({k: self._cols[k] for k in key})
        key = np.asarray(key)
        if key.dtype == bool and len(key) != len(self):
            raise ValueError(f"mask of {len(key)} rows for a table of {len(self)}")
        return Table({k: v[key] for k, v in self._cols.items()})

    def __setitem__(self, name: str, values) -> None:
        arr = values if isinstance(values, np.ndarray) else np.asarray(values)
        if len(self._cols) and len(arr) != len(self):
            raise ValueError(f"column of {len(arr)} rows for a table of {len(self)}")
        self._cols[name] = arr

    def set_where(self, mask: np.ndarray, name: str, value) -> None:
        """``df.loc[mask, name] = value`` on an object column."""
        col = self._cols[name]
        for i in np.flatnonzero(mask):
            col[i] = value

    def row(self, i: int) -> Dict:
        """Row ``i`` as a dict, numbers as numpy scalars (as ``df.iloc[i]``)."""
        return {k: v[i] for k, v in self._cols.items()}

    def rows(self) -> Iterator[Dict]:
        for i in range(len(self)):
            yield self.row(i)

    def copy(self) -> "Table":
        return Table({k: v.copy() for k, v in self._cols.items()})

    def rename(self, mapping: Dict[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self._cols.items()})

    # -- row selection
    def dropna(self, subset: Sequence[str]) -> "Table":
        """``dropna(subset=..., how="any")``."""
        keep = np.ones(len(self), bool)
        for c in subset:
            keep &= ~isna(self._cols[c])
        return self[keep]

    def drop_duplicates(self, subset: Union[str, Sequence[str]]) -> "Table":
        """The first row of each distinct value of ``subset``, in row order."""
        subset = [subset] if isinstance(subset, str) else list(subset)
        seen, keep = set(), []
        for i, key in enumerate(zip(*(self._cols[c].tolist() for c in subset))):
            if key not in seen:
                seen.add(key)
                keep.append(i)
        return self[np.asarray(keep, np.int64)]

    def sort_values(self, by: Sequence[str]) -> "Table":
        """Stable ascending sort on the columns ``by`` (the first the major
        key), NaN last in each: pandas' multi-column ``sort_values``."""
        keys = []
        for c in reversed(list(by)):  # np.lexsort: the last key is the major one
            col = self._cols[c]
            if col.dtype.kind == "O":
                raise TypeError(f"sort on the object column {c!r} is not supported")
            keys.append(col)
        return self[np.lexsort(keys)] if len(self) else self

    # -- output
    def to_csv(self, path: str) -> None:
        """``DataFrame.to_csv(path, index=False)``: the same bytes (numbers
        through numpy's ``astype(str)``, NaN empty, the csv module's minimal
        quoting, ``\\n`` line ends)."""
        cols = []
        for v in self._cols.values():
            if v.dtype.kind in "iuf":
                s = v.astype(str).astype(object)
                if v.dtype.kind == "f":
                    s[np.isnan(v)] = ""
            else:
                s = _objects("" if (x is None or (isinstance(x, float) and math.isnan(x)))
                             else str(x) for x in v)
            cols.append(s)
        with open(path, "w", encoding="utf-8", newline="") as f:
            w = csv.writer(f, lineterminator="\n", quoting=csv.QUOTE_MINIMAL)
            w.writerow(self.columns)
            w.writerows(zip(*cols))


def read_csv(path: str) -> Table:
    """``pandas.read_csv(path)`` of the CSV files of index.py (also ``.gz``):
    integer columns int64, other numeric columns float64, the rest strings,
    pandas' missing-value strings NaN; blank lines skipped."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt", encoding="utf-8", newline="") as f:
        text = f.read()
    rows = [r for r in csv.reader(io.StringIO(text)) if r]
    if not rows:
        raise ValueError(f"{path}: no columns to parse")
    header, body = rows[0], rows[1:]
    width = len(header)
    for i, r in enumerate(body):
        if len(r) > width:
            raise ValueError(f"{path}: row {i + 2} has {len(r)} fields, expected {width}")
        if len(r) < width:
            r.extend([""] * (width - len(r)))
    return Table({name: _column([r[j] for r in body]) for j, name in enumerate(header)})


def merge(left: Table, right: Table, on: Union[str, Sequence[str]]) -> Table:
    """Inner ``pandas.merge(left, right, on=on)``: each left row in turn, with
    its matching right rows in the right's order; the left's columns, then
    the right's other columns (``_x``/``_y`` on a clash)."""
    on = [on] if isinstance(on, str) else list(on)
    index: Dict[tuple, List[int]] = {}
    for j, key in enumerate(zip(*(right[c].tolist() for c in on))):
        index.setdefault(key, []).append(j)
    li, ri = [], []
    for i, key in enumerate(zip(*(left[c].tolist() for c in on))):
        for j in index.get(key, ()):
            li.append(i)
            ri.append(j)
    li, ri = np.asarray(li, np.int64), np.asarray(ri, np.int64)
    cols = {}
    clash = (set(left.columns) & set(right.columns)) - set(on)
    for c in left.columns:
        cols[c + "_x" if c in clash else c] = left[c][li]
    for c in right.columns:
        if c not in on:
            cols[c + "_y" if c in clash else c] = right[c][ri]
    return Table(cols)


def value_counts(values: np.ndarray) -> Dict:
    """value -> number of rows holding it (``Series.value_counts`` as a lookup)."""
    uniq, counts = np.unique(values, return_counts=True)
    return dict(zip(uniq.tolist(), counts.tolist()))


def unique(values: np.ndarray) -> list:
    """Distinct values in order of first appearance (``drop_duplicates().tolist()``)."""
    return list(dict.fromkeys(values.tolist()))


def isin(values: np.ndarray, members: Iterable) -> np.ndarray:
    members = set(members.tolist() if isinstance(members, np.ndarray) else members)
    return np.fromiter((v in members for v in values.tolist()), bool, len(values))


def group_lists(keys: np.ndarray, values: np.ndarray) -> List[list]:
    """``groupby(keys)[values].apply(list).tolist()``: one list per key in
    sorted key order, each in row order."""
    groups: Dict = {}
    for k, v in zip(keys.tolist(), values.tolist()):
        groups.setdefault(k, []).append(v)
    return [groups[k] for k in sorted(groups)]


def regex_replace(values: np.ndarray, pattern: str, repl: str) -> np.ndarray:
    """``Series.replace(pattern, repl, regex=True)`` on a string column:
    ``re.sub`` on every string, NaN left as it is."""
    rx = re.compile(pattern)
    if values.dtype.kind != "O":
        return values
    return _objects(rx.sub(repl, v) if isinstance(v, str) else v for v in values)
