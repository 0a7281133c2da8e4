"""Minimal Praat TextGrid parser (no external deps; counterpart of
mdd_tpu/data/textgrid.py).

Replaces the `textgrid` PyPI dependency the reference prep uses
(egs/attention_aug/local/l2arctic_prep.py:4,57-59).  Supports both the
long ("ooTextFile" with `item [n]:` blocks) and short formats, interval
tiers and point tiers; only what L2-ARCTIC annotation/arpa_textgrid
files need plus a little robustness.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Iterator, List


@dataclass
class Interval:
    minTime: float
    maxTime: float
    mark: str


@dataclass
class IntervalTier:
    name: str
    intervals: List[Interval] = field(default_factory=list)

    def __iter__(self) -> Iterator[Interval]:
        return iter(self.intervals)

    def __len__(self) -> int:
        return len(self.intervals)

    def __getitem__(self, i: int) -> Interval:
        return self.intervals[i]


@dataclass
class TextGrid:
    tiers: List[IntervalTier] = field(default_factory=list)

    def __iter__(self) -> Iterator[IntervalTier]:
        return iter(self.tiers)

    def __len__(self) -> int:
        return len(self.tiers)

    def __getitem__(self, i: int) -> IntervalTier:
        return self.tiers[i]

    def get_tier_by_name(self, name: str) -> IntervalTier:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(name)

    @classmethod
    def fromFile(cls, path: str) -> "TextGrid":
        with open(path, "r", encoding="utf-8", errors="replace") as f:
            text = f.read()
        return cls.parse(text)

    @classmethod
    def parse(cls, text: str) -> "TextGrid":
        if _is_long_format(text):
            return _parse_long(text)
        return _parse_short(text)


_QUOTED = re.compile(r'"((?:[^"]|"")*)"')
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def _unquote(s: str) -> str:
    return s.replace('""', '"')


def _is_long_format(text: str) -> bool:
    # Both formats share the two `File type/Object class = "..."` header
    # lines; only the long format also spells out `xmin = ...` fields.
    return bool(re.search(r"^\s*xmin\s*=", text, re.M))


def _parse_long(text: str) -> TextGrid:
    tg = TextGrid()
    tier: IntervalTier | None = None
    cur: dict = {}
    in_points = False
    for raw in text.splitlines():
        line = raw.strip()
        if line.startswith("class"):
            m = _QUOTED.search(line)
            klass = _unquote(m.group(1)) if m else ""
            in_points = klass == "TextTier"
            tier = IntervalTier(name="")
            tg.tiers.append(tier)
        elif line.startswith("name") and "=" in line and tier is not None:
            m = _QUOTED.search(line)
            tier.name = _unquote(m.group(1)) if m else ""
        elif line.startswith(("intervals [", "points [")):
            cur = {}
        elif line.startswith(("xmin", "number")) and "=" in line:
            m = _NUM.search(line.split("=", 1)[1])
            if m:
                cur["xmin"] = float(m.group(0))
        elif line.startswith("xmax") and "=" in line:
            m = _NUM.search(line.split("=", 1)[1])
            if m:
                cur["xmax"] = float(m.group(0))
        elif line.startswith(("text", "mark")) and "=" in line and tier is not None:
            m = _QUOTED.search(line.split("=", 1)[1])
            mark = _unquote(m.group(1)) if m else ""
            if "xmin" in cur:
                xmax = cur.get("xmax", cur["xmin"]) if in_points else cur.get("xmax", cur["xmin"])
                tier.intervals.append(Interval(cur["xmin"], xmax, mark))
            cur = {}
    return tg


def _parse_short(text: str) -> TextGrid:
    """Short format: a flat stream of values, one per line."""
    lines = [l.strip() for l in text.splitlines() if l.strip() != ""]
    # header: "ooTextFile", "TextGrid", xmin, xmax, <exists>, size
    idx = 0

    def next_line() -> str:
        nonlocal idx
        v = lines[idx]
        idx += 1
        return v

    next_line()  # File type
    next_line()  # Object class
    next_line()  # xmin
    next_line()  # xmax
    flag = next_line()
    if flag.startswith("<"):
        n_tiers = int(next_line())
    else:
        n_tiers = int(flag)
    tg = TextGrid()
    for _ in range(n_tiers):
        klass = _unquote(_QUOTED.search(next_line()).group(1))
        name = _unquote(_QUOTED.search(next_line()).group(1))
        next_line()  # tier xmin
        next_line()  # tier xmax
        n = int(next_line())
        tier = IntervalTier(name=name)
        for _ in range(n):
            if klass == "TextTier":
                t = float(next_line())
                mark = _unquote(_QUOTED.search(next_line()).group(1))
                tier.intervals.append(Interval(t, t, mark))
            else:
                a = float(next_line())
                b = float(next_line())
                mark = _unquote(_QUOTED.search(next_line()).group(1))
                tier.intervals.append(Interval(a, b, mark))
        tg.tiers.append(tier)
    return tg
