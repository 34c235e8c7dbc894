"""Minimal Praat TextGrid reader and writer (long and short text formats).

The port's own copy of ``tpu_slu/data/textgrid.py``: it reads the
Montreal-Forced-Aligner alignments of LibriSpeech (interval tiers; point
tiers are skipped) and writes long-format files.
"""

from __future__ import annotations

import dataclasses
import re


@dataclasses.dataclass
class Interval:
    minTime: float
    maxTime: float
    mark: str


@dataclasses.dataclass
class Tier:
    name: str
    intervals: list[Interval]

    def __iter__(self):
        return iter(self.intervals)


_QUOTED = re.compile(r'"((?:[^"]|"")*)"')
_NUM = re.compile(r"-?\d+(?:\.\d+)?(?:[eE][-+]?\d+)?")


def read_textgrid(path: str) -> dict[str, Tier]:
    """Parse a TextGrid file -> {tier_name: Tier}."""
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        text = f.read()
    # Long-format index decorations ("item [1]:", "intervals [2]:") would
    # otherwise tokenize as numbers; short format has no brackets.
    text = re.sub(r"\[\s*\d*\s*\]", "", text)

    # Tokenize: quoted strings and numbers, in order. Works for both the
    # long ("key = value" per line) and short (bare values) formats because
    # the value sequence is identical.
    tokens: list[tuple[str, object]] = []
    i = 0
    n = len(text)
    while i < n:
        c = text[i]
        if c == '"':
            m = _QUOTED.match(text, i)
            if not m:
                i += 1
                continue
            tokens.append(("s", m.group(1).replace('""', '"')))
            i = m.end()
        elif c.isdigit() or (c == "-" and i + 1 < n and text[i + 1].isdigit()):
            m = _NUM.match(text, i)
            tokens.append(("n", float(m.group(0))))
            i = m.end()
        else:
            i += 1

    # Expected prefix: "ooTextFile", "TextGrid", xmin, xmax, [tiers flag
    # swallowed as text in long format], size, then per tier:
    # "IntervalTier", name, xmin, xmax, n_intervals, then triples.
    pos = 0

    def next_of(kind):
        nonlocal pos
        while pos < len(tokens) and tokens[pos][0] != kind:
            pos += 1
        if pos >= len(tokens):
            raise ValueError(f"{path}: truncated TextGrid")
        val = tokens[pos][1]
        pos += 1
        return val

    next_of("s")  # ooTextFile
    next_of("s")  # TextGrid
    next_of("n")  # global xmin
    next_of("n")  # global xmax
    num_tiers = int(next_of("n"))

    tiers: dict[str, Tier] = {}
    for _ in range(num_tiers):
        klass = next_of("s")
        name = next_of("s")
        next_of("n")  # tier xmin
        next_of("n")  # tier xmax
        count = int(next_of("n"))
        intervals = []
        if klass == "IntervalTier":
            for _ in range(count):
                xmin = next_of("n")
                xmax = next_of("n")
                mark = next_of("s")
                intervals.append(Interval(xmin, xmax, mark))
        else:  # TextTier/points — skip (time, mark) pairs
            for _ in range(count):
                next_of("n")
                next_of("s")
        tiers[name] = Tier(name, intervals)
    return tiers


def write_textgrid(path: str, tiers: dict[str, list[tuple[float, float, str]]], xmax: float):
    """Write a long-format TextGrid of interval tiers ``{name: [(xmin, xmax, mark)]}``."""
    lines = [
        'File type = "ooTextFile"',
        'Object class = "TextGrid"',
        "",
        "xmin = 0",
        f"xmax = {xmax}",
        "tiers? <exists>",
        f"size = {len(tiers)}",
        "item []:",
    ]
    for t_i, (name, intervals) in enumerate(tiers.items(), 1):
        lines += [
            f"    item [{t_i}]:",
            '        class = "IntervalTier"',
            f'        name = "{name}"',
            "        xmin = 0",
            f"        xmax = {xmax}",
            f"        intervals: size = {len(intervals)}",
        ]
        for i_i, (xmin, xmx, mark) in enumerate(intervals, 1):
            lines += [
                f"        intervals [{i_i}]:",
                f"            xmin = {xmin}",
                f"            xmax = {xmx}",
                f'            text = "{mark}"',
            ]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
