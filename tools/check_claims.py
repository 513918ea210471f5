#!/usr/bin/env python
"""Claims check: every speed figure in the docs names the card it came from.

A figure in samples/s, offsets/s, bytes/s, microseconds or milliseconds per
call, or an efficiency, in README.md / PARITY.md / docs/design.md must
stand in a paragraph that also names the card and its power limit (e.g.
"NVIDIA H100 80GB HBM3, 700 W"), so no number can outlive the machine it
was measured on.  System rates (30.72 Msps) are the radio's, not speeds of
this program, and are not matched.

Run: python tools/check_claims.py   (exit 0 = every figure is labelled).
"""

from __future__ import annotations

import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = ("README.md", "PARITY.md", os.path.join("docs", "design.md"))

_NUM = r"\d[\d,.]*\s*"
FIGURE = re.compile(
    "|".join([
        _NUM + r"(?:[kKMGT]\s*)?(?:IQ\s+)?(?:samples|offsets)\s*/\s*s",
        _NUM + r"(?:[kKMGT]\s*)?(?:sps|S/s)\b(?<!Msps)",
        _NUM + r"[kMGT]?B\s*/\s*s",
        _NUM + r"(?:µs|us)\b",
        _NUM + r"ms\s*(?:/|per)\s*(?:call|chunk|step|block|dispatch)",
        _NUM + r"%\s*(?:scaling\s+)?efficiency",
        r"efficiency\s+(?:of\s+)?" + _NUM,
        r"\b\d+(?:\.\d+)?x\s+(?:faster|the\b)",
    ]),
    re.IGNORECASE,
)
CARD = re.compile(r"H100")
POWER = re.compile(r"\b\d{3}(?:\.\d+)?\s*W\b")


def paragraphs(text: str):
    """(first line number, paragraph) pairs, split on blank lines."""
    out, buf, start = [], [], 1
    for i, line in enumerate(text.splitlines(), 1):
        if line.strip():
            if not buf:
                start = i
            buf.append(line)
        elif buf:
            out.append((start, "\n".join(buf)))
            buf = []
    if buf:
        out.append((start, "\n".join(buf)))
    return out


def check(root: str = ROOT) -> tuple[list[str], int, int]:
    """Returns (violations, paragraphs read, figures found)."""
    errors, n_par, n_fig = [], 0, 0
    for rel in DOCS:
        path = os.path.join(root, rel)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            text = f.read()
        for line, par in paragraphs(text):
            n_par += 1
            figs = [m.group(0).strip() for m in FIGURE.finditer(par)]
            n_fig += len(figs)
            if figs and not (CARD.search(par) and POWER.search(par)):
                errors.append(
                    f"{rel}:{line}: {figs} without the card's name and "
                    "power limit in the same paragraph"
                )
    return errors, n_par, n_fig


def main() -> int:
    errors, n_par, n_fig = check()
    for e in errors:
        print(e)
    print(f"claims checked: {n_par} paragraphs, {n_fig} speed figures, "
          f"{len(errors)} unlabelled")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
