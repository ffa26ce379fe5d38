"""Seconds a test file takes, from pytest's junit XML, across runs.

    python3 tools/test_file_seconds.py [--case=NAME ...] LABEL=RUN.xml \
        [LABEL=RUN.xml ...]

Each XML is one run of the tier-1 command (``--junitxml``; with ``-n 6
--dist loadfile`` a file runs on one worker, so the sum of its cases'
times is its share of that worker).  Runs of one tree share a label's
part before `` (``, as ``parent (1)`` and ``parent (2)``, and a tree's
seconds are the mean over its runs.  Prints a markdown table: the TOP
slowest files by the mean over every run and every file whose mean grew
by more than GREW from the first tree to the second, with each run's
seconds, then the sum over files, the sum over the port's files
(``tests/test_torch_*.py``), each run's wall seconds (the test suite's
``time``) and the seconds of each case whose id (``file::name[params]``)
contains a ``--case`` NAME.  Needs neither JAX nor a GPU.
"""

from __future__ import annotations

import sys
import xml.etree.ElementTree as ET
from collections import defaultdict

TOP, GREW = 10, 10.0


def file_seconds(path: str):
    """``({file: seconds}, wall seconds, {case id: seconds})`` of one junit
    XML."""
    suite = ET.parse(path).getroot().find("testsuite")
    out, cases = defaultdict(float), {}
    for case in suite.iter("testcase"):
        module = case.get("classname", "").split(".")
        name = "/".join(module[:2]) + ".py" if len(module) > 1 else "?"
        out[name] += float(case.get("time", 0.0))
        cases[f"{name}::{case.get('name')}"] = float(case.get("time", 0.0))
    return dict(out), float(suite.get("time")), cases


def main(argv=None) -> str:
    args = argv or sys.argv[1:]
    wanted = [a.split("=", 1)[1] for a in args if a.startswith("--case=")]
    runs = [a.split("=", 1) for a in args if not a.startswith("--case=")]
    got = {label: file_seconds(path) for label, path in runs}
    labels = [label for label, _ in runs]
    trees: dict = {}
    for label in labels:
        trees.setdefault(label.split(" (")[0], []).append(label)

    def mean(group, f):
        return sum(got[lb][0].get(f, 0.0) for lb in group) / len(group)

    files = set().union(*(got[lb][0] for lb in labels))
    rows = set(sorted(files, key=lambda f: -mean(labels, f))[:TOP])
    first, second = list(trees.values())[:2]
    rows |= {f for f in files if mean(second, f) - mean(first, f) > GREW}
    lines = ["| file | " + " | ".join(labels) + " |",
             "|---|" + "---:|" * len(labels)]
    for f in sorted(rows, key=lambda f: -mean(labels, f)):
        cells = [f"{got[lb][0].get(f, 0.0):.1f}" for lb in labels]
        lines.append(f"| `{f}` | " + " | ".join(cells) + " |")
    lines.append("| sum over files | " + " | ".join(
        f"{sum(got[lb][0].values()):.1f}" for lb in labels) + " |")
    port = [sum(v for f, v in got[lb][0].items()
                if f.startswith("tests/test_torch_")) for lb in labels]
    lines.append("| sum over `tests/test_torch_*.py` | " + " | ".join(
        f"{v:.1f}" for v in port) + " |")
    lines.append("| wall (suite `time`) | " + " | ".join(
        f"{got[lb][1]:.1f}" for lb in labels) + " |")
    ids = sorted({c for lb in labels for c in got[lb][2]
                  if any(w in c for w in wanted)})
    for c in ids:
        lines.append(f"| `{c}` | " + " | ".join(
            f"{got[lb][2][c]:.1f}" if c in got[lb][2] else "—"
            for lb in labels) + " |")
    text = "\n".join(lines)
    print(text)
    return text


if __name__ == "__main__":
    main()
