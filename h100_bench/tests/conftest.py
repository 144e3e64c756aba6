"""Paths for the benchmark's tests: the benchmark's folder (its ``harness``
and ``reference`` packages), the repository root (the program) and this
folder (``toy``)."""

import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
for p in (HERE.parent.parent, HERE.parent, HERE):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))
