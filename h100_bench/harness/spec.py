"""Finding a cell's files by name.

A cell (an entry of ``BENCHMARK.json``'s ``workloads``) names a
configuration and a traffic mix; each lives in its own JSON file, and the
cell's engine settings and correctness limits in ``workloads/<cell>.json``.
Every metric is read by ``metrics/<metric name>.py`` and every kernel name
is mapped to its family by a file under ``kernels/``.
"""

from __future__ import annotations

import importlib.util
import json
import pathlib
import re
from typing import Any, Callable, Dict, List, Optional, Tuple

BENCH_DIR = pathlib.Path(__file__).resolve().parent.parent
REPO = BENCH_DIR.parent
BENCHMARK_JSON = REPO / "BENCHMARK.json"


def _load_json(path: pathlib.Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(path: pathlib.Path = BENCHMARK_JSON) -> Dict[str, Any]:
    return _load_json(path)


def entry(items: List[Dict[str, Any]], name: str, what: str) -> Dict[str, Any]:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(name: str, bench: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Everything one run of cell ``name`` needs: its BENCHMARK.json entry
    (``entry``), its file (``settings``: engine arguments, limits, rate),
    its configuration's file (``config``) and its traffic mix's
    (``traffic``)."""
    bench = bench if bench is not None else benchmark()
    w = entry(bench["workloads"], name, "workload")
    cfg = entry(bench["configs"], w["config"], "config")
    return {
        "name": name,
        "entry": w,
        "settings": _load_json(BENCH_DIR / "workloads" / f"{name}.json"),
        "config": _load_json(REPO / cfg["file"]),
        "traffic": _load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
    }


def metrics_of(bench: Dict[str, Any], cell_name: str, trace: bool
               ) -> List[Dict[str, Any]]:
    """The metrics a run of ``cell_name`` reports: the end-to-end metrics
    that list it (or list no cells) with ``trace`` off, the per-layer ones
    that list it with ``trace`` on (each per-layer metric lists its
    cells)."""
    if trace:
        return [m for m in bench["per_layer"] if cell_name in m["workloads"]]
    return [m for m in bench["end_to_end"]
            if cell_name in m.get("workloads", [cell_name])]


def reader(metric: str) -> Callable[[Any], Optional[float]]:
    """``read(ctx)`` of ``metrics/<metric>.py``, or, for a metric named
    ``<base>.<kind of cell>`` without a file of its own, of the shared
    ``metrics/<base>.py``."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        path = BENCH_DIR / "metrics" / f"{metric.rsplit('.', 1)[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100_bench_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_families() -> List[Tuple[str, str, "re.Pattern[str]"]]:
    """(file stem, family, compiled pattern) of every ``kernels/*.json``."""
    out = []
    for p in sorted((BENCH_DIR / "kernels").glob("*.json")):
        d = _load_json(p)
        out.append((p.stem, d["family"], re.compile(d["pattern"])))
    return out


def family_of(name: str, table) -> Tuple[str, List[str]]:
    """The one family kernel ``name`` belongs to, and the files that
    matched it: "unmapped" when none does, "ambiguous" when files of two
    families do."""
    hits = [(stem, fam) for stem, fam, pat in table if pat.search(name)]
    fams = {fam for _, fam in hits}
    if not fams:
        return "unmapped", []
    if len(fams) > 1:
        return "ambiguous", [s for s, _ in hits]
    return fams.pop(), [s for s, _ in hits]


def peaks(kind: str) -> Optional[Dict[str, Any]]:
    """The published peaks of the card named ``kind`` (``peaks.json``), or
    None for a card the table lacks."""
    return _load_json(BENCH_DIR / "peaks.json").get(kind)
