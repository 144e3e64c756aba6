"""BENCHMARK.json against the benchmark contract's shape rules, and every
file it names present."""

import json
import re

from harness import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
B = spec.benchmark()


def test_top_level_keys_and_limits():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["h100_bench"]
    assert B["command"] == ["python3", "h100_bench/run.py"]
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert len(json.dumps(B)) <= 64 * 1024
    runs = 2 + 14 * 24
    assert runs * (B["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entries():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves", "workloads"})):
        for e in B[group]:
            assert set(e) <= keys, (group, e)
            assert NAME.match(e["name"]), e["name"]
            assert e["name"] not in seen
            seen.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                                 "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]
    cells = {w["name"]: w for w in B["workloads"]}
    assert sum(w["chips"] == 4 for w in cells.values()) <= max(
        1, len(cells) // 4)
    assert {w["config"] for w in cells.values()} == {c["name"] for c in
                                                     B["configs"]}
    e2e = {m["name"]: m for m in B["end_to_end"]}
    assert "setup_s" in e2e
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        assert m["workloads"], m["name"]  # every per-layer metric lists them
        for c in m["workloads"]:
            assert c in e2e[m["moves"]].get("workloads", cells)
        if m["name"].startswith("roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in cells:
        got = spec.metrics_of(B, c, False)
        assert "setup_s" in {m["name"] for m in got} and len(got) >= 2
        assert spec.metrics_of(B, c, True)


def test_every_named_file_exists_and_every_metric_has_a_reader():
    for c in B["workloads"]:
        cell = spec.cell(c["name"], B)
        assert cell["settings"]["limits"]["max_gap_nats"] > 0
        assert cell["settings"]["limits"]["mean_gap_nats"] > 0
        assert set(cell["settings"]["engine"]) <= {"max_batch", "max_len",
                                                   "paged", "block_size"}
    for cfg in B["configs"]:
        d = json.loads((spec.REPO / cfg["file"]).read_text())
        assert d["source"] == cfg["source"]
        for k in cfg["reduced"]:
            assert NAME.match(k)
    for m in B["end_to_end"] + B["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_a_kind_of_cell_reads_through_the_shared_reader(tmp_path):
    """``tick_ms.closed`` has no file of its own: ``metrics/tick_ms.py``
    reads it, as it would a later ``tick_ms.open``."""
    assert not (spec.BENCH_DIR / "metrics" / "tick_ms.closed.py").exists()
    assert spec.reader("tick_ms.closed").__module__ == spec.reader(
        "tick_ms.open").__module__
    assert callable(spec.reader("ttft_p90_s"))
