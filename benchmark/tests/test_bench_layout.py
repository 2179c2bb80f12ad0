"""``BENCHMARK.json`` and the files it finds by name: every cell,
configuration, traffic, metric and entry file loads and names files that
exist; each per-layer metric moves an end-to-end metric that every cell it
reports in reports; names, units and texts keep to the contract's alphabet
and lengths."""

import importlib
import importlib.util
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]


def one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def load(path: Path):
    spec = importlib.util.spec_from_file_location(f"probe_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][:2] == ["python3", "-m"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cfg", SPEC["configs"], ids=lambda c: c["name"])
def test_configuration(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"]) and one_line(cfg["source"]) and one_line(cfg["why"])
    assert cfg["file"].startswith("benchmark/configs/")
    data = json.loads((ROOT / cfg["file"]).read_text())
    assert data["name"] == cfg["name"] and data["reduced"] == cfg["reduced"] == []
    importlib.import_module(f"benchmark.entries.{data['entry']}")
    assert data["control"]["scaling_mod_size"] < data["scaling_mod_size"]
    assert sum(c["file"] == cfg["file"] for c in SPEC["configs"]) == 1
    assert any(w["config"] == cfg["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"]) and one_line(cell["why"])
    assert cell["chips"] == 1
    assert cell["config"] in [c["name"] for c in SPEC["configs"]]
    traffic = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json").read_text())
    assert traffic["lazy"] in (0, 4) and traffic["input_sets"] >= 1
    plan = json.loads((BENCH / "workloads" / f"{cell['name']}.json").read_text())
    assert set(plan["limits"]) == {"max_err", "limb_mismatch", "scale_gap"}
    assert plan["limits"]["limb_mismatch"] == 0 and plan["limits"]["scale_gap"] == 0
    assert plan["check_rounds"] >= 1 and plan["spans"] >= 1 and plan["span_rounds"] >= 1
    assert sum((w["config"], w["traffic"]) == (cell["config"], cell["traffic"])
               for w in SPEC["workloads"]) == 1


@pytest.mark.parametrize("kind", ["end_to_end", "per_layer"])
def test_metrics(kind):
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC[kind]:
        keys = {"name", "unit", "better", "source"} | (
            {"bound"} if kind == "end_to_end" else {"layer", "moves"})
        assert set(m) - {"workloads"} == keys, m["name"]
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                   "higher")
        assert callable(load(BENCH / "metrics" / f"{m['name']}.py").read)
        if kind == "end_to_end":
            assert m["source"] in ("host_clock", "device_trace")
            assert 0.01 <= m["bound"] <= 0.25
        else:
            assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
            assert one_line(m["layer"]) and m["moves"] in e2e
            for cell in m.get("workloads", CELLS):
                moved = next(x for x in SPEC["end_to_end"] if x["name"] == m["moves"])
                assert cell in moved.get("workloads", CELLS)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    names = [m["name"] for k in ("end_to_end", "per_layer") for m in SPEC[k]]
    assert len(names) == len(set(names))


def test_every_cell_reports_enough():
    for cell in CELLS:
        e2e = [m["name"] for m in SPEC["end_to_end"] if cell in m.get("workloads", CELLS)]
        layer = [m for m in SPEC["per_layer"] if cell in m.get("workloads", CELLS)]
        assert "setup_s" in e2e and len(e2e) >= 2 and layer


def test_files_under_paths_use_name_characters():
    for path in BENCH.rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = str(path.relative_to(ROOT))
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
