"""BENCHMARK.json against the rules its format keeps, and every file it
names."""

import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
E2E = {m["name"] for m in M["end_to_end"]}
CELLS = {w["name"] for w in M["workloads"]}


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert len(json.dumps(M)) <= 64 * 1024
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                for p in M["paths"])
    assert len(M["command"]) <= 32 and all(LINE.match(w) for w in M["command"])
    assert not any(w.startswith("/") for w in M["command"])


def test_the_check_fits_its_time_with_24_cells():
    runs = 2 + 14 * 24
    assert runs * (M["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in M[group]]
        assert len(names) == len(set(names)), group
        assert all(NAME.match(n) for n in names), group
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
    for c in M["configs"]:
        assert LINE.match(c["source"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_entry_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert LINE.match(c["why"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"])


def test_per_layer_metrics_move_a_reported_metric_in_their_cells():
    assert "setup_s" in E2E and len(E2E) >= 2
    for m in M["per_layer"]:
        assert m["moves"] in E2E and m["moves"] != "setup_s"
        moved = next(e for e in M["end_to_end"] if e["name"] == m["moves"])
        for w in m.get("workloads", CELLS):
            assert w in CELLS and w in moved.get("workloads", CELLS)
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    for w in CELLS:
        e2e = [m for m in M["end_to_end"] if w in m.get("workloads", CELLS)]
        assert {"setup_s"} < {m["name"] for m in e2e}
        assert any(w in m.get("workloads", CELLS) for m in M["per_layer"])


@pytest.mark.parametrize("w", M["workloads"], ids=lambda w: w["name"])
def test_cell_files(w):
    conf = {c["name"]: c for c in M["configs"]}[w["config"]]
    path = ROOT / conf["file"]
    assert any(conf["file"].startswith(p + "/") for p in M["paths"]) and path.is_file()
    body = json.loads(path.read_text())
    assert body["name"] == conf["name"] and body["source"] == conf["source"]
    assert (ROOT / "bench" / "reference" / f"{body['reference']}.py").is_file()
    assert (ROOT / "bench" / "traffic" / f"{w['traffic']}.json").is_file()
    limits = json.loads((ROOT / "bench" / "limits" / f"{w['name']}.json").read_text())
    assert {"loss_gap", "grad_gap", "change_gap"} <= set(limits)


def test_every_config_has_a_cell_and_its_own_file():
    used = {w["config"] for w in M["workloads"]}
    assert used == {c["name"] for c in M["configs"]}
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))


def test_four_chip_cells_within_their_share():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


def test_no_width_is_reduced():
    width = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expan|d_ff|"
                       r"d_model|top_k|experts_per")
    for c in M["configs"]:
        assert not [k for k in c["reduced"] if width.search(k)]
