"""``BENCHMARK.json`` and the files it names: every entry resolves, and every
name, unit and length keeps to the benchmark's rules."""
import json
import re

import pytest

from benchmark import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_a_full_check_of_24_cells_fits_its_time():
    per_run = BENCH["run_seconds"] + 60
    assert (2 + 14 * 24) * per_run + 24 * 2 * 90 + 1200 <= 43200


def test_entries_have_only_their_keys_and_legal_names():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in METRICS:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(CELLS)) == len(CELLS)
    assert len(set(m["name"] for m in METRICS)) == len(METRICS)
    assert all(NAME.match(n) for n in names)


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(CELLS) // 4)


def test_configs_are_files_under_paths_and_used():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for c in BENCH["configs"]:
        assert c["name"] in used and c["file"].startswith("benchmark/configs/")
        cfg = json.loads((spec.ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert (spec.ROOT / cfg["reference"]).is_file()


def test_pairs_of_config_and_traffic_appear_once():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_resolves(cell):
    from fastoptsolver_tpu_torch.batch import BatchFISTAConfig

    c = spec.cell(cell)
    BatchFISTAConfig(**c.config["solver"])
    spec.recipe(c.config)
    assert spec.driver(c.config).lanes(c.config, c.traffic) > 0
    assert set(c.limits) == {"gap_max", "gap_median", "subopt_max", "flags_off"}
    assert c.limits["flags_off"] == 0  # an exact comparison
    reported = [m["name"] for m in c.end_to_end]
    assert "setup_s" in reported and len(reported) >= 2 and len(c.per_layer) >= 1
    for m in c.end_to_end + c.per_layer:
        assert callable(spec.reader(m["name"]))


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert m["moves"] in [x["name"] for x in spec.cell(cell).end_to_end]
        layers.setdefault(m["layer"], []).append(m["name"])
    assert "device" in layers


def test_every_file_under_paths_is_named_from_legal_characters():
    for path in (spec.HERE).rglob("*"):
        if "__pycache__" in path.parts:
            continue
        rel = path.relative_to(spec.ROOT).as_posix()
        assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel
