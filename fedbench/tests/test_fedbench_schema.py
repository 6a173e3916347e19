"""``BENCHMARK.json`` keeps to the benchmark's contract, and every
configuration, traffic mix, limits file and per-layer reader it names is
found by file."""
import json
import re

import pytest

from fedbench_tiny import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert (ROOT / p).is_dir()
    cmd = bench["command"]
    assert 1 <= len(cmd) <= 32 and all(one_line(w) for w in cmd)
    for w in cmd[1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in bench["paths"]) and (ROOT / w).exists()
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    cells = 24
    total = (2 + 14 * cells) * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_entry_keys(bench):
    names = []
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and one_line(w["why"])
        names.append(w["name"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(m["name"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert one_line(m["layer"])
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(names) == len(set(names))


def test_cells_configs_and_metrics_fit(bench):
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in e2e["setup_s"]
    pairs = set()
    cells = [w["name"] for w in bench["workloads"]]
    assert 1 <= len(cells) <= 24
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(cells) // 4)
    for w in bench["workloads"]:
        assert w["config"] in configs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        reports = [m["name"] for m in bench["end_to_end"] if w["name"] in m.get("workloads", cells)]
        assert "setup_s" in reports and len(reports) >= 2
        assert any(w["name"] in m.get("workloads", cells) for m in bench["per_layer"])
    assert {w["config"] for w in bench["workloads"]} == set(configs)
    files = [c["file"] for c in configs.values()]
    assert len(files) == len(set(files))
    for m in bench["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells and cell in moved.get("workloads", cells)
    for m in bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= set(cells)


def test_every_named_file_is_found(bench):
    from fedbench import harness

    for c in bench["configs"]:
        assert c["file"].startswith("fedbench/configs/") and (ROOT / c["file"]).is_file()
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert (ROOT / "fedbench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert (ROOT / "fedbench" / "traffic" / f"{cell.traffic['generator']}.py").is_file()
        assert (ROOT / "fedbench" / "limits" / f"{w['name']}.json").is_file()
        assert cell.limits and all(v > 0 for v in cell.limits.values())
    for m in bench["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_config_files_hold_the_published_widths(bench):
    from fedbench.counts import shape_of

    for c in bench["configs"]:
        with open(ROOT / c["file"]) as f:
            cfg = json.load(f)
        s = shape_of(cfg)
        assert s.heads * s.head_dim == s.d and s.heads % s.kv_heads == 0
        assert cfg["torch_dtype"] == "bfloat16" and cfg["nano_adapter"]["rank"] == 64
    qwen = json.loads((ROOT / "fedbench/configs/qwen2-vl-72b-l20.json").read_text())
    assert (qwen["hidden_size"], qwen["intermediate_size"], qwen["vocab_size"]) == \
        (8192, 29568, 152064)
    assert qwen["num_hidden_layers"] == 20
    assert qwen["rope_scaling"]["mrope_section"] == [16, 24, 24]
    lm = json.loads((ROOT / "fedbench/configs/internlm2-20b.json").read_text())
    assert (lm["hidden_size"], lm["intermediate_size"], lm["vocab_size"],
            lm["num_hidden_layers"]) == (6144, 16384, 92544, 48)
