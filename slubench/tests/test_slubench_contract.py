"""BENCHMARK.json against the benchmark's contract: its keys, names and
limits, and that each cell's files are found by name."""

import json
import os
import re

import pytest

from slubench.cell import HERE, ROOT, load_benchmark, load_cell

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = load_benchmark()


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["slubench"] and BENCH["command"][:2] == ["python3", "-m"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_entries_keep_to_their_keys_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for group, want in keys.items():
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        for e in BENCH[group]:
            assert set(e) - {"workloads"} == want, e["name"]
            assert NAME.match(e["name"])
            for text in ("why", "layer", "source"):
                if text in e:
                    assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_is_found_by_name_and_reports_enough(w):
    cell = load_cell(BENCH, w["name"])
    assert w["chips"] == 1 and cell.limits and os.path.isfile(os.path.join(HERE, "traffic", f"{w['traffic']}.json"))
    assert os.path.isfile(os.path.join(HERE, "drivers", f"{cell.mix['driver']}.py"))
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names


def test_configs_keep_their_published_widths():
    for c in BENCH["configs"]:
        assert c["file"].startswith("slubench/configs/") and c["reduced"] == []
        with open(os.path.join(ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["name"] == c["name"] and conf["reduced"] == []
        pm, wm = conf["cfg"]["phoneme_module"], conf["cfg"]["word_module"]
        assert (pm["cnn_n_filt"], pm["cnn_len_filt"], pm["cnn_stride"]) == ("80,60,60", "401,5,5", "80,1,1")
        assert pm["phone_rnn_num_hidden"] == wm["word_rnn_num_hidden"] == "128,128"
        assert wm["vocabulary_size"] == "10000"
