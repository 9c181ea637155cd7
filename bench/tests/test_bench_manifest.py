"""The manifest keeps to the contract, and every cell's files are found by
name; a new configuration, mix and metric need no edit of a file there."""
from __future__ import annotations

import hashlib
import json
import re

import pytest

from conftest import ROOT, copy_bench, shrink

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in MAN["workloads"]]


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert MAN["paths"] == ["bench"]
    assert MAN["command"] == ["python3", "bench/run.py"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_units_and_lines(section):
    entries = MAN[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert LINE.match(e[key]), (e["name"], key)
        for r in e.get("reduced", []):
            assert NAME.match(r) and not r.endswith(("_dim", "_rank"))


def test_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in MAN["end_to_end"]}
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    w = next(x for x in MAN["workloads"] if x["name"] == cell)
    cfg = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert (ROOT / cfg["file"]).is_file()
    assert cfg["file"].startswith("bench/configs/")
    mix = json.loads((ROOT / "bench" / "traffic"
                      / f"{w['traffic']}.json").read_text())
    assert (ROOT / "bench" / "loops" / f"{mix['loop']}.py").is_file()
    for part, spec in mix.get("updates", {}).items():
        assert (ROOT / "bench" / "draws" / part
                / f"{spec['draw']}.py").is_file()
    assert (ROOT / "bench" / "limits" / f"{cell}.json").is_file()
    reports = {k: [m for m in MAN[k] if cell in m.get("workloads", [cell])]
               for k in ("end_to_end", "per_layer")}
    assert "setup_s" in {m["name"] for m in reports["end_to_end"]}
    assert len(reports["end_to_end"]) >= 2 and reports["per_layer"]
    for k in reports:
        for m in reports[k]:
            assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").is_file()
    e2e = {m["name"] for m in reports["end_to_end"]}
    for m in reports["per_layer"]:
        assert m["moves"] in e2e


def test_each_config_used_and_files_distinct():
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}
    files = [c["file"] for c in MAN["configs"]]
    assert len(files) == len(set(files))
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_a_new_config_mix_and_metric_need_no_edit(tmp_path):
    """A throwaway configuration, mix, cell and metric, added as files and
    entries to a copy, run without an edit of any file that is there."""
    from bench import harness
    root = copy_bench(tmp_path)
    shrink(root)
    before = _digests(root)
    b = root / "bench"
    cfg = json.loads((b / "configs" / "sift128.json").read_text())
    cfg.update(d=8)
    (b / "configs" / "toy8.json").write_text(json.dumps(cfg))
    mix = json.loads((b / "traffic" / "search.json").read_text())
    mix.update(batch=32, pool_batches=2)
    (b / "traffic" / "small_batches.json").write_text(json.dumps(mix))
    (b / "limits" / "toy8-small_batches.json").write_text(
        (b / "limits" / "sift128-search.json").read_text())
    (b / "metrics" / "batches_in_window.toy.py").write_text(
        "def read(obs):\n    return float(obs.window['batches'])\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "toy8", "source": "https://example.org",
                           "file": "bench/configs/toy8.json",
                           "reduced": [], "why": "a throwaway"})
    man["workloads"].append({"name": "toy8-small_batches", "config": "toy8",
                             "traffic": "small_batches", "chips": 1,
                             "why": "a throwaway"})
    man["end_to_end"].append({"name": "batches_in_window.toy",
                              "unit": "count", "better": "higher",
                              "bound": 0.1, "source": "host_clock",
                              "workloads": ["toy8-small_batches"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    line = harness.run_cell(root, "toy8-small_batches", 3, 0.5, False,
                            "cpu", log=lambda m: None)
    assert line["correct"], line["checks"]
    assert line["metrics"]["batches_in_window.toy"]["value"] >= 1
    after = _digests(root)
    changed = [p for p, h in before.items() if after.get(p) != h]
    assert changed == [type(next(iter(before)))("BENCHMARK.json")]


NEW_LOOP = '''"""A new loop: the closed loop, each batch sent twice in a row."""
from pathlib import Path

from bench.common import load_file

Closed = load_file(Path(__file__).resolve().parents[2], "loops",
                   "closed").Loop


class Loop(Closed):
    def batch(self, i):
        return super().batch(i // 2)
'''

HOT_LABELS = '''"""A new label draw: half the updates hit the first place."""


def pick(rng, live, params):
    if rng.random() < params["hot"]:
        return 0
    return int(rng.integers(len(live)))
'''


def test_a_new_loop_and_update_draw_need_no_edit(tmp_path):
    """Mixes whose loop and whose update labels are new files, added with
    their cells to a copy, run without an edit of any file that is there."""
    from bench import harness
    root = copy_bench(tmp_path)
    shrink(root)
    before = _digests(root)
    b = root / "bench"
    (b / "loops" / "twice.py").write_text(NEW_LOOP)
    (b / "draws" / "labels" / "hot.py").write_text(HOT_LABELS)
    mix = json.loads((b / "traffic" / "search.json").read_text())
    mix["loop"] = "twice"
    (b / "traffic" / "twice.json").write_text(json.dumps(mix))
    mix = json.loads((b / "traffic" / "churn.json").read_text())
    mix["updates"]["labels"] = {"draw": "hot", "hot": 0.5}
    (b / "traffic" / "churn_hot.json").write_text(json.dumps(mix))
    man = json.loads((root / "BENCHMARK.json").read_text())
    for cell, src in (("sift128-twice", "sift128-search"),
                      ("sift128-churn_hot", "sift128-churn")):
        (b / "limits" / f"{cell}.json").write_text(
            (b / "limits" / f"{src}.json").read_text())
        man["workloads"].append({"name": cell, "config": "sift128",
                                 "traffic": cell.split("-")[1], "chips": 1,
                                 "why": "a throwaway"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    for cell in ("sift128-twice", "sift128-churn_hot"):
        line = harness.run_cell(root, cell, 11, 0.5, False, "cpu",
                                log=lambda m: None)
        assert line["correct"], (cell, line["checks"])
        assert line["attempted"] > 0
    after = _digests(root)
    changed = [p for p, h in before.items() if after.get(p) != h]
    assert changed == [type(next(iter(before)))("BENCHMARK.json")]
