"""BENCHMARK.json against the contract's shape, and every part of every
cell found by its name."""

import json
import re

from perfbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def bench():
    return manifest.load_benchmark()


def test_top_level_keys():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= len(b["paths"]) <= 16
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    raw = (manifest.ROOT / "BENCHMARK.json").read_bytes()
    assert len(raw) <= 64 * 1024


def test_names_and_units():
    b = bench()
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in b[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e:
                    assert 1 <= len(e[k]) <= 200 and "\n" not in e[k] \
                        and "\t" not in e[k]
    assert len(names) == len(set(names))
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    assert len({(w["config"], w["traffic"]) for w in b["workloads"]}) == \
        len(b["workloads"])


def test_entry_keys():
    b = bench()
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert len(c["reduced"]) <= 16
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_every_cell_reports_what_it_must():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for w in b["workloads"]:
        mine = [m["name"] for m in manifest.end_to_end(b, w["name"])]
        assert "setup_s" in mine and len(mine) >= 2
        layers = manifest.per_layer(b, w["name"])
        assert layers
        for m in layers:
            assert m["moves"] in mine, (w["name"], m["name"])
    for m in b["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        for cell in m.get("workloads", []):
            assert cell in {w["name"] for w in b["workloads"]}
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


def test_parts_found_by_name():
    b = bench()
    for c in b["configs"]:
        cfg = manifest.config(b, c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert (manifest.ROOT / cfg["reference"]).exists()
        assert isinstance(manifest.reference(cfg).METHODS, dict)
    for w in b["workloads"]:
        t = manifest.traffic(w["traffic"])
        ref = manifest.reference(manifest.config(b, w["config"]))
        assert t["method"] in ref.METHODS, (w["name"], t["method"])
        drv = manifest.loop(t["loop"])
        for fn in ("inputs", "setup", "window", "answers", "work"):
            assert callable(getattr(drv, fn)), (t["loop"], fn)
        assert 0 < t["limits"]["worst_mismatch_share"] < 1
    for m in b["per_layer"]:
        assert callable(manifest.metric_reader(m["name"]).read)
    for k in ("lut_hist", "forest_labels", "ccmin_prop", "step"):
        assert callable(manifest.counts(k).count)


def test_files_under_paths_are_named_from_name_characters():
    for p in (manifest.ROOT / "perfbench").rglob("*"):
        if p.is_file() and "__pycache__" not in p.parts:
            rel = p.relative_to(manifest.ROOT).as_posix()
            assert PATH.match(rel), rel
            json.dumps(rel)
