"""Finds every part of a cell by the names in ``BENCHMARK.json``.

Nothing here knows a cell, a configuration, a traffic mix or a metric by
name: a configuration is ``configs`` entry's ``file``, its plain reference
the module at the configuration's ``reference`` path, a traffic mix is
``traffic/<mix>.json``, its loop ``loops/<loop>.py``, a per-layer
metric's reader ``metrics/<metric>.py`` and a kernel's counts
``counts/<kernel>.py``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType

PERFBENCH = Path(__file__).resolve().parent.parent
ROOT = PERFBENCH.parent


def load_benchmark(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            with open(root / c["file"]) as f:
                return json.load(f)
    raise SystemExit(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    with open(PERFBENCH / "traffic" / f"{name}.json") as f:
        return json.load(f)


def applies(metric: dict, cell_name: str) -> bool:
    """Whether ``metric`` is reported in the cell ``cell_name``."""
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> list:
    return [m for m in bench["end_to_end"] if applies(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> list:
    return [m for m in bench["per_layer"] if applies(m, cell_name)]


def _load(path: Path, tag: str) -> ModuleType:
    if not path.exists():
        shown = path.relative_to(ROOT) if path.is_relative_to(ROOT) else path
        raise SystemExit(f"missing {shown}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{tag}_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def loop(name: str) -> ModuleType:
    return _load(PERFBENCH / "loops" / f"{name}.py", "loop")


def metric_reader(name: str) -> ModuleType:
    return _load(PERFBENCH / "metrics" / f"{name}.py", "metric")


def counts(kernel: str) -> ModuleType:
    return _load(PERFBENCH / "counts" / f"{kernel}.py", "counts")


def reference(cfg: dict) -> ModuleType:
    """The plain reference at the configuration's ``reference`` path
    (relative to the checkout's root, or absolute), with ``METHODS`` as
    ``harness/check.py`` says."""
    return _load(ROOT / cfg["reference"], "reference")
