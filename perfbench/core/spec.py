"""Cells, configurations, traffic, limits, spans and readers, found by name.

A cell is an entry of ``workloads`` in ``BENCHMARK.json``; its
configuration is ``perfbench/configs/<config>.json``, its traffic
``perfbench/traffic/<traffic>.json`` and the limits of its check
``perfbench/limits/<cell>.json``.  A per-layer metric ``m`` is read by
``perfbench/layer_metrics/<m>.py`` (a metric split by cells, ``<m>.<split>``,
by its base's file when it has none of its own), a model part's counts live in
``perfbench/counts/<part>.py``, and a model that a configuration lists in
``models`` is ``perfbench/model_parts/<model>.py`` (its weights, plain
reference, loading into the port and widths).  Adding a cell, a
configuration, a metric, a count or a model part is adding files: nothing
here names one.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    per_layer: List[dict]      # BENCHMARK.json's per_layer metrics this cell reports
    end_to_end: List[dict]


def manifest(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def metric_applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files."""
    man = manifest(root)
    entry = next((w for w in man["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{[w['name'] for w in man['workloads']]}")
    return Cell(
        name=name,
        config=load_config(entry["config"]),
        traffic=_json(BENCH_DIR / "traffic" / f"{entry['traffic']}.json"),
        limits=_json(BENCH_DIR / "limits" / f"{name}.json"),
        per_layer=[m for m in man["per_layer"] if metric_applies(m, name)],
        end_to_end=[m for m in man["end_to_end"] if metric_applies(m, name)])


def load_config(name: str, directory: Optional[Path] = None) -> dict:
    """A configuration; the RGB image's side ``rgb_size`` defaults to the
    cloud's ``xyz_size``."""
    cfg = _json((directory or BENCH_DIR / "configs") / f"{name}.json")
    cfg.setdefault("name", name)
    cfg.setdefault("rgb_size", cfg["xyz_size"])
    return cfg


def spans(path: Path = BENCH_DIR / "spans.json") -> Dict[str, str]:
    """span name -> dotted path of the port function the traced run wraps."""
    return _json(path)


def load_module(path: Path) -> ModuleType:
    """Import a file by its path (reader names hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str) -> ModuleType:
    """The reader of ``metric``: ``layer_metrics/<metric>.py``, or, for a
    metric split by cells (``<base>.<split>``) that has no file of its
    own, its base's reader."""
    path = BENCH_DIR / "layer_metrics" / f"{metric}.py"
    if not path.exists() and "." in metric:
        return reader(metric.rsplit(".", 1)[0])
    return load_module(path)


def base_name(metric: str, known) -> str:
    """The quantity a possibly split end-to-end metric names: itself when
    ``known`` holds it, else its name without the last dotted part."""
    return metric if metric in known or "." not in metric else metric.rsplit(".", 1)[0]


def count(part: str) -> ModuleType:
    return importlib.import_module(f"perfbench.counts.{part}")


def model_part(model: str) -> ModuleType:
    """The model part ``perfbench/model_parts/<model>.py``
    (``perfbench/model_parts/__init__.py`` gives what it holds)."""
    return importlib.import_module(f"perfbench.model_parts.{model}")
