"""``BENCHMARK.json`` and the files each of its names finds."""

import json
import re

import pytest

from perfbench.core import check, spec

MAN = spec.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    names = [c["name"] for c in MAN["configs"]] + [w["name"] for w in MAN["workloads"]] \
        + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        assert len({e["name"] for e in MAN[group]}) == len(MAN[group])
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in MAN["end_to_end"]}
    assert "setup_s" in e2e
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e
    for w in MAN["workloads"]:
        assert len(w["why"]) <= 200 and w["chips"] in (1, 4)
    # a full check of 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_every_cell_finds_its_files(cell):
    c = spec.load_cell(cell)
    assert set(c.limits) <= set(check.NUMBERS) and "score_rel" in c.limits
    assert c.traffic["size"] == c.config["xyz_size"]
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    assert {spec.base_name(n, ()) for n in names} == {"images_per_s", "latency_ms_p95",
                                                      "setup_s"}
    for m in c.per_layer:
        assert m["moves"] in names
        assert callable(spec.reader(m["name"]).read)
    for e in c.config["step"]:
        assert callable(spec.count(e["part"]).least_s_per_image)
    assert set(c.config["program_models"]) <= set(c.config["models"])
    for m in c.config["models"]:
        part = spec.model_part(m)
        assert part.ROLE in ("rgb", "xyz", "fusion") and isinstance(part.CHECKPOINT_PREFIX, str)
        assert "source" in part.NOT_WIDTHS and all(
            callable(getattr(part, f)) for f in ("leaves", "features", "load", "widths"))


def test_config_files_hold_the_published_widths():
    for entry in MAN["configs"]:
        cfg = json.loads((spec.ROOT / entry["file"]).read_text())
        assert entry["file"].startswith("perfbench/configs/")
        assert cfg["point_mae"]["trans_dim"] == 384 and cfg["point_mae"]["depth"] == 12
        assert cfg["vit"]["embed_dim"] == 768 and cfg["vit"]["depth"] == 12
        assert entry["reduced"] == cfg["reduced"] == []


def test_spans_resolve_to_port_functions():
    from perfbench.core.trace import _resolve
    for name, path in spec.spans().items():
        owner, attr = _resolve(path)
        assert callable(getattr(owner, attr)), name
