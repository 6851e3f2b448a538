"""Settings of the benchmark's own tests (``python -m pytest perfbench/tests``).

The ``cuda`` marker labels tests that need the card: each of them decides
inside itself whether one is present and skips otherwise.  ``tiny_cell``
builds a cell from the CPU test sizes in ``data/`` (or a configuration in
another directory).
"""

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DATA = Path(__file__).resolve().parent / "data"


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA card; skips without one")


def tiny_cell(config_name: str, directory: Path = DATA, **traffic):
    from perfbench.core import spec
    t = json.loads((DATA / "tiny_traffic.json").read_text())
    t.update(traffic)
    return spec.Cell(
        name=config_name, config=spec.load_config(config_name, directory), traffic=t,
        limits=json.loads((DATA / "tiny_limits.json").read_text()),
        per_layer=[], end_to_end=spec.load_cell("dino_pointmae.b8").end_to_end)


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")
