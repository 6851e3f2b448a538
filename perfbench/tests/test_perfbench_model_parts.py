"""A model part is files.  A copy of the ``vit`` part under a name that no
harness file names, and a configuration that uses it with an RGB image of
another side than the cloud's, both written to a temporary directory, run
a whole cell at the CPU test size (the look for a card skipped): the
program reads correct and its bfloat16 control does not.  A configuration
whose part block states a width the program does not run fails the shape
check."""

import json
import shutil
import sys

import pytest
import torch

import perfbench.model_parts
from conftest import DATA, tiny_cell
from perfbench.core import cell, spec

torch.set_num_threads(4)
PART = "vit_files_only"
RGB_SIZE = 80           # the cloud stays 64 wide; the tiny ViT sees 10 x 10 patches
SEED = 2 ** 31 + 1601


@pytest.fixture
def files(tmp_path, monkeypatch):
    """The part file and the configuration ``tiny_files`` in ``tmp_path``;
    returns a function that writes the configuration with one change."""
    shutil.copy(spec.BENCH_DIR / "model_parts" / "vit.py", tmp_path / f"{PART}.py")
    monkeypatch.setattr(perfbench.model_parts, "__path__",
                        [str(tmp_path), *perfbench.model_parts.__path__])
    yield _writer(tmp_path)
    sys.modules.pop(f"perfbench.model_parts.{PART}", None)


def _writer(directory):
    def write(**block):
        cfg = json.loads((DATA / "tiny_dual.json").read_text())
        cfg["models"] = cfg["program_models"] = [PART, "point_mae"]
        cfg[PART] = {**cfg.pop("vit"), "img_size": RGB_SIZE, **block}
        cfg["rgb_size"] = cfg["overrides"]["rgb_size"] = RGB_SIZE
        cfg["banks"]["rgb"]["queries"] = (RGB_SIZE // 8) ** 2
        cfg["step"][0]["of"] = PART
        (directory / "tiny_files.json").write_text(json.dumps(cfg))
        return tiny_cell("tiny_files", directory)
    return write


def test_a_new_part_and_an_rgb_side_of_its_own_run_correct(files):
    c = files()
    assert c.config["rgb_size"] != c.traffic["size"]
    r = cell.run(c, SEED, 0.5, False, "cpu")
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    control = cell.run(c, SEED, 0.5, False, "cpu", overrides={"compute_dtype": "bfloat16"})
    assert not control["correct"]
    assert max(v["value"] / v["limit"] for v in control["checks"].values()) > 3


@pytest.mark.parametrize("block", [{"num_reg_tokens": 4}, {"layer_scale": True},
                                   {"embed_dim": 48}, {"patch_sizes": 8}],
                         ids=["registers", "layer_scale", "embed_dim", "unknown_key"])
def test_a_width_the_program_does_not_run_fails_the_shape_check(files, block):
    with pytest.raises(ValueError, match="other sizes than the configuration"):
        cell.run(files(**block), SEED, 0.5, False, "cpu")
