"""Whole runs of a cell at the CPU test size, with the harness's look for a
card skipped: the result line's keys, the check passing on the program,
and failing on its control and on each fault the cells can have."""

import numpy as np
import pytest
import torch

from conftest import tiny_cell
from perfbench.core import cell

torch.set_num_threads(4)
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def _run(name="tiny_dual", overrides=None, seed=2 ** 31 + 99):
    return cell.run(tiny_cell(name), seed, 0.5, False, "cpu", overrides=overrides)


@pytest.mark.parametrize("name", ["tiny_dual", "tiny_ftof"])
def test_program_is_correct_and_the_line_has_the_contracts_keys(name):
    r = _run(name)
    assert list(r) == KEYS
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"images_per_s", "latency_ms_p95", "setup_s"}
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in r["checks"].values():
        assert c["value"] < c["limit"]


@pytest.mark.parametrize("name", ["tiny_dual", "tiny_ftof"])
def test_control_in_bfloat16_is_not_correct(name):
    r = _run(name, overrides={"compute_dtype": "bfloat16"})
    assert not r["correct"]
    assert max(c["value"] / c["limit"] for c in r["checks"].values()) > 3


def test_an_answer_altered_where_it_is_produced_is_caught(monkeypatch):
    """Each bank's answers handed back in reverse batch order: every part
    gets another part's score and map."""
    from cmdiad_tpu_torch.ops import scoring
    orig = scoring.patchcore_finish

    def altered(*a, **kw):
        s, m = orig(*a, **kw)
        return s.flip(0), m.flip(0)
    monkeypatch.setattr(scoring, "patchcore_finish", altered)
    assert not _run()["correct"]


def test_half_the_batch_left_out_is_caught(monkeypatch):
    from cmdiad_tpu_torch.methods import variants
    orig = variants.BatchedScoresMixin._scores_batch

    def half(self, batch):
        n = batch["rgb"].shape[0] // 2
        keep = {k: (np.concatenate([v[:n], v[:n]]) if isinstance(v, np.ndarray) else v)
                for k, v in batch.items()}
        return orig(self, keep)
    monkeypatch.setattr(variants.BatchedScoresMixin, "_scores_batch", half)
    assert not _run()["correct"]
