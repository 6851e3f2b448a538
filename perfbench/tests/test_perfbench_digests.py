"""The harness's seeded data, pinned: SHA-256 digests of everything a cell
makes from its seed before the program runs, at the CPU test sizes.

For ``tiny_dual`` and ``tiny_ftof`` at one seed: each model's flat weights
buffer, the pool's arrays, the fitted state (banks, 3-NN tables,
statistics, fuser weights) and the reference's answers on the pool.
``data/digests.json`` holds the digests the harness gave before its model
parts moved into ``perfbench/model_parts/``; a change to the harness that
alters what a cell makes or checks shows here."""

import hashlib
import json

import numpy as np
import pytest
import torch

from conftest import DATA
from perfbench.core import check, parts, spec, state as state_mod, weights as W

SEED = 2 ** 31 + 4242
CPU = torch.device("cpu")


def _sha(*values) -> str:
    h = hashlib.sha256()
    for v in values:
        a = np.ascontiguousarray(np.asarray(v))
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _answer_values(answer: dict):
    for r in answer["banks"] + [answer["fused"]]:
        for key in sorted(r):
            yield r[key]


def digests(name: str) -> dict:
    torch.set_num_threads(4)    # the statistics' float64 sums split by thread
    cfg = spec.load_config(name, DATA)
    traffic = json.loads((DATA / "tiny_traffic.json").read_text())
    made = {m: W.make(m, cfg[m], SEED, CPU, i) for i, m in enumerate(cfg["models"])}
    pool = parts.make_parts(SEED, traffic["pool"], traffic, traffic["defect_share"], "pool")
    state = state_mod.build(cfg, traffic, made, SEED, CPU)
    ref = check.reference_answers(cfg, made, state, dict(enumerate(pool)), CPU)
    out = {f"weights.{m}": _sha(w.flat) for m, w in made.items()}
    out["pool"] = _sha(*[p[k] for p in pool for k in ("rgb", "organized_pc", "points_compact",
                                                      "gt", "label")])
    for n in state.scored:
        out[f"bank.{n}"] = _sha(state.banks[n])
        out[f"nn.{n}"] = _sha(state.nn[n])
    out["stats"] = _sha(*[state.stats[n] for n in sorted(state.stats)])
    out["fusers"] = _sha(state.detect_coef, state.seg_coef)
    out["answers"] = _sha(*[v for i in sorted(ref) for v in _answer_values(ref[i])])
    return out


@pytest.mark.parametrize("name", ["tiny_dual", "tiny_ftof"])
def test_what_a_cell_makes_from_its_seed_is_unchanged(name):
    want = json.loads((DATA / "digests.json").read_text())[name]
    assert digests(name) == want
