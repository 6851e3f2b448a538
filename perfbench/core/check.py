"""``correct``: the timed path's answers against the plain reference.

For each checked part (a sample of the pool drawn from the seed) that
the window served, the
reference works out again, from the benchmark's weights, parts and state,
every bank's lambda-weighted score and map and the fused score and map.
The numbers (each compared where the cell's limits file,
``perfbench/limits/<cell>.json``, gives it a limit):

* ``score_rel``: the largest distance of a per-bank or fused score from
  the reference's range over the bank-min's near ties
  (``reference/scoring.py``), over |reference|;
* ``map_max_rel``: the largest distance of a map pixel from that range's
  maps, over max|reference|;
* ``map_l2_rel``: the largest ||program - reference||_2 / ||reference||_2;
* ``map_median_rel``: the largest median|program - reference| /
  max|reference|.

A checked part with no answer reads infinity.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from perfbench.core import state as state_mod
from perfbench.core.state import State
from perfbench.reference import fuse, scoring

_TINY = 1e-30


NUMBERS = ("score_rel", "map_max_rel", "map_l2_rel", "map_median_rel")


def checked_parts(seed: int, pool: int, n: int) -> List[int]:
    rng = np.random.default_rng([seed, 777])
    return sorted(rng.choice(pool, min(n, pool), replace=False).tolist())


@torch.no_grad()
def reference_answers(config: dict, weights: dict, state: State, parts: Dict[int, dict],
                      device, block: int = 4) -> Dict[int, dict]:
    """pool index -> {"banks": [per bank ``scoring.score``], "fused": the
    same fused through the two fusers}."""
    sds = state_mod.state_dicts(weights, device)
    banks = {n: torch.as_tensor(b, device=device) for n, b in state.banks.items()}
    nns = {n: torch.as_tensor(t, device=device) for n, t in state.nn.items()}
    gt = config["gt_size"]
    out = {}
    idx = sorted(parts)
    for s in range(0, len(idx), block):
        chunk = idx[s:s + block]
        feats = state_mod.reference_features(config, sds, [parts[i] for i in chunk], device)
        feats.update(state_mod.features(config, sds, feats,
                                        [r for r in state.scored if r not in feats]))
        for j, i in enumerate(chunk):
            per = []
            for name in state.scored:
                mean, std = state.stats[name]
                lam_s, lam_m = config["lambdas"][name]
                r = scoring.score(feats[name][j], mean, std, banks[name], nns[name], gt,
                                  lam_s, lam_m)
                per.append({k: (v.cpu().numpy() if torch.is_tensor(v) else v)
                            for k, v in r.items()})
            fused = {k: fuse.fuse([r[k] for r in per], state.detect_coef if k[0] == "s"
                                  else state.seg_coef) for k in per[0]}
            out[i] = {"banks": per, "fused": fused}
    return out


def compare(answers, ref: Dict[int, dict]) -> Dict[str, float]:
    """The numbers; ``answers`` is ``serve.Answers``.  A score or a map
    pixel counts by how far it lies outside the reference's range over the
    near ties; the L2 and median numbers compare with the reference's own
    choice."""
    out = dict.fromkeys(NUMBERS, 0.0)
    for i, r in ref.items():
        if i not in answers.banks or i not in answers.fused_score:
            return dict.fromkeys(NUMBERS, float("inf"))
        s_vec, maps = answers.banks[i]
        s_vec = s_vec.double().cpu().numpy()
        maps = maps.double().cpu().numpy()
        got = [(s_vec[k], maps[k], rb) for k, rb in enumerate(r["banks"])]
        got.append((answers.fused_score[i], np.asarray(answers.fused_map[i], np.float64),
                    r["fused"]))
        for s, m, q in got:
            out["score_rel"] = max(out["score_rel"], _rel(
                _outside(float(s), q["s_lo"], q["s_hi"]), abs(q["s"])))
            top = float(np.max(np.abs(q["m"])))
            err = np.abs(m - q["m"])
            for key, value in (
                    ("map_max_rel", _rel(float(np.max(_outside(m, q["m_lo"], q["m_hi"]))), top)),
                    ("map_l2_rel", _rel(float(np.linalg.norm(err)), float(np.linalg.norm(q["m"])))),
                    ("map_median_rel", _rel(float(np.median(err)), top))):
                out[key] = max(out[key], value)
    return out


def _outside(x, lo, hi):
    """How far ``x`` lies outside [lo, hi] (0 inside); NaN stays NaN."""
    return np.maximum(np.maximum(lo - x, x - hi), 0.0) + 0.0 * x


def _rel(err: float, scale: float) -> float:
    if not np.isfinite(err):
        return float("inf")
    return float(err) / max(float(scale), _TINY)
