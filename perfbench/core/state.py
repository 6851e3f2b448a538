"""The fitted state a restarted line serves: banks, statistics, 3-NN
tables and fusers, made from the seed and written in the port's npz layout.

The bank rows are features of good parts (``bank_parts`` of them, drawn
from the seed) computed by the plain reference on the card, so that the
program is handed a bank it did not make: the rgb bank a random subset of
the ViT's patch rows, the xyz bank a random subset of Point-MAE's rows
that hold some of the object (a greedy coreset keeps one empty row, and so
does this), the fusion bank the FtoF net on those same xyz rows.  The
statistics are the reference's Q1 wiring: every bank takes its mean from
the xyz rows and its std from the rgb rows.  Each bank's 3-NN table
(self first, exact float32 distances, ties to the lower row) and the two
fusers' weights (positive, from the seed) complete the state.  Nothing
here is a fit: no coreset search and no OCSVM.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch

from perfbench.core import parts as parts_mod
from perfbench.reference import ftof_mlp, point_mae, vit

PAD_ROWS = 8192        # the port's persisted layout pads banks to this bucket
PAD_VALUE = 1e6        # with rows of this value


@dataclass
class State:
    banks: Dict[str, np.ndarray]          # true rows, normalised, float32
    nn: Dict[str, np.ndarray]             # (rows, 3) int64, self first
    stats: Dict[str, Tuple[float, float]]
    detect_coef: np.ndarray
    seg_coef: np.ndarray
    scored: List[str]                     # banks in the method's order


def strip(sd: Dict[str, torch.Tensor], prefix: str) -> Dict[str, torch.Tensor]:
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def reference_features(config: dict, sds: dict, block: List[dict], device):
    """Reference rgb and xyz patch features of a block of parts."""
    t = lambda key: torch.as_tensor(np.stack([p[key] for p in block]), device=device)
    rgb = vit.patches(sds["vit"], t("rgb"), config["vit"])
    xyz = point_mae.patches(sds["point_mae"], t("organized_pc"), t("points_compact"),
                            config["point_mae"])
    return rgb, xyz


def nn_table(bank: torch.Tensor, k: int = 3, chunk: int = 2048) -> torch.Tensor:
    """(rows, k) nearest rows of a bank, self first, by float32 |a|^2 +
    |b|^2 - 2 a.b clamped at 0, ties to the lower row."""
    n = bank.shape[0]
    norms = (bank * bank).sum(1)
    cols = torch.arange(n, device=bank.device)
    out = []
    for s in range(0, n, chunk):
        d = torch.clamp_min((norms[s:s + chunk, None] + norms[None]) - 2.0 * (bank[s:s + chunk] @ bank.T),
                            0.0) + 0.0
        rows = torch.arange(d.shape[0], device=bank.device)
        d[rows, rows + s] = -1.0
        key = (d.view(torch.int32).to(torch.int64) << 32) | cols
        out.append(torch.topk(key, k, dim=1, largest=False).values & 0xFFFFFFFF)
    return torch.cat(out)


def build(config: dict, traffic: dict, weights: dict, seed: int, device) -> State:
    rng = np.random.default_rng([seed, 4242])
    sds = {m: w.on(device) for m, w in weights.items()}
    sds["point_mae"] = strip(sds["point_mae"], "MAE_encoder.")
    train = parts_mod.make_parts(seed, config["bank_parts"], traffic, 0.0, "train")
    rgb, xyz = [], []
    for s in range(0, len(train), 8):
        r, x = reference_features(config, sds, train[s:s + 8], device)
        rgb.append(r.reshape(-1, r.shape[-1]))
        xyz.append(x.reshape(-1, x.shape[-1]))
    rgb, xyz = torch.cat(rgb), torch.cat(xyz)
    mean, std = float(xyz.double().mean()), float(rgb.double().std())
    want = config["banks"]
    object_rows = torch.nonzero(torch.amax(torch.abs(xyz), 1) > 0)[:, 0].cpu().numpy()
    empty_rows = torch.nonzero(torch.amax(torch.abs(xyz), 1) == 0)[:, 0].cpu().numpy()
    n_xyz = want["xyz"]["rows"] - (1 if len(empty_rows) else 0)
    if len(object_rows) < n_xyz:
        raise ValueError(f"{len(object_rows)} object rows from {len(train)} parts, "
                         f"fewer than the {n_xyz} the xyz bank holds")
    pick = np.sort(rng.choice(object_rows, n_xyz, replace=False))
    if len(empty_rows):
        pick = np.concatenate([pick, empty_rows[:1]])
    pick = torch.as_tensor(pick, device=device)
    raw = {"xyz": xyz[pick]}
    if "rgb" in want:
        raw["rgb"] = rgb[torch.as_tensor(np.sort(rng.choice(
            rgb.shape[0], want["rgb"]["rows"], replace=False)), device=device)]
    if "fusion" in want:
        raw["fusion"] = ftof_mlp.generate(sds["ftof_mlp"], raw["xyz"], "xyz",
                                          config["ftof_mlp"]["ln_eps"])
    scored = list(want)
    banks, nn = {}, {}
    for name in scored:
        bank = ((raw[name] - mean) / std).to(torch.float32).contiguous()
        nn[name] = nn_table(bank).cpu().numpy()
        banks[name] = bank.cpu().numpy()
    del sds, rgb, xyz, raw
    stats = {name: (mean, std) for name in config["stats_banks"]}
    k = len(scored)
    return State(banks=banks, nn=nn, stats=stats,
                 detect_coef=rng.uniform(0.5, 1.5, k), seg_coef=rng.uniform(0.5, 1.5, k),
                 scored=scored)


def write(state: State, path: str, class_name: str, fingerprint: dict) -> None:
    """The port's fitted-state npz (``MemoryBankMethod.save_state``'s
    layout), uncompressed."""
    arrs = {}
    for name, bank in state.banks.items():
        n = bank.shape[0]
        rows = -(-n // PAD_ROWS) * PAD_ROWS
        padded = np.full((rows, bank.shape[1]), PAD_VALUE, np.float32)
        padded[:n] = bank
        table = np.zeros((rows, state.nn[name].shape[1]), np.int32)
        table[:n] = state.nn[name]
        arrs[f"bank_{name}"], arrs[f"nn_{name}"] = padded, table
    for tag, coef in (("detect", state.detect_coef), ("seg", state.seg_coef)):
        arrs[f"{tag}_coef"] = np.asarray(coef, np.float64)
        arrs[f"{tag}_offset"] = np.zeros(1, np.float64)
    meta = {"bank_sizes": {n: int(b.shape[0]) for n, b in state.banks.items()},
            "stats": {n: list(v) for n, v in state.stats.items()},
            "class_name": class_name, "fingerprint": fingerprint}
    arrs["meta_json"] = np.frombuffer(json.dumps(meta).encode(), np.uint8).copy()
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as fh:
        np.savez(fh, **arrs)
