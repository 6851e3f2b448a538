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

from perfbench.core import parts as parts_mod, spec

PAD_ROWS = 8192        # the port's persisted layout pads banks to this bucket
PAD_VALUE = 1e6        # with rows of this value
PART_INPUTS = ("rgb", "organized_pc", "points_compact")   # what a backbone reads of a part


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


def state_dicts(weights: dict, device) -> Dict[str, Dict[str, torch.Tensor]]:
    """Each model's weights on ``device`` as its reference reads them, the
    checkpoint prefix stripped."""
    return {m: strip(w.on(device), spec.model_part(m).CHECKPOINT_PREFIX)
            for m, w in weights.items()}


def features(config: dict, sds: dict, inputs: dict, roles) -> Dict[str, torch.Tensor]:
    """role -> the reference's features of the model of that role, for
    each of ``config``'s models whose role is in ``roles``, in the order of
    ``models``; ``inputs`` as ``model_parts`` says."""
    out = {}
    for m in config["models"]:
        part = spec.model_part(m)
        if part.ROLE in roles:
            out[part.ROLE] = part.features(sds[m], inputs, config[m])
    return out


def reference_features(config: dict, sds: dict, block: List[dict], device):
    """role -> the reference backbones' patch features of a block of parts."""
    inputs = {k: torch.as_tensor(np.stack([p[k] for p in block]), device=device)
              for k in PART_INPUTS}
    return features(config, sds, inputs, ("rgb", "xyz"))


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
    sds = state_dicts(weights, device)
    train = parts_mod.make_parts(seed, config["bank_parts"], traffic, 0.0, "train",
                                 config["rgb_size"])
    rows: Dict[str, list] = {}
    for s in range(0, len(train), 8):
        for role, f in reference_features(config, sds, train[s:s + 8], device).items():
            rows.setdefault(role, []).append(f.reshape(-1, f.shape[-1]))
    rgb, xyz = torch.cat(rows.pop("rgb")), torch.cat(rows.pop("xyz"))
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
    raw.update(features(config, sds, raw, [r for r in want if r not in raw]))
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
