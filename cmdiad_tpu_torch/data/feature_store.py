"""Per-sample feature dumps for MTFI distillation training.

The JAX package's ``data/feature_store.py`` (the reference writes one
``.pt`` tensor file a sample): one compressed ``.npz`` a sample with named
arrays under ``<root>/<split>/<name>.npz``.

Layouts (the reference's three dump flavours):
  fusion/      key 'patch'  (3136, 1536)  [xyz_patch | rgb_patch2]
  frgb_xyz/    keys 'frgb' (3136, 768), 'xyz' (H, W, 3 organized pc)
  rgb_fxyz/    keys 'hfxyz' (3136, 768), 'lfxyz' (784, 768), 'rgb' (H, W, 3)
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Iterator, List

import numpy as np


class FeatureStore:
    def __init__(self, root: str):
        self.root = Path(root)

    def save(self, split: str, name: str, **arrays) -> None:
        d = self.root / split
        os.makedirs(d, exist_ok=True)
        np.savez_compressed(d / f"{name}.npz",
                            **{k: np.asarray(v) for k, v in arrays.items()})

    def list(self, split: str) -> List[Path]:
        d = self.root / split
        return sorted(d.glob("*.npz")) if d.exists() else []

    def iter_split(self, split: str) -> Iterator[Dict[str, np.ndarray]]:
        for p in self.list(split):
            with np.load(p) as z:
                yield {k: z[k] for k in z.files}

    def load_stacked(self, split: str, keys) -> Dict[str, np.ndarray]:
        """Stack every sample's arrays: {key: (N, ...)}."""
        cols = {k: [] for k in keys}
        for rec in self.iter_split(split):
            for k in keys:
                cols[k].append(rec[k])
        return {k: np.stack(v) for k, v in cols.items()}
