"""Start a process group of ranks on this host without torchrun.

``spawn(fn, world_size, backend, devices)`` starts one process a rank
(``torch.multiprocessing``, spawn method), joins them into a process group
through a file store in a temporary directory, makes each rank's device
current, runs ``fn(device, *args)`` in each and returns the ranks' return
values in rank order (each pickled through a file).  A rank that raises
stops the others, and ``spawn`` raises with its traceback.

``devices`` names each rank's device explicitly.  NCCL needs a card a rank:
a repeated device raises here, before any process starts (NCCL itself would
fail with "Duplicate GPU detected").  Under gloo two ranks may share a card
when the caller names it twice; they then measure the collectives and the
extra process, not scaling.

The CUDA kernels build on a rank's first launch; ``kernels.build_all``
holds a file lock, so ranks that start together build each library once.
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile
from typing import Callable, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 600


def _check_devices(backend: str, devices: Sequence[str]) -> None:
    """Refuse devices that ``backend`` cannot run a rank on."""
    devs = [torch.device(d) for d in devices]
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: choose 'nccl' or 'gloo'")
    if backend == "nccl":
        if any(d.type != "cuda" for d in devs):
            raise ValueError(f"NCCL needs CUDA devices, got {list(devices)}")
        idx = [d.index or 0 for d in devs]
        if len(set(idx)) != len(idx):
            raise ValueError(
                f"NCCL cannot put two ranks on one card ({list(devices)}); name "
                "one card a rank, or use gloo to share a card")


def _rank_main(rank, fn, world_size, backend, devices, store, out_dir, args):
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{store}", rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        result = fn(device, *args)
        with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world_size: int, backend: str, devices: Sequence[str],
          args: tuple = ()) -> list:
    """Run ``fn(device, *args)`` on ``world_size`` ranks over ``backend``,
    rank r on ``devices[r]``; returns the ranks' results in rank order.
    ``fn`` must be importable by name (a module-level function)."""
    if len(devices) != world_size:
        raise ValueError(f"{world_size} ranks need {world_size} devices, got "
                         f"{list(devices)}")
    _check_devices(backend, devices)
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(
            _rank_main, nprocs=world_size, start_method="spawn",
            args=(fn, world_size, backend, [str(d) for d in devices],
                  os.path.join(tmp, "store"), tmp, args))
        results = []
        for r in range(world_size):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
    return results
