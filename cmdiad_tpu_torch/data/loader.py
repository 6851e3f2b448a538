"""Threaded prefetching sample loader and batching.

A thread pool decodes and resizes samples on the host while the card
computes (zlib and numpy release the GIL inside their larger operations);
samples are plain numpy dicts.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterable, Iterator, List, Optional

import numpy as np


def iter_samples(dataset, num_workers: int = 6, prefetch: int = 6,
                 max_samples: Optional[int] = None) -> Iterator[dict]:
    """Yield ``dataset.load(i)`` in order, at most ``prefetch`` samples
    decoding ahead on ``num_workers`` threads (0: decode inline)."""
    n = len(dataset)
    if max_samples is not None:
        n = min(n, max_samples)
    if num_workers <= 0:
        for i in range(n):
            yield dataset.load(i)
        return
    with cf.ThreadPoolExecutor(max_workers=num_workers) as pool:
        window: List[cf.Future] = []
        nxt = 0
        while nxt < n and len(window) < prefetch:
            window.append(pool.submit(dataset.load, nxt))
            nxt += 1
        while window:
            fut = window.pop(0)
            if nxt < n:
                window.append(pool.submit(dataset.load, nxt))
                nxt += 1
            yield fut.result()


def stack_batches(samples: Iterable[dict], batch_size: int) -> Iterator[dict]:
    """Group per-sample dicts into stacked numpy batches; the tail batch is
    padded with copies of its last sample and ``_n`` counts the real ones."""
    buf: List[dict] = []
    for s in samples:
        buf.append(s)
        if len(buf) == batch_size:
            yield _stack(buf, batch_size)
            buf = []
    if buf:
        yield _stack(buf, batch_size)


def _stack(buf: List[dict], batch_size: int) -> dict:
    out = {"_n": len(buf)}
    for k in buf[0]:
        v0 = buf[0][k]
        if isinstance(v0, np.ndarray):
            arrs = [b[k] for b in buf]
            while len(arrs) < batch_size:  # pad tail with copies of the last
                arrs.append(arrs[-1])
            out[k] = np.stack(arrs)
        else:
            out[k] = [b[k] for b in buf]
    return out
