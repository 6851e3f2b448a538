"""The timed window: one client in a closed loop over the pool.

Each call hands a stacked host batch to the method's ``predict_batch`` (the
call ``CMDIADRunner.evaluate`` makes) and returns with the fused scores
and maps in host memory; the next call starts when it returns.  After each
pass through the pool the method's predictions are reset, as the next
class's evaluation would reset them.  The answers of the parts the check
samples are kept: the fused score and map the method stored, and the
lambda-weighted per-bank scores and maps it fused, taken at
``_record_predictions`` as device tensors without a copy.
"""

from __future__ import annotations

import time
import traceback
from dataclasses import dataclass, field
from typing import Dict, List, Set


@dataclass
class Answers:
    """Newest answer of each checked part: pool index -> values."""
    fused_score: Dict[int, float] = field(default_factory=dict)
    fused_map: Dict[int, object] = field(default_factory=dict)
    banks: Dict[int, tuple] = field(default_factory=dict)   # (s_vec row, maps row)


@dataclass
class Window:
    latencies: List[float]
    images: int
    calls: int
    failed: int
    seconds: float
    passes: int


class Server:
    """Drives ``method`` over ``batches`` (the pool, stacked) and keeps the
    answers of the pool indices in ``checked``."""

    def __init__(self, method, batches: List[dict], checked: Set[int]):
        self.method = method
        self.batches = batches
        self.checked = checked
        self.answers = Answers()
        self.starts = []
        start = 0
        for b in batches:
            self.starts.append(start)
            start += b["_n"]
        self.total = start
        self._pos = 0
        self.served: Set[int] = set()
        self.last_pass = None
        self._record = method._record_predictions
        method._record_predictions = self._capture

    def _capture(self, s_vec, maps, batch):
        start = self.starts[self._pos]
        for i in range(batch["_n"]):
            if start + i in self.checked:
                self.answers.banks[start + i] = (s_vec[i], maps[i])
        self._record(s_vec, maps, batch)

    def _keep(self, upto: int) -> None:
        """Keep the stored answers of the first ``upto`` parts of this pass."""
        m = self.method
        for j in range(min(upto, len(m.image_preds))):
            if j in self.checked:
                self.answers.fused_score[j] = m.image_preds[j]
                self.answers.fused_map[j] = m.predictions[j]

    def _end_pass(self, upto: int) -> None:
        """Keep this pass's answers, then reset the method's predictions."""
        m = self.method
        self._keep(upto)
        if upto == self.total:
            self.last_pass = (m.image_preds, m.image_labels, m.pixel_preds, m.pixel_labels,
                              m.predictions, m.gts, m.img_paths)
        m.reset_predictions()

    def call(self) -> int:
        """One call: the next batch of the pool; returns its parts."""
        batch = self.batches[self._pos]
        self.method.predict_batch(batch)
        self.served.update(range(self.starts[self._pos], self.starts[self._pos] + batch["_n"]))
        self._pos += 1
        if self._pos == len(self.batches):
            self._end_pass(self.total)
            self._pos = 0
        return batch["_n"]

    def warm(self, calls: int) -> None:
        for _ in range(calls):
            self.call()
        self._end_pass(0)
        self._pos = 0
        self.answers = Answers()
        self.served = set()

    def window(self, seconds: float) -> Window:
        lat, images, calls, failed, passes = [], 0, 0, 0, 0
        t_start = time.perf_counter()
        deadline = t_start + seconds
        t1 = t_start
        while t1 < deadline:
            t0 = time.perf_counter()
            try:
                images += self.call()
            except Exception:   # noqa: BLE001 — a failed call is counted, not fatal
                if not failed:
                    traceback.print_exc()
                failed += 1
                self._pos = (self._pos + 1) % len(self.batches)
            t1 = time.perf_counter()
            lat.append(t1 - t0)
            calls += 1
            passes += self._pos == 0
        self.close()
        return Window(lat, images, calls, failed, t1 - t_start, passes)

    def close(self) -> None:
        """Keep the answers of a pass cut by the window's end."""
        self._keep(self.starts[self._pos] if self._pos else 0)

    def restore(self) -> None:
        self.method._record_predictions = self._record
