"""Spans and counters of the predict path, on the profiler's clock.

Tracing is on exactly while a ``torch.profiler`` session records in this
process (``cli detect --trace_dir``, the traced stretch of ``perfbench/``);
there is no other switch.  When it is off, a span or a count costs a
module-attribute read (a ``with span(...)`` also builds the span object:
0.8 us on the card's host, where an idle ``record_function`` takes 10).

* ``span(name)``, a context manager and a decorator, opens the profiler
  range ``span.<name>``.  A range shares the device trace's clock, so the
  kernels a span launched and the host gaps inside it can be read off the
  same trace.
* ``count(name, n)`` adds to a counter while tracing is on and a
  ``predict_call`` is open: the counters hold the predict path alone, not
  the fit a trace may also cover.  ``counters()`` returns the totals with
  ``calls`` and ``images`` (counted at ``predict_call``), which a reader
  divides by.
* ``to_device`` and ``to_host`` are the blocking host <-> device copies.
  Each is one host wait (``host_syncs``) on a CUDA device; ``to_device``
  also counts the bytes it hands over (``h2d_bytes``).  ``stage`` is the
  parts' upload: pinned and ``non_blocking`` on a CUDA device, so the host
  does not wait, and it counts its bytes and no sync.  A site counts
  whatever the device, so a CPU run counts what the same call makes a card
  do: ``host_syncs`` counts host waits only.
* ``constant(device, dtype, build, *args)`` is the device copy of a
  host-built constant, uploaded (through ``to_device``) on the first
  request for its key and kept; a miss inside a predict call counts
  ``const_uploads``, 0 on every warm call (the card test of
  ``tests/test_torch_tracing.py`` holds it there).

The spans (``predict``, ``upload``, ``readback``, ``fps``, ``knn``,
``group_encoder``, ``point_blocks``, ``regrid``, in each of the ViT's
blocks ``vit_attention`` and ``vit_mlp``, and inside ``vit_mlp`` the gated
FFN's ``vit_gate``) and the counters (``host_syncs``,
``h2d_bytes``, and ``vit_attn_score_bytes``, the bytes of the score tensors
the ViT's einsum attention writes, ``ops/flash_attn.py``) are read by the
per-layer metrics of ``perfbench/layer_metrics/`` and label the idle gaps
of its breakdown.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler

#: names of the spans the predict path opens
SPANS = ("predict", "upload", "readback", "fps", "knn", "group_encoder",
         "point_blocks", "regrid", "vit_attention", "vit_mlp", "vit_gate")

_counts: Dict[str, int] = {}
_open_calls = 0


def enabled() -> bool:
    """Whether a profiler session records in this process (the flag
    ``torch.profiler.profile`` sets on entry and clears on exit)."""
    return _autograd_profiler._is_profiler_enabled


class span:
    """``with span("fps"): ...`` or ``@span("upload")``: the profiler
    range ``span.<name>`` while tracing is on, nothing otherwise."""

    __slots__ = ("label", "_range")

    def __init__(self, name: str):
        self.label = "span." + name
        self._range = None

    def __enter__(self):
        if enabled():
            self._range = torch.profiler.record_function(self.label)
            self._range.__enter__()
        return self

    def __exit__(self, *exc):
        rng, self._range = self._range, None
        if rng is not None:
            rng.__exit__(*exc)
        return False

    def __call__(self, fn):
        label = self.label

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not enabled():
                return fn(*args, **kwargs)
            with torch.profiler.record_function(label):
                return fn(*args, **kwargs)
        return wrapper


class predict_call(span):
    """The ``predict`` span of one ``predict_batch`` over ``images``
    parts: counts the call and its parts, and opens the counters."""

    __slots__ = ("images", "_counting")

    def __init__(self, images: int):
        super().__init__("predict")
        self.images = int(images)
        self._counting = False

    def __enter__(self):
        global _open_calls
        if enabled():
            super().__enter__()
            _open_calls += 1
            self._counting = True
            count("calls")
            count("images", self.images)
        return self

    def __exit__(self, *exc):
        global _open_calls
        if self._counting:
            _open_calls -= 1
            self._counting = False
        return super().__exit__(*exc)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` while tracing is on inside a
    ``predict_call``."""
    if _open_calls and enabled():
        _counts[name] = _counts.get(name, 0) + n


def counters() -> Dict[str, int]:
    """The totals counted so far: ``calls``, ``images``, ``host_syncs``,
    ``h2d_bytes`` (zero where nothing was counted) and any other counter."""
    return {"calls": 0, "images": 0, "host_syncs": 0, "h2d_bytes": 0, **_counts}


def reset_counters() -> None:
    _counts.clear()


def to_device(x, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype, device)`` of a host array or scalar:
    one host sync and the result's bytes handed to the device."""
    t = torch.as_tensor(x, dtype=dtype, device=device)
    if _open_calls:
        count("host_syncs")
        count("h2d_bytes", t.numel() * t.element_size())
    return t


def stage(x, device) -> torch.Tensor:
    """A host array on ``device`` without a host wait: on a CUDA device it
    is copied into a pinned block of PyTorch's caching host allocator,
    which records the copy's event so that a block is reused only after
    its copy has run, then copied ``non_blocking``; elsewhere
    ``torch.as_tensor``.  The array's strides are kept, as
    ``torch.as_tensor(x, device=...)`` keeps them: a planar image (a
    resized part) goes up as one flat copy, with no transposition on the
    host.  The host copy is numpy's, on one thread: ``pin_memory()``'s
    copy runs on the intra-op threads, and on a shared host one late
    thread held a call up by tens of milliseconds.  Counts the bytes
    handed over, and no sync."""
    t = torch.as_tensor(x)
    if torch.device(device).type == "cuda":
        pinned = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, pin_memory=True)
        np.copyto(pinned.numpy(), t.numpy())
        t = pinned.to(device, non_blocking=True)
    else:
        t = t.to(device)
    count("h2d_bytes", t.numel() * t.element_size())
    return t


_constants: Dict[tuple, torch.Tensor] = {}


def constant(device, dtype, build, *args) -> torch.Tensor:
    """The device copy of ``build(*args)`` (a host array, or a scalar with
    ``build=float``) in ``dtype`` (None: as ``torch.as_tensor`` infers it),
    kept for the key (build, args, device, dtype).  Its first request
    uploads it through ``to_device``; inside a predict call that miss also
    counts ``const_uploads``.  Callers only read the tensor."""
    key = (build, args, torch.device(device), dtype)
    t = _constants.get(key)
    if t is None:
        t = _constants[key] = to_device(build(*args), device, dtype)
        count("const_uploads")
    return t


def to_host(t: torch.Tensor) -> torch.Tensor:
    """``t.cpu()`` inside a ``readback`` span: one host sync."""
    with span("readback"):
        count("host_syncs")
        return t.cpu()
