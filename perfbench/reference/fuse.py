"""Plain late fusion: the linear one-class SVMs' ``score_samples`` on the
lambda-weighted per-bank scores and maps, x . coef."""

from __future__ import annotations


def fuse(values, coef):
    """values: per bank, a float score or a float64 map; coef: per bank."""
    out = 0.0
    for v, c in zip(values, coef):
        out = out + float(c) * v
    return out
