"""Blocking host <-> device crossings a predict call: the program's own
counters (``cmdiad_tpu_torch.tracing.counters()``, counted while the traced
stretch's profiler records), ``host_syncs`` over ``calls``.  Nothing to
read where the program keeps no such counters."""


def read(ctx):
    try:
        from cmdiad_tpu_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    if not c.get("calls"):
        return None
    return c["host_syncs"] / c["calls"]
