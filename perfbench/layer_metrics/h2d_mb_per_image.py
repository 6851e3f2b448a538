"""MB handed from the host to the device a part on the predict path: the
program's own counters (``cmdiad_tpu_torch.tracing.counters()``, counted
while the traced stretch's profiler records), ``h2d_bytes`` over
``images``, in 1e6 bytes.  Nothing to read where the program keeps no such
counters."""


def read(ctx):
    try:
        from cmdiad_tpu_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    if not c.get("images"):
        return None
    return c["h2d_bytes"] / c["images"] / 1e6
