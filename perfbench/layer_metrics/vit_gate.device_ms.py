"""Device ms an image in the gated FFN's gate (``silu(x1) * x2``, every
block): the device time of the kernels launched inside the port's own
``span.vit_gate`` ranges (``cmdiad_tpu_torch/tracing.py``), nested in
``vit_mlp``, over the parts the traced stretch scored.  Nothing to read
where the program opens no such span (a GELU FFN, or a program without the
span)."""


def read(ctx):
    s = ctx.reduced.span_device_s.get("vit_gate")
    if not s or not ctx.images:
        return None
    return 1000.0 * s / ctx.images
