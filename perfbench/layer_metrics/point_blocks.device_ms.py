"""Device ms an image in Point-MAE's position embedding, 12 blocks and fetched norms: the device time of the kernels launched
inside the port's own ``span.point_blocks`` ranges (``cmdiad_tpu_torch/tracing.py``),
over the parts the traced stretch scored.  Nothing to read where the
program opens no such span."""


def read(ctx):
    s = ctx.reduced.span_device_s.get("point_blocks")
    if not s or not ctx.images:
        return None
    return 1000.0 * s / ctx.images
