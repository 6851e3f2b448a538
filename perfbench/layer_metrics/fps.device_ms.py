"""Device ms an image in FPS (csrc/fps.cu), centers gathered: the device time of the kernels launched
inside the port's own ``span.fps`` ranges (``cmdiad_tpu_torch/tracing.py``),
over the parts the traced stretch scored.  Nothing to read where the
program opens no such span."""


def read(ctx):
    s = ctx.reduced.span_device_s.get("fps")
    if not s or not ctx.images:
        return None
    return 1000.0 * s / ctx.images
