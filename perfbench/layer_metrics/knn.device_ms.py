"""Device ms an image in the KNN grouping (distances, radix top-k): the device time of the kernels launched
inside the port's own ``span.knn`` ranges (``cmdiad_tpu_torch/tracing.py``),
over the parts the traced stretch scored.  Nothing to read where the
program opens no such span."""


def read(ctx):
    s = ctx.reduced.span_device_s.get("knn")
    if not s or not ctx.images:
        return None
    return 1000.0 * s / ctx.images
