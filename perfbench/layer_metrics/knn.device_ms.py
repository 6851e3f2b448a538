"""Device ms an image in the KNN grouping (one ``csrc/knn.cu`` launch a
batch and its wrapper's packing, norms and first-valid ops): the device
time of the kernels launched inside the port's own ``span.knn`` ranges
(``cmdiad_tpu_torch/tracing.py``), over the parts the traced stretch
scored.  Nothing to read where the program opens no such span."""


def read(ctx):
    s = ctx.reduced.span_device_s.get("knn")
    if not s or not ctx.images:
        return None
    return 1000.0 * s / ctx.images
