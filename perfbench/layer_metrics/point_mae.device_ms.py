"""Device ms an image in the backbone xyz (Point-MAE with FPS, KNN, interpolation and pooling): the device time of the kernels
launched inside the ``xyz_patches`` span, over the parts the traced stretch
scored.  Nothing to read where the cell never calls the span."""


def read(ctx):
    s = ctx.reduced.span_device_s.get("xyz_patches")
    if not s or not ctx.images:
        return None
    return 1000.0 * s / ctx.images
