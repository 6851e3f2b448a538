"""Device ms an image in the backbone rgb (ViT): the device time of the kernels
launched inside the ``rgb_patches`` span, over the parts the traced stretch
scored.  Nothing to read where the cell never calls the span."""


def read(ctx):
    s = ctx.reduced.span_device_s.get("rgb_patches")
    if not s or not ctx.images:
        return None
    return 1000.0 * s / ctx.images
