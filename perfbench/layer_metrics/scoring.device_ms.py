"""Device ms an image in the scoring (bank min, refine, eq. 7, map and blur): the device time of the kernels
launched inside the ``score_patch_batch`` span, over the parts the traced stretch
scored.  Nothing to read where the cell never calls the span."""


def read(ctx):
    s = ctx.reduced.span_device_s.get("score_patch_batch")
    if not s or not ctx.images:
        return None
    return 1000.0 * s / ctx.images
