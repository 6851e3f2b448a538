"""Device ms an image in the fusion net (the FtoF MLP): the device time of the kernels
launched inside the ``hallucinate`` span, over the parts the traced stretch
scored.  Nothing to read where the cell never calls the span."""


def read(ctx):
    s = ctx.reduced.span_device_s.get("hallucinate")
    if not s or not ctx.images:
        return None
    return 1000.0 * s / ctx.images
