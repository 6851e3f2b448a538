"""Device ms an image in the ViT's attention halves (norm1, qkv, attention,
proj, LayerScale, residual, every block): the device time of the kernels
launched inside the port's own ``span.vit_attention`` ranges
(``cmdiad_tpu_torch/tracing.py``), over the parts the traced stretch
scored.  Nothing to read where the program opens no such span."""


def read(ctx):
    s = ctx.reduced.span_device_s.get("vit_attention")
    if not s or not ctx.images:
        return None
    return 1000.0 * s / ctx.images
