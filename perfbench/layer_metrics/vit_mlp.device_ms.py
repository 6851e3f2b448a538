"""Device ms an image in the ViT's MLP halves (norm2, MLP, LayerScale,
residual, every block): the device time of the kernels launched inside the
port's own ``span.vit_mlp`` ranges (``cmdiad_tpu_torch/tracing.py``), over
the parts the traced stretch scored.  Nothing to read where the program
opens no such span."""


def read(ctx):
    s = ctx.reduced.span_device_s.get("vit_mlp")
    if not s or not ctx.images:
        return None
    return 1000.0 * s / ctx.images
