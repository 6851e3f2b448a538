"""Share of the rgb backbone's roofline: the least time an image takes in
the configuration's rgb model part (``counts/<part>.py`` at the
configuration's precision) over the device time an image of the
``rgb_patches`` span, what ``vit.device_ms`` reads.  Nothing to read where
the cell never calls the span or has no rgb part."""

from perfbench.core import spec


def read(ctx):
    s = ctx.reduced.span_device_s.get("rgb_patches")
    rgb = [m for m in ctx.config["models"] if spec.model_part(m).ROLE == "rgb"]
    if not s or not ctx.images or not rgb:
        return None
    least = spec.count(rgb[0]).least_s_per_image(ctx.config, {"part": rgb[0], "of": rgb[0]})
    return 100.0 * least * ctx.images / s
