"""The whole step's share of the card's peak: the least time an image
takes (the sum over the configuration's ``step`` parts of operations at
the peak of their precision, or bytes at the bandwidth: ``counts/``) over
the time an image took in the traced run's measured window, outside its
profiled stretch."""

from perfbench.core import spec


def read(ctx):
    if not ctx.measured_s_per_image:
        return None
    least = sum(spec.count(e["part"]).least_s_per_image(ctx.config, e)
                for e in ctx.config["step"])
    return 100.0 * least / ctx.measured_s_per_image
