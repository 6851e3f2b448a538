"""3-NN interpolation of one part: bound by writing a feature row for
every pixel of the organized grid (float32), after reading the grid and
the group features once; the 3-NN search over num_group centers counts as
operations."""

from perfbench.core.peaks import least_s


def flops_per_image(c: dict, pixels: int) -> float:
    return pixels * c["num_group"] * 8.0 + pixels * c["trans_dim"] * len(c["fetch_idx"]) * 6.0


def bytes_per_image(c: dict, pixels: int) -> float:
    width = c["trans_dim"] * len(c["fetch_idx"])
    return 4.0 * (pixels * 3 + c["num_group"] * (3 + width) + pixels * width)


def least_s_per_image(config: dict, entry: dict) -> float:
    c = config[entry["of"]]
    pixels = config["xyz_size"] ** 2
    return least_s(flops_per_image(c, pixels), bytes_per_image(c, pixels), config["dtype"])
