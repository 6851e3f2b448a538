"""FtoF MLP: one direction over the 56x56 grid of one part, three linear
layers (in -> hidden -> hidden -> out)."""

from perfbench.core.peaks import least_s


def flops_per_image(c: dict, tokens: int = 3136) -> float:
    h = c["hidden"]
    return 2 * tokens * (c["xyz_dim"] * h + h * h + h * c["rgb_dim"])


def bytes_per_image(c: dict, tokens: int = 3136) -> float:
    return 4 * tokens * (c["xyz_dim"] + c["rgb_dim"])


def least_s_per_image(config: dict, entry: dict) -> float:
    c = config[entry["of"]]
    return least_s(flops_per_image(c), bytes_per_image(c), config["dtype"])
