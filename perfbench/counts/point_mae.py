"""Point-MAE: the matrix work of one part, the group encoder over
num_group x group_size neighbours (the first 1x1 conv over the points and
centers, as it is applied before the gather), the position embedding and
the transformer blocks (softmax, norms, the KNN and FPS distance work left
out as lower-order)."""

from perfbench.core.peaks import least_s


def flops_per_image(c: dict) -> float:
    g, m, t, e = c["num_group"], c["group_size"], c["trans_dim"], c["encoder_dims"]
    rows = g * m
    h = int(t * c["mlp_ratio"])
    encoder = (2 * (c["point_capacity"] + g) * 3 * 128
               + 2 * rows * 128 * 256 + 2 * rows * 512 * 512 + 2 * rows * 512 * e)
    pos = 2 * g * (3 * 128 + 128 * t)
    block = 2 * g * t * 3 * t + 2 * 2 * g * g * t + 2 * g * t * t + 2 * 2 * g * t * h
    return encoder + pos + c["depth"] * block


def bytes_per_image(c: dict) -> float:
    """The compacted points in and the group features out, float32."""
    return 4 * (c["point_capacity"] * 3 + c["num_group"] * c["trans_dim"] * len(c["fetch_idx"]))


def least_s_per_image(config: dict, entry: dict) -> float:
    c = config[entry["of"]]
    return least_s(flops_per_image(c), bytes_per_image(c), config["dtype"])
