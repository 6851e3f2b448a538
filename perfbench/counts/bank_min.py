"""Bank min: the cross term 2 q.b of every query against every bank row,
in bfloat16 on the tensor cores, whatever implements it; the bytes are the
float32 queries, the bfloat16 bank and its float32 row norms, each read
once."""

from perfbench.core.peaks import least_s as _least


def flops(queries: int, rows: int, width: int) -> float:
    return 2.0 * queries * rows * width


def bytes_(queries: int, rows: int, width: int) -> float:
    return 4.0 * queries * width + 2.0 * rows * width + 4.0 * rows


def least_s(queries: int, rows: int, width: int) -> float:
    return _least(flops(queries, rows, width), bytes_(queries, rows, width), "bfloat16")


def least_s_per_image(config: dict, entry: dict) -> float:
    bank = config["banks"][entry["bank"]]
    return least_s(bank["queries"], bank["rows"], bank["width"])
