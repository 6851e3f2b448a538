"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  Every share the
benchmark reports is stated against these, with the card's power limit
printed beside it."""

PEAKS = {
    "bfloat16": 989e12,   # FLOP/s, tensor cores
    "tf32": 495e12,       # FLOP/s, tensor cores
    "float32": 67e12,     # FLOP/s outside the tensor cores (TF32 off)
    "int8": 1979e12,      # OP/s, tensor cores
    "hbm": 3.35e12,       # bytes/s
}


def least_s(flops: float, bytes_: float, precision: str) -> float:
    """The least time of a piece of work: operations at the precision's
    peak or bytes at the memory bandwidth, whichever takes longer."""
    return max(flops / PEAKS[precision], bytes_ / PEAKS["hbm"])
