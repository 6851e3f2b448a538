"""MB of attention scores the ViT's einsum attention writes a part: the
program's own counter ``vit_attn_score_bytes`` (the (B, H, N, N) score
tensor of every block, ``cmdiad_tpu_torch/models/vit.py``; 0 on the fused
path), counted while the traced stretch's profiler records, over
``images``, in 1e6 bytes.  Nothing to read where the program keeps no such
counter."""


def read(ctx):
    try:
        from cmdiad_tpu_torch import tracing
    except ImportError:
        return None
    c = tracing.counters()
    if not c.get("images") or "vit_attn_score_bytes" not in c:
        return None
    return c["vit_attn_score_bytes"] / c["images"] / 1e6
