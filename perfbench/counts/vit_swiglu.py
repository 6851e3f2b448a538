"""ViT with register tokens and the packed SwiGLU FFN: the matrix work of
one image over every token, the cls token and the registers included (1 +
4 + 1369 = 1374 for DINOv2 ViT-g/14-reg4): patch embedding, QKV, attention
scores and values, projection, and the FFN's ``fc1`` (to twice the hidden
width) and ``fc2``, per block (softmax, norms, the SiLU gate and LayerScale
left out as lower-order)."""

from perfbench.core.peaks import least_s


def tokens(c: dict) -> int:
    return (c["img_size"] // c["patch_size"]) ** 2 + 1 + c["num_reg_tokens"]


def flops_per_image(c: dict) -> float:
    d, p, h = c["embed_dim"], c["patch_size"], c["mlp_hidden"]
    n = (c["img_size"] // p) ** 2
    t = tokens(c)
    embed = 2 * n * (3 * p * p) * d
    block = (2 * t * d * 3 * d             # qkv
             + 2 * 2 * t * t * d           # q.k and p.v over all heads
             + 2 * t * d * d               # proj
             + 2 * t * d * 2 * h           # fc1
             + 2 * t * h * d)              # fc2
    return embed + c["depth"] * block


def bytes_per_image(c: dict) -> float:
    """The input image and the patch grid out, float32."""
    n = (c["img_size"] // c["patch_size"]) ** 2
    return 4 * (c["img_size"] ** 2 * 3 + n * c["embed_dim"])


def least_s_per_image(config: dict, entry: dict) -> float:
    c = config[entry["of"]]
    return least_s(flops_per_image(c), bytes_per_image(c), config["dtype"])
