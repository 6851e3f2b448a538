"""Plain forward of timm's ``vit_giant_patch14_reg4_dinov2.lvd142m``, DINOv2
ViT-g/14 with four registers (arXiv:2304.07193, arXiv:2309.16588), as
timm's ``forward_features`` runs it, the prefix tokens then dropped:

* the conv patch embedding, its (B, C, g, g) output flattened to g² tokens;
* ``pos_embed`` (g² rows) added to the patch tokens alone, then the cls
  token and the registers prepended, cls first (timm's ``no_embed_class``);
* pre-LN blocks, x + ls1 * attn(norm1 x), then x + ls2 * ffn(norm2 x), with
  qkv bias and LayerScale's ``ls{1,2}.gamma``; the FFN is timm's
  ``SwiGLUPacked``: ``mlp.fc1`` to twice the hidden width, its output
  split in halves x1, x2, ``mlp.fc2`` of silu(x1) * x2;
* the final LayerNorm, and the 1 + registers prefix tokens dropped to the
  (B, g², C) patch grid.

Float32 throughout, TF32 off for cuBLAS and cuDNN.  Where it departs from
timm:

* attention is ``reference/vit.py``'s: an explicit float32 softmax of
  q.k^T where timm calls ``F.scaled_dot_product_attention``, the same
  function summed in another order;
* ``SwiGLUPacked``'s ``norm`` (an identity here) and dropouts are left out,
  as are ``norm_pre``, patch dropout, drop path and the head: at inference
  they are identities in this model, or not on the path;
* ``dynamic_img_size`` is left out: at the released 518² the positions are
  used as they are, so nothing resamples them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from perfbench.reference.vit import _lin, _ln, attention


def ffn(sd, name, x):
    """timm's ``SwiGLUPacked``: silu of fc1's first half times its second."""
    x1, x2 = _lin(sd, f"{name}.fc1", x).chunk(2, -1)
    return _lin(sd, f"{name}.fc2", F.silu(x1) * x2)


def block(sd, name, x, heads, eps):
    a = attention(sd, f"{name}.attn", _ln(sd, f"{name}.norm1", x, eps), heads)
    x = x + a * sd[f"{name}.ls1.gamma"]
    h = ffn(sd, f"{name}.mlp", _ln(sd, f"{name}.norm2", x, eps))
    return x + h * sd[f"{name}.ls2.gamma"]


@torch.no_grad()
def patches(sd, images, c):
    """images (B, H, W, 3) ImageNet-normalised -> patch tokens (B, g*g, C)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    x = F.conv2d(images.permute(0, 3, 1, 2), sd["patch_embed.proj.weight"],
                 sd["patch_embed.proj.bias"], stride=c["patch_size"])
    x = x.flatten(2).transpose(1, 2) + sd["pos_embed"]
    b = x.shape[0]
    x = torch.cat([sd["cls_token"].expand(b, -1, -1), sd["reg_token"].expand(b, -1, -1), x], 1)
    for i in range(c["depth"]):
        x = block(sd, f"blocks.{i}", x, c["num_heads"], c["ln_eps"])
    return _ln(sd, "norm", x, c["ln_eps"])[:, 1 + c["num_reg_tokens"]:]
