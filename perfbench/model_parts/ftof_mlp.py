"""The reference's FtoF MLP (``HallucinationCrossModalityNetwork``,
``mlp_depth`` 1) as its ``.pth`` state dict holds it, both directions,
although a line with one camera runs one of them: the fusion net that
hallucinates rgb features from xyz ones (``perfbench/reference/
ftof_mlp.py``), loaded into the port's fusion net."""

from __future__ import annotations

from typing import List

from perfbench.core.weights import Leaf, ln
from perfbench.reference import ftof_mlp as reference

ROLE = "fusion"
CHECKPOINT_PREFIX = ""
NOT_WIDTHS = ("source",)


def leaves(c: dict) -> List[Leaf]:
    out: List[Leaf] = []
    for side, din, dout in (("xyz", c["xyz_dim"], c["rgb_dim"]),
                            ("rgb", c["rgb_dim"], c["xyz_dim"])):
        h = c["hidden"]
        out += ln(f"{side}_norm", din)
        m = f"{side}_mlp.mlp_module.0"
        out += [(f"{m}.fc1.weight", (h, din), "fanin", 1.0),
                (f"{m}.fc1.bias", (h,), "normal", 0.02),
                (f"{m}.fc2.weight", (h, h), "fanin", 1.0),
                (f"{m}.fc2.bias", (h,), "normal", 0.02),
                (f"{m}.fc3.weight", (dout, h), "fanin", 1.0),
                (f"{m}.fc3.bias", (dout,), "normal", 0.02)]
    return out


def features(sd, inputs, c):
    return reference.generate(sd, inputs["xyz"], "xyz", c["ln_eps"])


def load(backbone, fusion, sd) -> None:
    from cmdiad_tpu_torch.models import convert
    convert.load_reference_state(fusion, sd)


def widths(backbone, fusion) -> dict:
    if fusion is None:
        return {}
    blocks = fusion.xyz_mlp.mlp_module
    return {"xyz_dim": fusion.xyz_norm.normalized_shape[0], "rgb_dim": blocks[-1].fc3.out_features,
            "hidden": blocks[0].fc1.out_features, "ln_eps": fusion.xyz_norm.eps}
