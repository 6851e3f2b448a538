"""The attention route of ``cmdiad_tpu_torch.ops.flash_attn``, on the CPU.

``takes_einsum`` decides, from the operands' device type, dtype and head
dim, ``use_flash`` and whether a gradient is needed, whether
``fused_attention`` takes the einsum form; everything else takes a fused
form, the kernel (``csrc/flash_attn.cu``) on a card.  Here:

* the predicate on each of its boundaries: a float32 call at head dim 64
  on a card that needs no gradient takes the kernel, flipping any one of
  those takes the einsum form, and ``use_flash`` always takes the kernel;
* ``fused_attention`` follows it, asked with the operands' grad, and a
  caller's ``score_counter`` counts the (B, H, N, N) score bytes of the
  einsum form inside a traced ``predict`` and 0 on a fused route;
* the ViT's blocks count ``vit_attn_score_bytes`` through that counter,
  and Point-MAE's blocks count nothing.

The card tests (``tests/test_torch_cuda.py``) hold the kernel itself to the
plain version.  The file imports no JAX.
"""

import pytest
import torch

from cmdiad_tpu_torch import tracing
from cmdiad_tpu_torch.models.vit import ViTConfig, VisionTransformer
from cmdiad_tpu_torch.ops import flash_attn as fa

torch.set_num_threads(2)

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
KERNEL = ("cuda", F32, 64, False)


@pytest.mark.parametrize("args, einsum", [
    (KERNEL + (False,), False),
    (("cpu", F32, 64, False, False), True),
    (("cuda", BF16, 64, False, False), True),
    (("cuda", F16, 64, False, False), True),
    (("cuda", F32, 32, False, False), True),
    (KERNEL + (True,), True),
    (("cuda", BF16, 32, True, True), False),
    (("cpu", F32, 64, True, True), False),
], ids=["kernel", "cpu", "bf16", "f16", "head_dim_32", "grad",
        "flash_cuda", "flash_cpu"])
def test_takes_einsum_on_each_boundary(args, einsum):
    assert fa.takes_einsum(*args) is einsum


def _qkv(b=2, n=37, h=2, d=64, dtype=F32, seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, n, 3, h, d), generator=gen).to(dtype)
    return x[:, :, 0], x[:, :, 1], x[:, :, 2]


def _traced(fn, images=1):
    tracing.reset_counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with tracing.predict_call(images):
            out = fn()
    counts = tracing.counters()
    tracing.reset_counters()
    return out, counts


@pytest.mark.parametrize("use_flash", [False, True])
def test_cpu_calls_take_einsum_or_plain_and_count_the_einsum_scores(use_flash):
    q, k, v = _qkv()
    out, c = _traced(lambda: fa.fused_attention(q, k, v, 0.125, use_flash, "scores"))
    want = (fa._fused_attention_plain if use_flash else fa._einsum_attention)(q, k, v, 0.125)
    assert torch.equal(out, want)
    assert c["scores"] == (0 if use_flash else 2 * 2 * 37 * 37 * 4)


def test_score_count_needs_a_traced_predict_and_a_counter():
    q, k, v = _qkv()
    tracing.reset_counters()
    fa.fused_attention(q, k, v, 0.125, score_counter="scores")      # no profiler
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        fa.fused_attention(q, k, v, 0.125, score_counter="scores")  # outside a predict
    assert "scores" not in tracing.counters()
    _, c = _traced(lambda: fa.fused_attention(q, k, v, 0.125))       # no counter named
    assert set(c) == {"calls", "images", "host_syncs", "h2d_bytes"}


def test_a_fused_route_counts_no_score_bytes(monkeypatch):
    """With the predicate saying "fused" (as on a card at float32, head dim
    64, no grad) the einsum form does not run and the counter reads 0; a
    CPU tensor then takes the plain fused form."""
    q, k, v = _qkv()
    seen = []
    monkeypatch.setattr(fa, "takes_einsum", lambda *a: seen.append(a) or False)
    monkeypatch.setattr(fa, "_einsum_attention", None)
    out, c = _traced(lambda: fa.fused_attention(q, k, v, 0.125, score_counter="scores"))
    assert seen == [("cpu", F32, 64, False, False)]
    assert c["scores"] == 0
    assert torch.equal(out, fa._fused_attention_plain(q, k, v, 0.125))


@pytest.mark.parametrize("requires", ["q", "k", "v", None])
def test_the_predicate_is_asked_whether_a_gradient_is_needed(monkeypatch, requires):
    q, k, v = (t.clone() for t in _qkv())
    if requires:
        {"q": q, "k": k, "v": v}[requires].requires_grad_(True)
    seen = []
    monkeypatch.setattr(fa, "takes_einsum", lambda *a: seen.append(a) or True)
    fa.fused_attention(q, k, v, 0.125)
    with torch.no_grad():
        fa.fused_attention(q, k, v, 0.125)
    assert [a[-1] for a in seen] == [requires is not None, False]


VIT = ViTConfig(img_size=32, patch_size=8, embed_dim=128, depth=2, num_heads=2)


@pytest.mark.parametrize("einsum", [True, False])
@pytest.mark.parametrize("use_flash", [False, True])
def test_vit_score_bytes_follow_the_route(monkeypatch, einsum, use_flash):
    net = VisionTransformer(VIT, use_flash=use_flash).eval()
    seen = []
    monkeypatch.setattr(fa, "takes_einsum", lambda *a: seen.append(a) or einsum)
    b, n = 3, VIT.num_patches + 1
    with torch.no_grad():
        _, c = _traced(lambda: net(torch.randn(b, 32, 32, 3)), b)
    assert seen == [("cpu", F32, 64, use_flash, False)] * VIT.depth
    assert c["vit_attn_score_bytes"] == (
        VIT.depth * b * VIT.num_heads * n * n * 4 if einsum else 0)


def test_vit_asks_for_a_gradient_when_its_weights_train(monkeypatch):
    net = VisionTransformer(VIT)
    seen = []
    monkeypatch.setattr(fa, "takes_einsum", lambda *a: seen.append(a) or True)
    net(torch.randn(1, 32, 32, 3))
    with torch.no_grad():
        net(torch.randn(1, 32, 32, 3))
    net.requires_grad_(False)
    net(torch.randn(1, 32, 32, 3))
    assert [a[-1] for a in seen] == [True] * VIT.depth + [False] * 2 * VIT.depth


def test_point_mae_blocks_count_no_score_bytes():
    from cmdiad_tpu_torch.models.point_mae import PointMAEConfig, PointTransformer, group_points
    cfg = PointMAEConfig(num_group=16, group_size=8, encoder_dims=16, trans_dim=128,
                         depth=2, num_heads=2, fetch_idx=(0, 1))
    net = PointTransformer(cfg).eval()
    pts = torch.randn(2, 256, 3)
    centers, ori_idx, _ = group_points(pts, torch.ones(2, 256, dtype=torch.bool), 16, 8)
    with torch.no_grad():
        _, c = _traced(lambda: net(pts, centers, ori_idx), 2)
    assert "vit_attn_score_bytes" not in c
