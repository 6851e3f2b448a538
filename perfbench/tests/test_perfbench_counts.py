"""The counts of ``perfbench/counts`` against hand counts of the published
shapes."""

import pytest

from perfbench.core import peaks, spec

DUAL = spec.load_config("dino_pointmae")
FTOF = spec.load_config("ftof_xyz_main")


def test_vit_b8_matches_the_hand_count():
    # 784 patches + cls; per block qkv, scores and values, proj, MLP
    t = 785
    block = 2 * t * 768 * 2304 + 4 * t * t * 768 + 2 * t * 768 * 768 + 4 * t * 768 * 3072
    hand = 2 * 784 * 192 * 768 + 12 * block
    assert spec.count("vit").flops_per_image(DUAL["vit"]) == hand
    assert hand == pytest.approx(156.3e9, rel=1e-3)


def test_point_mae_matches_the_hand_count():
    rows = 1024 * 128
    encoder = 2 * (32768 + 1024) * 3 * 128 + 2 * rows * (128 * 256 + 512 * 512 + 512 * 384)
    block = 2 * 1024 * 384 * 1152 + 4 * 1024 * 1024 * 384 + 2 * 1024 * 384 * 384 \
        + 4 * 1024 * 384 * 1536
    hand = encoder + 2 * 1024 * (3 * 128 + 128 * 384) + 12 * block
    assert spec.count("point_mae").flops_per_image(DUAL["point_mae"]) == hand
    assert hand == pytest.approx(191.8e9, rel=1e-3)
    # the group encoder alone: 129 GFLOP a part
    assert encoder == pytest.approx(128.9e9, rel=1e-3)


def test_ftof_mlp_matches_the_hand_count():
    # three linears 768 -> 1920 -> 1920 -> 768 over the 3136 grid tokens
    hand = 2 * 3136 * (768 * 1920 + 1920 * 1920 + 1920 * 768)
    assert spec.count("ftof_mlp").flops_per_image(FTOF["ftof_mlp"]) == hand
    assert hand == pytest.approx(41.6e9, rel=1e-3)


def test_bank_min_cross_term_and_its_bound():
    bm = spec.count("bank_min")
    assert bm.flops(25088, 65536, 768) == 2 * 25088 * 65536 * 768
    # operations bound it: 2.554 ms for a batch of 8 against 65536 rows
    assert bm.least_s(25088, 65536, 768) == pytest.approx(2 * 25088 * 65536 * 768 / 989e12)
    tiny = bm.least_s(1, 65536, 768)
    assert tiny == pytest.approx(bm.bytes_(1, 65536, 768) / peaks.PEAKS["hbm"])


def test_step_least_time_of_each_configuration():
    def step(cfg):
        return sum(spec.count(e["part"]).least_s_per_image(cfg, e) for e in cfg["step"])
    # float32 GEMMs at 67 TFLOP/s, the bank-min in bfloat16 at 989
    assert step(DUAL) * 1e3 == pytest.approx((156.3 + 191.8) / 67 + 0.046 + 0.319 + 0.0199, rel=0.01)
    assert step(FTOF) * 1e3 == pytest.approx(191.8 / 67 + 0.046 + 41.6 / 67 + 2 * 0.319, rel=0.01)
