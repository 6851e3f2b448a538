"""The plain reference against the port's CPU path at tiny widths (the
port's 'tiny' backbones), on the benchmark's own weights and parts: it
validates the reference, which imports nothing of the port."""

import json

import numpy as np
import pytest
import torch

from conftest import DATA
from perfbench.core import parts, spec, state as state_mod, weights as W
from perfbench.reference import ftof_mlp, point_mae, scoring, vit

torch.set_num_threads(4)
CFG = spec.load_config("tiny_ftof", DATA)
TRAFFIC = json.loads((DATA / "tiny_traffic.json").read_text())
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def made():
    return {m: W.make(m, CFG[m], 2 ** 33 + 5, CPU, i) for i, m in enumerate(CFG["models"])}


@pytest.fixture(scope="module")
def pool():
    return parts.make_parts(2 ** 33 + 5, 4, TRAFFIC, 0.5, "pool")


@pytest.fixture(scope="module")
def backbone(made):
    from cmdiad_tpu_torch.config import method_preset
    from cmdiad_tpu_torch.methods.registry import build_backbone
    from cmdiad_tpu_torch.models import convert
    cfg = method_preset(CFG["preset"], **CFG["overrides"])
    bb = build_backbone(cfg, "cpu")
    convert.load_named(bb.vit, made["vit"].numpy)
    convert.load_named(bb.point, convert.strip_pointmae_prefixes(made["point_mae"].numpy))
    return bb


def _stack(pool, key):
    return torch.as_tensor(np.stack([p[key] for p in pool]))


def test_vit_matches_the_port(made, pool, backbone):
    ref = vit.patches(made["vit"].on(CPU), _stack(pool, "rgb"), CFG["vit"])
    port, _ = backbone.rgb_patches(_stack(pool, "rgb"))
    torch.testing.assert_close(ref, port, rtol=1e-5, atol=1e-5)


def test_point_mae_matches_the_port(made, pool, backbone):
    sd = {k[len("MAE_encoder."):]: v for k, v in made["point_mae"].on(CPU).items()}
    ref = point_mae.patches(sd, _stack(pool, "organized_pc"), _stack(pool, "points_compact"),
                            CFG["point_mae"])
    port = backbone.xyz_patches(_stack(pool, "organized_pc"),
                                _stack(pool, "points_compact"))["xyz_patch"]
    torch.testing.assert_close(ref, port, rtol=1e-5, atol=1e-5)


def test_ftof_matches_the_port(made):
    from cmdiad_tpu_torch.models.hallucination import FtoFMlp
    from cmdiad_tpu_torch.models import convert
    net = FtoFMlp(32, 32)
    convert.load_reference_state(net, made["ftof_mlp"].numpy)
    x = torch.randn(2, 3136, 32, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(ftof_mlp.generate(made["ftof_mlp"].on(CPU), x, "xyz", 1e-6),
                               net.generate(x, "rgb"), rtol=1e-5, atol=1e-6)


def test_scoring_matches_the_port():
    from cmdiad_tpu_torch.ops.scoring import bank_nn_table, pad_bank, patchcore_score
    g = torch.Generator().manual_seed(3)
    bank = torch.randn(512, 64, generator=g)
    patches = torch.randn(2, 3136, 64, generator=g) * 1.3 + 0.2
    mean, std = 0.2, 1.3
    padded = pad_bank(bank)
    table = bank_nn_table(padded, k=3, n_valid=512)
    s, m = patchcore_score((patches - mean) / std, padded, (56, 56), out_size=64,
                           n_valid=512, nn_table=table)
    mine = state_mod.nn_table(bank)
    assert torch.equal(mine, table[:512])
    for i in range(2):
        r = scoring.score(patches[i], mean, std, bank, mine, 64, 1.0, 1.0)
        assert r["s"] == pytest.approx(float(s[i]), rel=1e-5)
        assert r["s_lo"] <= r["s"] <= r["s_hi"]
        np.testing.assert_allclose(r["m"].numpy(), m[i].double().numpy(), rtol=1e-5, atol=1e-6)
        assert bool((r["m_lo"] <= r["m"] + 1e-12).all() and (r["m"] <= r["m_hi"] + 1e-12).all())


def test_near_ties_hold_every_row_a_sound_program_may_pick():
    """Two rows that round to the same bfloat16 row: a kernel may pick
    either, and the range holds both rows' exact distances."""
    g = torch.Generator().manual_seed(5)
    bank = torch.randn(256, 64, generator=g)
    q = bank[7] + 1e-2 * torch.randn(64, generator=g)
    bank[9] = bank[7] * (1 + 2 ** -20)      # the same row in bfloat16
    dist, row, (pats, rows, d) = scoring.nearest(q[None], bank)
    assert set(rows.tolist()) >= {7, 9}
    assert float(d.min()) <= float(dist[0]) <= float(d.max())
