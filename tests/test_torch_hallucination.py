"""The port's MTFI fusion nets and bicubic resize against the JAX package's.

Each net's JAX variables (flax init from a fixed key, BatchNorm statistics,
LayerNorm and BatchNorm affines set to random values so every one of them
matters) are carried into the port's module by its ``models.names``
table; both run float32 on the same numpy inputs.  Forwards agree to 1e-4
of the output's largest value (summation order, and flax's E[x²]−E[x]²
LayerNorm variance against PyTorch's), as the backbone tests hold them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cmdiad_tpu.models import hallucination as jh
from cmdiad_tpu.models.hrnet import HRNet as JaxHRNet
from cmdiad_tpu.ops.pooling import bicubic_resize as jax_bicubic
from cmdiad_tpu_torch.models import names
from cmdiad_tpu_torch.models import hallucination as th
from cmdiad_tpu_torch.models.hrnet import HRNet
from cmdiad_tpu_torch.ops.pooling import bicubic_resize

torch.set_num_threads(2)


def _close(got, want, rtol=1e-4):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _randomize(variables, seed=0):
    """Non-trivial norm affines and BatchNorm statistics (flax initialises
    them to identity)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        name = str(path[-1].key)
        x = np.asarray(x)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        if name in ("mean", "bias"):
            return rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        if name == "scale":
            return (1.0 + rng.normal(0.0, 0.1, x.shape)).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def _port(module, state_dict):
    module.load_state_dict(state_dict)
    assert set(state_dict) == set(module.state_dict())
    return module.eval()


@pytest.mark.parametrize("n_in,n_out", [(56, 224), (16, 64), ((20, 9), (37, 14))])
def test_bicubic_resize_matches_the_jax_band_matrices(rng, n_in, n_out):
    hw = n_in if isinstance(n_in, tuple) else (n_in, n_in)
    x = rng.normal(size=(2, *hw, 5)).astype(np.float32)
    want = jax_bicubic(jnp.asarray(x), n_out)
    got = bicubic_resize(torch.from_numpy(x), n_out)
    assert got.shape == want.shape
    _close(got.numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("depth", [1, 2])
def test_ftof_mlp_both_directions(rng, depth):
    xyz_dim, rgb_dim = 24, 16
    net = jh.FtoFMlp(xyz_dim, rgb_dim, mlp_depth=depth)
    xyz = rng.normal(size=(2, 3136, xyz_dim)).astype(np.float32)
    rgb = rng.normal(size=(2, 3136, rgb_dim)).astype(np.float32)
    variables = _randomize(net.init(jax.random.PRNGKey(0), jnp.asarray(xyz),
                                    jnp.asarray(rgb)))
    port = _port(th.FtoFMlp(xyz_dim, rgb_dim, mlp_depth=depth),
                 names.to_torch(names.ftof_mlp(depth), variables))
    assert port.xyz_mlp.mlp_module[0].fc1.out_features == int(xyz_dim * 2.5)
    for feat, out_type, width in ((rgb, "xyz", xyz_dim), (xyz, "rgb", rgb_dim)):
        want = net.apply(variables, jnp.asarray(feat), out_type, method="generate")
        got = port.generate(torch.from_numpy(feat), out_type)
        assert got.shape == (2, 3136, width)
        _close(got.detach().numpy(), want)


def test_ftof_conv_both_directions(rng):
    """768 wide inside and out whatever the backbone widths; batch 1."""
    xyz_dim, rgb_dim = 24, 16
    net = jh.FtoFConv(xyz_dim, rgb_dim)
    xyz = rng.normal(size=(1, 3136, xyz_dim)).astype(np.float32)
    rgb = rng.normal(size=(1, 3136, rgb_dim)).astype(np.float32)
    # the JAX net's __call__ (its training losses) needs 768-wide inputs;
    # each stack initialises through ``generate`` instead
    parts = [net.init(jax.random.PRNGKey(i), jnp.asarray(f), t, method="generate")
             for i, (f, t) in enumerate(((rgb, "xyz"), (xyz, "rgb")))]
    variables = _randomize({c: {**parts[0][c], **parts[1][c]}
                            for c in ("params", "batch_stats")})
    port = _port(th.FtoFConv(xyz_dim, rgb_dim), names.to_torch(names.ftof_conv(), variables))
    for feat, out_type in ((rgb, "xyz"), (xyz, "rgb")):
        want = net.apply(variables, jnp.asarray(feat), out_type, method="generate")
        got = port.generate(torch.from_numpy(feat), out_type)
        assert got.shape == (1, 3136, 768)
        _close(got.detach().numpy(), want)


@pytest.mark.parametrize("flavour", ["mlp", "conv"])
def test_ftoi_nets(rng, flavour):
    in_dim, out_size = 24, 64
    net = (jh.FtoIMlp if flavour == "mlp" else jh.FtoIConv)(in_dim, out_size=out_size)
    feat = rng.normal(size=(2, 3136, in_dim)).astype(np.float32)
    variables = _randomize(net.init(jax.random.PRNGKey(0), jnp.asarray(feat)))
    if flavour == "mlp":
        port = _port(th.FtoIMlp(in_dim, out_size=out_size),
                     names.to_torch(names.ftoi_mlp(), variables))
    else:
        port = _port(th.FtoIConv(in_dim, out_size=out_size),
                     names.to_torch(names.ftoi_conv(), variables))
    want = net.apply(variables, jnp.asarray(feat))
    got = port(torch.from_numpy(feat))
    assert got.shape == (2, out_size, out_size, 3)
    _close(got.detach().numpy(), want)


@pytest.mark.parametrize("flavour", ["mlp", "conv"])
def test_ftoi_nets_one_channel(rng, flavour):
    """``out_channels=1`` (the trainer's ``estimate_depth``), JAX variables
    carried across: the table takes the width from the arrays."""
    in_dim, out_size = 24, 64
    jax_cls, port_cls, table = ((jh.FtoIMlp, th.FtoIMlp, names.ftoi_mlp())
                                if flavour == "mlp" else
                                (jh.FtoIConv, th.FtoIConv, names.ftoi_conv()))
    net = jax_cls(in_dim, out_channels=1, out_size=out_size)
    feat = rng.normal(size=(2, 3136, in_dim)).astype(np.float32)
    variables = _randomize(net.init(jax.random.PRNGKey(0), jnp.asarray(feat)))
    port = _port(port_cls(in_dim, out_channels=1, out_size=out_size), names.to_torch(table, variables))
    want = net.apply(variables, jnp.asarray(feat))
    got = port(torch.from_numpy(feat))
    assert got.shape == want.shape == (2, out_size, out_size, 1)
    _close(got.detach().numpy(), want)


def test_hrnet(rng):
    out_dim = 16
    net = JaxHRNet(out_dim)
    img = rng.normal(size=(2, 64, 64, 3)).astype(np.float32)
    variables = _randomize(net.init(jax.random.PRNGKey(0), jnp.asarray(img)))
    port = _port(HRNet(out_dim), names.to_torch(names.hrnet(), variables))
    want = net.apply(variables, jnp.asarray(img))
    got = port(torch.from_numpy(img))
    assert got.shape == (2, 16, 16, out_dim)
    _close(got.detach().numpy(), want)


def test_nets_compute_in_bfloat16(rng):
    """A bfloat16 net computes in bfloat16 from float32 parameters and
    stays within bfloat16 resolution of the float32 net."""
    net = th.FtoFMlp(16, 16)
    from cmdiad_tpu_torch.models.backbone import init_weights
    init_weights(net, 0, fan_in_scaled=True)
    half = th.FtoFMlp(16, 16, dtype=torch.bfloat16)
    half.load_state_dict(net.state_dict())
    x = torch.from_numpy(rng.normal(size=(1, 3136, 16)).astype(np.float32))
    want = net.generate(x, "xyz").detach()
    got = half.generate(x, "xyz").detach()
    assert got.dtype == torch.bfloat16 and half.xyz_norm.weight.dtype == torch.float32
    assert float((got.float() - want).abs().max()) <= 2 ** -5 * float(want.abs().max())
