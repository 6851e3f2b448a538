"""MTFI distillation training, whole runs: the port's trainer and CLI
against the JAX package's, checkpoints across the two packages, and the
trainer's behaviour (NaN abort, ``resume='auto'``, refusals,
``estimate_depth``).  Starting weights, data and tolerances as in
``test_torch_train.py``: each epoch's losses rtol 1e-4, final parameters
max|Δ| <= 1e-3 * max|p| a leaf."""

import json
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cmdiad_tpu import cli as jax_cli
from cmdiad_tpu.config import Config as JaxConfig
from cmdiad_tpu.config import TrainConfig as JaxTrainConfig
from cmdiad_tpu.data.feature_store import FeatureStore
from cmdiad_tpu.methods import registry as jax_registry
from cmdiad_tpu.train.checkpoint import _flatten as jax_flatten
from cmdiad_tpu.train.checkpoint import save_pytree as jax_save_pytree
from cmdiad_tpu.train.distill import DistillTrainer as JaxTrainer
from cmdiad_tpu_torch import cli
from cmdiad_tpu_torch.config import Config, TrainConfig
from cmdiad_tpu_torch.methods import registry
from cmdiad_tpu_torch.train.checkpoint import flatten
from cmdiad_tpu_torch.train.distill import DistillTrainer
from test_torch_train import BASE, FTOF, W, _ftoi_arrays, _leaf_close, ftof_arrays, pair

torch.set_num_threads(2)

# -- whole runs ---------------------------------------------------------------

RUNS = {"adam": {}, "weight_decay": dict(weight_decay=0.01), "accum2": dict(accum_iter=2),
        "accum2_wd": dict(accum_iter=2, weight_decay=0.01), "accum3": dict(accum_iter=3)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> (JAX result, port result, their output dirs, kw, arrays):
    FtoFMlp at width 16, 16 train and 8 test samples, batch 4, 3 epochs,
    warmup 1, a checkpoint every epoch."""
    rng = np.random.default_rng(1)
    arrays, test_arrays = ftof_arrays(rng, 16), ftof_arrays(rng, 8)
    out = {}
    for name, extra in RUNS.items():
        tmp = tmp_path_factory.mktemp(name)
        kw = dict(BASE, train_method=FTOF, save_every=1, **extra)
        jt, pt = pair(tmp, dict(kw, output_dir=str(tmp / "port")), W, arrays, test_arrays,
                      jax_kw=dict(output_dir=str(tmp / "jax")))
        out[name] = (jt.train(), pt.train(), tmp, kw, (arrays, test_arrays))
    return out


@pytest.mark.parametrize("name", list(RUNS))
def test_whole_run_matches_jax(runs, name):
    rj, rp, tmp, _, _ = runs[name]
    for k in ("train_loss", "test_loss"):
        assert len(rp.history[k]) == 3
        np.testing.assert_allclose(rp.history[k], rj.history[k], rtol=1e-4)
    want = jax_flatten(jax.device_get(rj.params))
    got = flatten(rp.params)
    assert set(got) == set(want)
    for k in want:
        _leaf_close(got[k], want[k], 1e-3, k)
    records = [[json.loads(ln) for ln in open(tmp / d / "metrics.jsonl")]
               for d in ("port", "jax")]
    assert [list(r) for r in records[0]] == [list(r) for r in records[1]]
    assert list(records[0][0]) == ["epoch", "train_loss", "test_loss", "epoch_s",
                                   "train_loss_rgb", "train_loss_xyz", "test_loss_rgb",
                                   "test_loss_xyz"]
    for a, b in zip(*records):
        for k in a:
            if k not in ("epoch", "epoch_s"):
                np.testing.assert_allclose(a[k], b[k], rtol=1e-4)


@pytest.mark.parametrize("name", ["adam", "weight_decay", "accum2"])
def test_checkpoint_keys_match_jax(runs, name):
    _, _, tmp, _, _ = runs[name]
    files = [np.load(tmp / d / "checkpoint-1.npz") for d in ("port", "jax")]
    specs = [{k: (z[k].shape, z[k].dtype) for k in z.files if k != "__meta__"} for z in files]
    assert specs[0] == specs[1]
    counts = [k for k in specs[0] if k.endswith(("count", "mini_step", "gradient_step"))]
    assert counts and all(specs[0][k] == ((), np.int32) for k in counts)
    assert all(k.split("\x1f")[0] in ("params", "opt_state") for k in specs[0])
    meta = [json.loads(bytes(z["__meta__"]).decode()) for z in files]
    assert meta[0] == meta[1] == {"epoch": 1, "train_method": FTOF}


@pytest.mark.parametrize("name", ["adam", "accum3"])
def test_checkpoints_resume_across_packages(runs, name, tmp_path):
    """The JAX trainer resumes the port's ``checkpoint-1.npz``, the port the
    JAX one; the further epoch (in the order of a fresh run's first epoch,
    as both trainers reseed) agrees."""
    _, _, tmp, kw, (arrays, test_arrays) = runs[name]
    kw = dict(kw, epochs=3, save_every=100)
    jt = JaxTrainer(JaxTrainConfig(**kw, mesh_shape=(1,),
                                   resume=str(tmp / "port" / "checkpoint-1.npz")),
                    W, arrays=arrays, test_arrays=test_arrays)
    pt = DistillTrainer(TrainConfig(**kw, resume=str(tmp / "jax" / "checkpoint-1.npz")),
                        W, arrays=arrays, test_arrays=test_arrays, device="cpu")
    assert jt.start_epoch == pt.start_epoch == 2
    rj, rp = jt.train(), pt.train()
    for k in ("train_loss", "test_loss"):
        assert len(rp.history[k]) == 1
        np.testing.assert_allclose(rp.history[k], rj.history[k], rtol=1e-4)
    want, got = jax_flatten(jax.device_get(rj.params)), flatten(rp.params)
    for k in want:
        _leaf_close(got[k], want[k], 1e-3, k)


def test_port_checkpoint_serves_as_fusion_module_path(runs, rng):
    """The port's training checkpoint (``opt_state`` included) as
    ``fusion_module_path`` in both packages' ``build_fusion``: the same
    hallucinated features."""
    _, _, tmp, _, _ = runs["adam"]
    path = str(tmp / "port" / "checkpoint-2.npz")
    widths = SimpleNamespace(pm_config=SimpleNamespace(out_dim=W),
                             vit_config=SimpleNamespace(embed_dim=W))
    kw = dict(method_name="WithHallucination", main_modality="xyz", use_hn=True,
              fusion_module_path=path)
    jnet, jvars = jax_registry.build_fusion(JaxConfig(**kw), widths)
    net = registry.build_fusion(Config(**kw), widths, "cpu")
    feat = rng.normal(size=(2, 3136, W)).astype(np.float32)
    for out_type in ("rgb", "xyz"):
        want = np.asarray(jnet.apply(jvars, jnp.asarray(feat), out_type, method="generate"))
        with torch.no_grad():
            got = net.generate(torch.from_numpy(feat), out_type).numpy()
        _leaf_close(got, want, 1e-5, out_type)


# -- trainer behaviour ----------------------------------------------------------

def test_nan_loss_aborts(rng):
    arrays = ftof_arrays(rng, 8, tokens=16)
    arrays["patch"][0, 0, 0] = np.nan
    trainer = DistillTrainer(TrainConfig(**dict(BASE, train_method=FTOF, epochs=1)), W,
                             arrays=arrays, test_arrays=ftof_arrays(rng, 4, tokens=16),
                             device="cpu")
    with pytest.raises(FloatingPointError):
        trainer.train()


def test_auto_resume(rng, tmp_path):
    """``resume='auto'``: a fresh start without a checkpoint, then the
    newest epoch's checkpoint."""
    arrays, test_arrays = ftof_arrays(rng, 8, tokens=16), ftof_arrays(rng, 4, tokens=16)
    cfg = TrainConfig(**dict(BASE, train_method=FTOF, epochs=3, save_every=1,
                             output_dir=str(tmp_path), resume="auto"))
    t0 = DistillTrainer(cfg, W, arrays=arrays, test_arrays=test_arrays, device="cpu")
    assert t0.start_epoch == 0
    t0.train()
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-0.npz", "checkpoint-1.npz",
                                            "checkpoint-2.npz", "metrics.jsonl"]
    t1 = DistillTrainer(cfg.replace(epochs=5), W, arrays=arrays, test_arrays=test_arrays,
                        device="cpu")
    assert t1.start_epoch == 3 and t1.opt.count == t0.opt.count == 6
    for k, p in t1.params.items():
        assert torch.equal(p, t0.params[k]), k
    assert len(t1.train().history["train_loss"]) == 2


def test_mesh_shape_is_not_ported():
    """A data-parallel mesh needs a process group: without one it raises
    and names torchrun (``test_torch_parallel_train.py`` trains on one)."""
    with pytest.raises(RuntimeError, match="torchrun --nproc_per_node 2"):
        DistillTrainer(TrainConfig(mesh_shape=(2,)), W, arrays={}, test_arrays={},
                       device="cpu")


def test_resume_refuses_another_nets_checkpoint(runs, rng):
    _, _, tmp, _, _ = runs["adam"]
    cfg = TrainConfig(**dict(BASE, train_method=FTOF, mlp_depth=2,
                             resume=str(tmp / "port" / "checkpoint-1.npz")))
    with pytest.raises(ValueError, match="does not match"):
        DistillTrainer(cfg, W, arrays=ftof_arrays(rng, 4, tokens=4),
                       test_arrays=ftof_arrays(rng, 4, tokens=4), device="cpu")


def test_estimate_depth_trains_a_one_channel_net(tmp_path, rng):
    """``estimate_depth``: a 1-channel FtoI MLP, one epoch in each package."""
    arrays = _ftoi_arrays(rng, 4, 8)
    kw = dict(BASE, train_method="RGBFeatureToXYZInputMLP", estimate_depth=True, epochs=1,
              batch_size=2, warmup_epochs=0)
    jt, pt = pair(tmp_path, kw, 8, arrays)
    assert pt.net.mlp[6].out_features == 1
    rj, rp = jt.train(), pt.train()
    for k in ("train_loss", "test_loss"):
        np.testing.assert_allclose(rp.history[k], rj.history[k], rtol=1e-4)
    assert rp.params["mlp_3"]["kernel"].shape == (96, 1)


def _dump(root, rng, n_train=8, n_test=4, width=768):
    """FtoF dumps at the CLI's feature width (768; neither CLI takes
    another), 16 tokens a sample."""
    store = FeatureStore(str(root))
    for split, n in (("train", n_train), ("test", n_test)):
        patch = ftof_arrays(rng, n, width, tokens=16)["patch"]
        for i in range(n):
            store.save(split, f"s{i:02d}", patch=patch[i])
    return str(root)


def test_cli_train_prints_the_jax_cli_record(tmp_path, rng, capsys):
    """Both CLIs resume the JAX trainer's initial weights (``--resume``)
    and print the same record; a finished run resumed with ``auto`` prints
    ``already complete``."""
    data = _dump(tmp_path / "dumps", rng)
    args = ["--train_method", FTOF, "--data_path", data, "--epochs", "2",
            "--batch_size", "4", "--warmup_epochs", "1", "--blr", "0.02", "--seed", "0",
            "--save_every", "1"]
    init = JaxTrainer(JaxTrainConfig(train_method=FTOF, data_path=data, batch_size=4,
                                     mesh_shape=(1,)))
    jax_save_pytree(str(tmp_path / "init.npz"), {"params": jax.device_get(init.params)},
                    meta={"epoch": -1})
    args += ["--resume", str(tmp_path / "init.npz")]
    jax_cli.main(["train", *args, "--output_dir", str(tmp_path / "jax"), "--mesh_shape", "1"])
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = cli.main(["train", *args, "--output_dir", str(tmp_path / "port"),
                    "--device", "cpu"])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    assert list(got) == list(want) == ["final_train_loss", "final_test_loss"]
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)
    done = cli.main(["train", *args[:-2], "--output_dir", str(tmp_path / "port"),
                     "--device", "cpu", "--resume", "auto"])
    assert done == {"status": "already complete", "start_epoch": 2, "epochs": 2}
