"""Package rules of the PyTorch port (``cmdiad_tpu_torch``).

* it imports neither JAX nor anything of the JAX package, nor Pillow or
  pandas (the card machine has neither), checked twice: statically over
  every module, and in a fresh interpreter;
* its entry points (the trainer, ``cli train``, ``cli preprocess`` and
  ``cli preprocess-eyecandies`` among them) default to the card and refuse
  to run without one instead of moving to the CPU (``cli heatmap`` is host
  code);
* its ``Config`` is the JAX package's field for field, so the fitted-state
  fingerprints agree.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "cmdiad_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "cmdiad_tpu", "PIL", "pandas", "matplotlib", "yaml",
             "cv2", "imageio")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_no_jax_or_jax_package_import_in_sources():
    offenders = []
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    assert {PKG / "parallel" / f"{m}.py" for m in ("mesh", "launch", "eval", "dryrun")} <= set(files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [f"{path.relative_to(REPO)}: {n}" for n in names
                          if _forbidden(n)]
    assert not offenders, offenders


def test_forbidden_prefix_match_is_exact():
    assert _forbidden("cmdiad_tpu") and _forbidden("cmdiad_tpu.ops.fps")
    assert _forbidden("jax.numpy") and not _forbidden("jaxtyping")
    assert not _forbidden("cmdiad_tpu_torch.ops.fps")
    assert _forbidden("PIL.Image") and _forbidden("pandas")


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import cmdiad_tpu_torch\n"
        "for m in pkgutil.walk_packages(cmdiad_tpu_torch.__path__, 'cmdiad_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import cmdiad_tpu_torch.runner, cmdiad_tpu_torch.train.distill\n"
        "import cmdiad_tpu_torch.parallel.dryrun, cmdiad_tpu_torch.parallel.launch\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'cmdiad_tpu', 'PIL', 'pandas')\n"
        "       or m.startswith(('jax.', 'flax.', 'cmdiad_tpu.', 'PIL.', 'pandas.'))]\n"
        "print(len([m for m in sys.modules if m.startswith('cmdiad_tpu_torch')]))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) > 10


def test_cli_train_runs_without_jax(tmp_path):
    """``cli train`` in a fresh interpreter, on FtoF dumps at the CLI's
    768-wide features, loads no JAX module."""
    from cmdiad_tpu_torch.data.feature_store import FeatureStore
    rng = np.random.default_rng(0)
    store = FeatureStore(str(tmp_path / "dumps"))
    for split, n in (("train", 4), ("test", 2)):
        for i in range(n):
            store.save(split, f"s{i}", patch=rng.normal(size=(16, 1536)).astype(np.float32))
    code = (
        "import sys\n"
        "from cmdiad_tpu_torch import cli\n"
        f"cli.main(['train', '--data_path', {str(tmp_path / 'dumps')!r}, '--epochs', '1',\n"
        f"          '--batch_size', '2', '--output_dir', {str(tmp_path / 'out')!r},\n"
        "          '--device', 'cpu'])\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'optax', 'cmdiad_tpu')\n"
        "       or m.startswith(('jax.', 'flax.', 'optax.', 'cmdiad_tpu.'))]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "final_train_loss" in out.stdout


def test_parallel_dry_run_loads_no_jax(tmp_path):
    """``parallel.dryrun`` on two gloo CPU ranks from a fresh interpreter:
    the ranks import the port alone, and neither they nor the parent load
    JAX (each rank reports its modules)."""
    code = (
        "import sys\n"
        "from cmdiad_tpu_torch.parallel.dryrun import dryrun_multichip\n"
        "from cmdiad_tpu_torch.parallel.launch import spawn\n"
        "def jax_modules(device):\n"
        "    import cmdiad_tpu_torch.parallel.dryrun\n"
        "    return [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'cmdiad_tpu')]\n"
        "if __name__ == '__main__':\n"
        "    dryrun_multichip(2, 'gloo', ['cpu', 'cpu'])\n"
        "    bad = spawn(jax_modules, 2, 'gloo', ['cpu', 'cpu'])\n"
        "    bad.append([m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'cmdiad_tpu')])\n"
        "    assert not any(bad), bad\n")
    script = tmp_path / "dryrun_without_jax.py"     # spawned ranks import it by path
    script.write_text(code)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["OMP_NUM_THREADS"] = "1"
    env["PYTHONPATH"] = str(REPO)
    out = subprocess.run([sys.executable, str(script)], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "-- OK" in out.stdout


def test_cli_tail_runs_without_jax(tmp_path):
    """``cli preprocess``, ``preprocess-eyecandies`` and ``heatmap`` in a
    fresh interpreter, on small trees written here, load no JAX module."""
    from cmdiad_tpu_torch.data import png, tiffio
    from test_misc_coverage import _build_synthetic_eyecandies
    from test_preprocess import _scene
    rng = np.random.default_rng(0)
    pc, rgb, blob, _ = _scene(rng)
    for sub in ("xyz", "rgb", "gt"):
        (tmp_path / "mv" / sub).mkdir(parents=True)
    tiffio.imwrite(str(tmp_path / "mv" / "xyz" / "s.tiff"), pc)
    png.imwrite(tmp_path / "mv" / "rgb" / "s.png", rgb)
    png.imwrite(tmp_path / "mv" / "gt" / "s.png", (blob * 255).astype(np.uint8))
    _build_synthetic_eyecandies(rng, tmp_path / "eye", size=512, n_train=1, n_test=1)
    (tmp_path / "seg" / "c").mkdir(parents=True)
    np.savez_compressed(tmp_path / "seg" / "c" / "000.npz", s_map=rng.random((16, 16)),
                        gt=np.zeros((16, 16), np.float32))
    code = (
        "import sys\n"
        "from cmdiad_tpu_torch import cli\n"
        f"cli.main(['preprocess', '-d', {str(tmp_path / 'mv')!r}, '-n', '2', '--device', 'cpu'])\n"
        f"cli.main(['preprocess-eyecandies', '--dataset_path', {str(tmp_path / 'eye')!r},\n"
        f"          '--target_dir', {str(tmp_path / 'eye_mv')!r}, '--device', 'cpu'])\n"
        f"cli.main(['heatmap', '--seg_dir', {str(tmp_path / 'seg')!r},\n"
        f"          '--out_dir', {str(tmp_path / 'maps')!r}])\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'flax', 'cmdiad_tpu', 'PIL', 'matplotlib', 'yaml', 'cv2', 'imageio')]\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "preprocessed 1 tiffs" in out.stdout and "1 heatmaps rendered" in out.stdout
    assert len(list((tmp_path / "eye_mv").rglob("*.tiff"))) == 2
    assert tiffio.imread(str(tmp_path / "mv" / "xyz" / "s.tiff")).shape == (200, 200, 3)


@pytest.mark.parametrize("build", ["backbone", "runner", "device", "trainer", "cli_train",
                                   "cli_preprocess", "cli_eyecandies"])
def test_cuda_default_raises_without_a_card(build, monkeypatch):
    """No silent fallback: the default device is the card, and without one
    the entry points raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from cmdiad_tpu_torch.config import Config
    from cmdiad_tpu_torch.device import resolve_device
    from cmdiad_tpu_torch.models.backbone import DualBackbone
    from cmdiad_tpu_torch.models.vit import ViTConfig
    from cmdiad_tpu_torch.runner import CMDIADRunner
    with pytest.raises(RuntimeError, match="cuda"):
        if build == "backbone":
            DualBackbone(vit_config=ViTConfig(img_size=16, embed_dim=8, depth=1,
                                              num_heads=1))
        elif build == "runner":
            CMDIADRunner(Config(rgb_size=16))
        elif build == "trainer":
            from cmdiad_tpu_torch.config import TrainConfig
            from cmdiad_tpu_torch.train.distill import DistillTrainer
            DistillTrainer(TrainConfig(), arrays={}, test_arrays={})
        elif build == "cli_train":
            from cmdiad_tpu_torch import cli
            cli.main(["train", "--data_path", "unused"])
        elif build == "cli_preprocess":
            from cmdiad_tpu_torch import cli
            cli.main(["preprocess", "--dataset_path", "unused"])
        elif build == "cli_eyecandies":
            from cmdiad_tpu_torch import cli
            cli.main(["preprocess-eyecandies", "--dataset_path", "unused",
                      "--target_dir", "unused"])
        else:
            resolve_device()


def test_cpu_entry_point_switches_tf32_off():
    from cmdiad_tpu_torch.device import resolve_device
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_kernel_wrappers_refuse_cpu_tensors_for_the_kernel():
    """A kernel wrapper's CUDA path checks its operands; a CPU tensor never
    reaches a launch (it takes the plain version one level up)."""
    from cmdiad_tpu_torch import kernels
    with pytest.raises(ValueError, match="CUDA"):
        kernels.check_cuda_tensor(torch.zeros(4), "x", torch.float32, (4,))


def test_config_matches_the_jax_package():
    from cmdiad_tpu.config import METHOD_NAMES as JAX_METHODS
    from cmdiad_tpu.config import Config as JaxConfig
    from cmdiad_tpu_torch.config import METHOD_NAMES, Config
    assert METHOD_NAMES == JAX_METHODS
    ours = {f.name: f.default for f in dataclasses.fields(Config)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert ours == theirs
    with pytest.raises(ValueError):
        Config(method_name="nope").validate()
    with pytest.raises(ValueError):
        Config(dist_method_s="l3").validate()


@pytest.mark.parametrize("preset", ["mtfi_ftof_xyz_main", "mtfi_itof_rgb_main",
                                    "mtfi_ftoi_xyz_main"])
def test_unported_methods_raise(preset):
    """The MTFI presets, once refused, now build on the CPU with the tiny
    backbones and a seeded random fusion net, fit two samples and predict
    one batch of two."""
    from cmdiad_tpu_torch.config import method_preset
    from cmdiad_tpu_torch.data.synthetic import make_synthetic_samples
    from cmdiad_tpu_torch.runner import CMDIADRunner
    cfg = method_preset(preset, rgb_backbone_name="tiny", xyz_backbone_name="tiny",
                        rgb_size=64, xyz_size=64, gt_size=64, num_group=32,
                        group_size=16, f_coreset=1.0, batch_size=2)
    runner = CMDIADRunner(cfg, device="cpu")
    assert runner.method.fusion is not None
    train, test = make_synthetic_samples(n_train=2, n_test_good=1, n_test_bad=1,
                                         size=64, anomaly_radius=(0.13, 0.18))
    runner.fit("widget", train)
    metrics = runner.evaluate("widget", test)
    assert all(0.0 <= v <= 1.0 for v in metrics.values()), metrics
    assert np.stack(runner.method.predictions).shape == (2, 64, 64)
