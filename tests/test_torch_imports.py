"""Package rules of the PyTorch port (``cmdiad_tpu_torch``).

* it imports neither JAX nor anything of the JAX package, nor Pillow or
  pandas (the card machine has neither), checked twice: statically over
  every module, and in a fresh interpreter;
* its entry points default to the card and refuse to run without one
  instead of moving to the CPU;
* its ``Config`` is the JAX package's field for field, so the fitted-state
  fingerprints agree.
"""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "cmdiad_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "cmdiad_tpu", "PIL", "pandas")


def _forbidden(module: str) -> bool:
    return any(module == f or module.startswith(f + ".") for f in FORBIDDEN)


def test_no_jax_or_jax_package_import_in_sources():
    offenders = []
    files = sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
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
        "import cmdiad_tpu_torch.runner\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'cmdiad_tpu', 'PIL', 'pandas')\n"
        "       or m.startswith(('jax.', 'flax.', 'cmdiad_tpu.', 'PIL.', 'pandas.'))]\n"
        "print(len([m for m in sys.modules if m.startswith('cmdiad_tpu_torch')]))\n"
        "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) > 10


@pytest.mark.parametrize("build", ["backbone", "runner", "device"])
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
    """The MTFI methods are not ported yet: their presets build a Config,
    and ``build_method`` refuses it before building a backbone."""
    from cmdiad_tpu_torch.config import method_preset
    from cmdiad_tpu_torch.methods.registry import build_method
    with pytest.raises(NotImplementedError, match="not yet ported"):
        build_method(method_preset(preset), device="cpu")
