"""Build, load and count the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface and loads through ``ctypes``.  The libraries land
in ``_build/`` beside this file (git-ignored), keyed by a hash of the
source, the shared headers (``csrc/*.cuh``) and the flags, so an unchanged
kernel is built once per checkout.
Every source is compiled by its own ``nvcc`` process, all started together,
at the first launch of any kernel (or by ``build_all``), under a file lock
in ``_build/`` so that ranks starting together build each library once.
Nothing is built or loaded at import time.

``LAUNCHES`` counts, per kernel, the launches that went through ``launch``:
a run can reset it, drive a path, and read which kernels that path used.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")

_P, _I = ctypes.c_void_p, ctypes.c_int
_L, _F, _D = ctypes.c_longlong, ctypes.c_float, ctypes.c_double
# kernel -> (C entry point, argument types before the trailing stream,
#            extra nvcc flags).  FPS, the interpolation and DBSCAN keep
#            their distance arithmetic free of FMA contraction so that their
#            selections match the plain versions exactly, and the OCSVM
#            steps round every operation as JAX does (the int8 bank-min
#            rounds each operation with intrinsics instead).
_KERNELS = {
    "fps": ("fps_launch", (_P, _P, _I, _I, _I, _I, _P), ("--fmad=false",)),
    "interp": ("three_nn_interp_launch",
               (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _I),
               ("--fmad=false",)),
    "bank_min": ("bank_min_launch", (_P, _P, _P, _I, _I, _I, _P), ()),
    "bank_min_int8": ("bank_min_int8_launch",
                      (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _I), ()),
    "flash_attn": ("flash_attn_launch",
                   (_P, _P, _P, _P, _I, _I, _I, _L, _L, _F, _I), ()),
    "int8_dot": ("int8_dot_launch", (_P, _P, _P, _I, _I, _I, _I), ()),
    "dbscan": ("dbscan_launch", (_P, _P, _P, _P, _P, _I, _D, _I, _P, _P, _P),
               ("--fmad=false",)),
    "ocsvm_sgd": ("ocsvm_sgd_launch", (_P, _L, _I, _F, _F, _F, _P),
                  ("--fmad=false",)),
}

LAUNCHES: Dict[str, int] = {name: 0 for name in _KERNELS}
_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return path


def _target(name: str, ptxas_verbose: bool):
    src = CSRC / f"{name}.cu"
    flags = [*ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
             "-fPIC", *_KERNELS[name][2]]
    # the register report changes no code: the library's name leaves it out
    so = BUILD_DIR / f"lib{name}-{_digest(src, flags)}.so"
    return src, flags + ["-Xptxas=-v"] * ptxas_verbose, so


def _digest(src: Path, flags) -> str:
    """Hash of the source, every header in ``csrc/`` (a header edit must
    rebuild the kernels that include it) and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build_all(ptxas_verbose: bool = False) -> Dict[str, str]:
    """Compile every kernel source not yet built (one ``nvcc`` each, all in
    parallel) and load the libraries.  Returns the compiler's diagnostics
    per kernel (the register/shared-memory report with ``ptxas_verbose``).
    Raises with the compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with open(BUILD_DIR / "lock", "w") as lock:
        # another process of this checkout (a rank) may be building: wait
        # for it and load what it built
        fcntl.flock(lock, fcntl.LOCK_EX)
        return _build_locked(nvcc, ptxas_verbose)


def _build_locked(nvcc: str, ptxas_verbose: bool) -> Dict[str, str]:
    procs, outputs = {}, {}
    for name in _KERNELS:
        src, flags, so = _target(name, ptxas_verbose)
        if so.exists() and not ptxas_verbose:
            outputs[name] = ""
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *flags, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, so)
    failed = []
    for name, (proc, tmp, so) in procs.items():
        out, _ = proc.communicate()
        outputs[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    for name, (symbol, argtypes, _) in _KERNELS.items():
        lib = ctypes.CDLL(str(_target(name, ptxas_verbose)[2]))
        fn = getattr(lib, symbol)
        fn.argtypes = [*argtypes, _P]
        fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return outputs


def library(name: str) -> ctypes.CDLL:
    """Kernel ``name``'s loaded library (built at first use), for the
    entry points beside its launcher."""
    if name not in _LIBS:
        build_all()
    return _LIBS[name]


def launch(name: str, *args) -> None:
    """Call kernel ``name``'s C launcher on the current CUDA stream.  The
    launcher returns ``cudaGetLastError()`` after the launch; a non-zero
    code raises here.  Counts the launch in ``LAUNCHES``."""
    fn = getattr(library(name), _KERNELS[name][0])
    stream = torch.cuda.current_stream().cuda_stream
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")
    LAUNCHES[name] += 1


def check_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                      shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (None entries match any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(shape) != t.dim() or any(
            s is not None and s != ts for s, ts in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
