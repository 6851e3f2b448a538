"""One run of one cell: set-up, warm-up, the window, the traced stretch,
the check, the result.

Set-up makes the pool and the weights from the seed, builds the fitted
state with the reference on the card and writes it in the port's npz
layout; then it builds the port as a line does (``build_backbone``,
``build_fusion``, its sizes checked against the configuration's, each
model's checkpoint loaded as its file in ``perfbench/model_parts/`` says,
a ``CMDIADRunner`` whose ``fit`` serves the state from ``bank_cache_dir``)
and warms the cell's own shapes up with a few calls.  ``setup_s`` runs
from the process's start to the first timed call.  After the window the
program is freed and the reference checks the sampled answers.
"""

from __future__ import annotations

import gc
import os
import statistics
import subprocess
import sys
import time
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch

from perfbench.core import check, parts, serve, spec, state as state_mod, trace, weights as W

CACHE = spec.BENCH_DIR / ".cache"


def use_cache_dirs() -> None:
    """Every compiler cache at a fixed path inside the checkout (before
    CUDA starts)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(CACHE / sub)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclass
class LayerContext:
    """What a per-layer reader reads."""
    reduced: trace.Reduced
    calls: Dict[str, list]
    images: int
    config: dict
    measured_s_per_image: float


def card_name_and_power() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def _plain(v):
    return list(v) if isinstance(v, tuple) else v


def _check_shapes(config: dict, cfg, backbone, fusion) -> None:
    """The program runs the configuration's sides and, for each of its
    models, every width of the model's block (its part's ``NOT_WIDTHS``
    left out): the backbone holds the sizes of both backbones, also of one
    the window does not run."""
    want = {k: config[k] for k in ("rgb_size", "xyz_size", "gt_size")}
    have = {k: getattr(cfg, k) for k in want}
    for m in config["models"]:
        part = spec.model_part(m)
        runs = part.widths(backbone, fusion)
        for k, v in config[m].items():
            if k not in part.NOT_WIDTHS:
                want[f"{m}.{k}"], have[f"{m}.{k}"] = v, _plain(runs.get(k, "not run"))
    diff = {k: (want[k], have[k]) for k in want if want[k] != have[k]}
    if diff:
        raise ValueError(f"the program runs other sizes than the configuration: {diff}")


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device="cuda",
        t0: Optional[float] = None, overrides: Optional[dict] = None,
        numbers_out: Optional[dict] = None) -> dict:
    """One run; returns the result line's dict (``checks`` last).  Every
    number the check computed, compared or not, is put into ``numbers_out``."""
    from cmdiad_tpu_torch import kernels
    from cmdiad_tpu_torch.config import method_preset
    from cmdiad_tpu_torch.data.loader import stack_batches
    from cmdiad_tpu_torch.methods.registry import build_backbone, build_fusion
    from cmdiad_tpu_torch.runner import CMDIADRunner

    t0 = time.time() if t0 is None else t0
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    config, traffic = cell.config, cell.traffic
    seed = int(seed) % (2 ** 63)
    if traffic["size"] != config["xyz_size"]:
        raise ValueError(f"traffic size {traffic['size']} != the cloud's side {config['xyz_size']}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cuda:
        kernels.build_all()
    phases = {"kernels": time.time() - t0}

    pool = parts.make_parts(seed, traffic["pool"], traffic, traffic["defect_share"], "pool",
                            config["rgb_size"])
    phases["pool"] = time.time() - t0
    made = {m: W.make(m, config[m], seed, dev, i) for i, m in enumerate(config["models"])}
    phases["weights"] = time.time() - t0
    state = state_mod.build(config, traffic, made, seed, dev)
    _free(dev)
    phases["state"] = time.time() - t0

    cfg = method_preset(config["preset"], **{
        **config["overrides"], **(overrides or {}), "batch_size": traffic["batch"],
        "bank_cache_dir": str(CACHE / "state")})
    backbone = build_backbone(cfg, dev)
    fusion = build_fusion(cfg, backbone, dev)
    _check_shapes(config, cfg, backbone, fusion)
    for m in config["program_models"]:
        spec.model_part(m).load(backbone, fusion, made[m].numpy)
    runner = CMDIADRunner(cfg, backbone=backbone, device=dev, fusion=fusion)
    method = runner.method
    phases["program"] = time.time() - t0
    path = CACHE / "state" / "pool.npz"
    state_mod.write(state, str(path), "pool", method.state_fingerprint())
    phases["state_file"] = time.time() - t0
    runner.fit("pool")
    phases["fit_served"] = time.time() - t0
    os.remove(path)
    if "bank_load_s" not in runner.timings:
        raise RuntimeError("the fitted state was not served from bank_cache_dir")

    batches = list(stack_batches(pool, traffic["batch"]))
    checked = check.checked_parts(seed, len(pool), traffic["check_parts"])
    server = serve.Server(method, batches, set(checked))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    server.warm(traffic["warm_calls"])
    kernels.reset_launches()
    setup_s = time.time() - t0
    phases["warm"] = setup_s
    log("set-up, seconds from the process's start at the end of each phase: "
        + ", ".join(f"{k} {v:.3f}" for k, v in phases.items()))

    win = server.window(seconds)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    launches = {k: v / max(win.calls, 1) for k, v in kernels.LAUNCHES.items() if v}
    lat = sorted(win.latencies)
    log(f"window: {win.calls} calls, {win.images} parts, {win.passes} passes, "
        f"{win.seconds:.3f} s; latency median {1000 * statistics.median(lat):.3f} ms; "
        f"kernel launches a call {launches}; set-up {setup_s:.3f} s")

    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced:
        spans = trace.Spans(spec.spans())
        traced_images = [0]

        def stretch():
            for _ in range(traffic["trace_calls"]):
                traced_images[0] += server.call()
        spans.install()
        try:
            red = trace.reduce(trace.profile(stretch))
        finally:
            spans.remove()
        server.close()
        if red.busy_s <= 0:
            raise RuntimeError("the profiler saw no device operation in the traced stretch")
        log(f"trace: {red.kernels} device ops, busy {red.busy_s:.6f} s of "
            f"{red.window_s:.6f} s, device time with no launch matched "
            f"{red.unattributed_s:.6f} s, spans {red.span_device_s}")
        ctx = LayerContext(red, dict(spans.calls), traced_images[0], config,
                           win.seconds / max(win.images, 1))
        for m in cell.per_layer:
            value = spec.reader(m["name"]).read(ctx)
            if value is None:
                continue
            if m["unit"] == "%" and value > 100.0 and m["name"] != "device_idle_pct":
                raise RuntimeError(f"{m['name']} reads {value} %: the count or the time is wrong")
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=red.busy_s, window_s=red.window_s)
        breakdown = {"device_ops": [[n, s] for n, s in red.device_ops],
                     "idle_gaps": [[n, s] for n, s in red.idle_gaps]}
    else:
        e2e = {"images_per_s": win.images / win.seconds,
               "latency_ms_p95": 1000.0 * float(np.percentile(lat, 95)),
               "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": e2e[spec.base_name(m["name"], e2e)],
                                  "unit": m["unit"]}
    server.restore()

    last = server.last_pass
    if last is not None:
        method.image_preds, method.image_labels, method.pixel_preds, method.pixel_labels, \
            method.predictions, method.gts, method.img_paths = last
        log(f"metrics of the last whole pass: {method.calculate_metrics()}")
    answers = server.answers
    due = [i for i in checked if i in server.served]
    answers.banks = {i: (s.cpu(), m.cpu()) for i, (s, m) in answers.banks.items()}
    del runner, method, backbone, fusion, server, batches
    _free(dev)

    ref = check.reference_answers(config, made, state, {i: pool[i] for i in due}, dev)
    numbers = check.compare(answers, ref) if due else dict.fromkeys(check.NUMBERS, float("inf"))
    log(f"check numbers: {numbers}")
    if numbers_out is not None:
        numbers_out.update(numbers)
    limits = cell.limits
    correct = (win.failed == 0 and win.calls > 0
               and all(numbers[k] <= limits[k] for k in limits))
    result = {"correct": bool(correct), "attempted": win.calls, "failed": win.failed,
              "metrics": metrics, "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result
