"""Rank functions of the port's multi-device CPU tests.

``cmdiad_tpu_torch.parallel.launch.spawn`` runs them by name in fresh
processes, one a rank, gloo on the CPU; each returns numpy results for the
test process to compare.  This module imports no JAX: the ranks never
load it.  Each rank computes with one intra-op thread.  With two, a
detection rank's float32 results were not reproducible: serving one saved
state again and again, about one serve in ten computed the first
batch's exact bank distances wrong in a few hundred rows (up to 3e-4
relative, image scores up to 2e-4 apart), the same call on the same
tensors right again just after; with one thread none of 50 serves did.
That moved the served predictions past the 1e-5 their tests allow.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

from cmdiad_tpu_torch.config import Config, TrainConfig
from cmdiad_tpu_torch.data.loader import stack_batches
from cmdiad_tpu_torch.data.synthetic import make_synthetic_samples
from cmdiad_tpu_torch.methods.registry import build_fusion, build_method
from cmdiad_tpu_torch.models import names
from cmdiad_tpu_torch.models.backbone import DualBackbone, load_jax_params
from cmdiad_tpu_torch.models.hallucination import sync_batch_norm
from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
from cmdiad_tpu_torch.models.vit import ViTConfig
from cmdiad_tpu_torch.parallel.eval import dp_score_batch, sharded_bank_min_dist
from cmdiad_tpu_torch.parallel.mesh import make_mesh, shard_batch, shard_rows
from cmdiad_tpu_torch.runner import CMDIADRunner
from cmdiad_tpu_torch.train.checkpoint import flatten
from cmdiad_tpu_torch.train.distill import DistillTrainer


def _world_mesh(device):
    torch.set_num_threads(1)
    return make_mesh((dist.get_world_size(),), device)


# ------------------------------------------------------------------ ops ---

def sharded_min(device, bank, patch, metrics, n_valid):
    """metric -> (values, rows) of ``sharded_bank_min_dist`` over ``bank``
    sharded across the ranks."""
    mesh = _world_mesh(device)
    local = shard_rows(torch.from_numpy(bank), mesh)
    q = torch.from_numpy(patch)
    return {m: tuple(t.numpy() for t in sharded_bank_min_dist(mesh, q, local, m, n_valid))
            for m in metrics}


def dp_score(device, patches, bank, feat_hw, out_size):
    """``dp_score_batch`` of this rank's block of ``patches``."""
    mesh = _world_mesh(device)
    block, _ = shard_batch(torch.from_numpy(patches), mesh)
    s, m = dp_score_batch(mesh, block, torch.from_numpy(bank), feat_hw, out_size=out_size)
    return s.numpy(), m.numpy()


def mesh_of(device, shapes):
    """For each shape, ``make_mesh(shape)``'s size or its refusal."""
    torch.set_num_threads(1)
    out = []
    for shape in shapes:
        try:
            out.append(make_mesh(shape, device).size)
        except ValueError as e:
            out.append(str(e))
    return out


# ------------------------------------------------------------ detection ---

def _backbone(device, vit, pm, params):
    bb = DualBackbone(vit_config=ViTConfig(**vit), pm_config=PointMAEConfig(**pm),
                      device=device)
    load_jax_params(bb, params)
    return bb


def _predict(method, test, batch_size):
    method.reset_predictions()
    for batch in stack_batches(test, batch_size):
        method.predict_batch(batch)
    return (method.calculate_metrics(), np.asarray(method.image_preds),
            np.stack(method.predictions))


def _fusion(device, cfg, bb, fusion_sd):
    if fusion_sd is None:
        return None
    fusion = build_fusion(cfg, bb, device)
    fusion.load_state_dict(fusion_sd)
    return fusion


def detect(device, cfg_kw, vit, pm, params, samples_kw, fusion_sd=None, save=None):
    """A method of ``Config(**cfg_kw)`` on this rank: its own fit, then its
    evaluation ``(metrics, image scores, maps)`` under "own"; on rank 0 the
    same for one device (no mesh, this process) under "one".  With
    ``save`` the own fit is written there (rank 0 writes) and served again
    by a fresh method under "reloaded"."""
    torch.set_num_threads(1)
    bb = _backbone(device, vit, pm, params)
    train, test = make_synthetic_samples(**samples_kw)
    out = {}
    runs = [("own", cfg_kw)]
    if dist.get_rank() == 0:
        runs.append(("one", dict(cfg_kw, mesh_shape=(), shard_bank=False)))
    for tag, kw in runs:
        cfg = Config(**kw)
        fusion = _fusion(device, cfg, bb, fusion_sd)
        runner = CMDIADRunner(cfg, backbone=bb, device=device, fusion=fusion)
        runner.fit("widget", train)
        out[tag] = _predict(runner.method, test, cfg.batch_size)
        if tag == "own":
            mesh = runner.method.mesh
            out["mesh"] = None if mesh is None else (mesh.shape, mesh.rank)
            out["bank_rows"] = {n: tuple(b.shape) for n, b in runner.method.banks.items()}
            if save:
                runner.method.save_state(save)
                fresh = build_method(cfg, backbone=bb, fusion=fusion)
                fresh.load_state(save)
                out["reloaded"] = _predict(fresh, test, cfg.batch_size)
    return out


def serve(device, cfg_kw, vit, pm, params, samples_kw, state, fusion_sd=None):
    """The fitted state ``state`` served by a method of ``Config(**cfg_kw)``
    on this rank: the evaluation ``(metrics, image scores, maps)``."""
    torch.set_num_threads(1)
    cfg = Config(**cfg_kw)
    bb = _backbone(device, vit, pm, params)
    method = build_method(cfg, backbone=bb, fusion=_fusion(device, cfg, bb, fusion_sd))
    method.load_state(state)
    return _predict(method, make_synthetic_samples(**samples_kw)[1], cfg.batch_size)


# ------------------------------------------------------------- training ---

def to_float64(trainer) -> None:
    """The trainer's net and optimizer state in float64, in place."""
    trainer.net.double()
    trainer.net.dtype = torch.float64
    for state in (trainer.opt.mu, trainer.opt.nu, trainer.opt.acc):
        for k in state:
            state[k] = state[k].double()


def _flat_state(trainer):
    return {k: np.asarray(v) for k, v in
            flatten(names.to_flax(trainer.table, trainer.net.state_dict())).items()}


def first_step(trainer):
    """Loss, aux losses and gradients of the trainer's first batch (this
    rank's block of it on a mesh), and the BatchNorm statistics after it."""
    batch = next(trainer._batches(trainer.arrays, np.random.default_rng(trainer.cfg.seed),
                                  trainer.cfg.batch_size))
    loss, aux, grads = trainer.loss_and_grads(batch)
    stats = {k: v for k, v in _flat_state(trainer).items() if k.startswith("batch_stats")}
    return (float(loss), {k: float(v) for k, v in aux.items()},
            {k: g.numpy() for k, g in grads.items()}, stats)


def train(device, kw, feature_dim, arrays, test_arrays, out_dir):
    """DP training on this rank of ``TrainConfig(**kw)``: the first step's
    loss, gradients and BatchNorm statistics in float32 and the gradients
    in float64; one float32 run writing checkpoints under ``out_dir``, and
    where ``resume='auto'`` then starts; float64 runs with the BatchNorm
    moments over the global batch and over this rank's block alone."""
    torch.set_num_threads(1)
    cfg = TrainConfig(**kw)
    a64 = {k: v.astype(np.float64) for k, v in arrays.items()}

    def trainer(c=cfg, a=arrays):
        return DistillTrainer(c, feature_dim, arrays=a, test_arrays=test_arrays, device=device)

    out = {"step32": first_step(trainer())}
    t = trainer(a=a64)
    to_float64(t)
    out["grads64"] = first_step(t)[2]
    t = trainer(cfg.replace(output_dir=out_dir, save_every=1))
    res = t.train()
    out["history"], out["params32"] = res.history, _flat_state(t)
    out["resumed_at"] = trainer(cfg.replace(output_dir=out_dir, resume="auto",
                                            epochs=cfg.epochs + 1)).start_epoch
    for tag, synced in (("params64", True), ("params64_local_bn", False)):
        t = trainer(a=a64)
        to_float64(t)
        if not synced:
            sync_batch_norm(t.net, None)
        out[f"history_{tag}"] = t.train().history
        out[tag] = _flat_state(t)
    out["files"] = sorted(os.listdir(out_dir)) if dist.get_rank() == 0 else None
    return out


# ------------------------------------------------------------ on a card ---

def sharded_min_launches(device, bank, patch, metrics):
    """metric -> (values, rows, launches of its kernel, the bank rows each
    launch was given) of ``sharded_bank_min_dist`` on this rank's shard."""
    from cmdiad_tpu_torch import kernels
    mesh = _world_mesh(device)
    local = shard_rows(torch.from_numpy(bank).to(device), mesh)
    q = torch.from_numpy(patch).to(device)
    rows_arg = {"bank_min": 4, "bank_min_int8": 6}   # the C launchers' bank-rows argument
    launch, seen = kernels.launch, []

    def recording(name, *args):
        seen.append((name, args[rows_arg[name]]))
        launch(name, *args)
    kernels.launch = recording
    out = {}
    try:
        for m in metrics:
            seen.clear()
            v, i = sharded_bank_min_dist(mesh, q, local, m)
            out[m] = (v.cpu().numpy(), i.cpu().numpy(), list(seen))
    finally:
        kernels.launch = launch
    return out
