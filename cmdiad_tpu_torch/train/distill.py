"""MTFI cross-modal distillation training (the JAX package's
``train/distill.py``; the reference's ``hallucination_network_pretrain.py``).

  * data: ``FeatureStore`` dumps stacked into host arrays; each ``train()``
    call seeds ``np.random.default_rng(cfg.seed)`` once and every epoch
    draws a permutation, dropping the last partial batch (so a resumed run
    starts again from the seed's first order, as the JAX trainer does);
    test batches run in order, the last one padded with repeats of its last
    sample, the padding counted in the test loss;
  * the net by ``train_method`` and its loss (``build_train_setup``), with
    BatchNorm in flax's training mode during steps;
  * ``train.optim.Adam``: optax's Adam with the warmup-then-constant
    schedule, counted in *updates* (``(n_train // batch_size) //
    accum_iter`` an epoch), ``lr = blr * batch_size * accum_iter / 256``
    when unset, L2 weight decay and gradient accumulation;
  * a NaN/Inf train loss aborts at the epoch's end (the one host sync of
    the epoch's steps);
  * ``metrics.jsonl`` and ``checkpoint-{epoch}.npz`` every ``save_every``
    epochs in ``output_dir``, in the JAX trainer's keys: ``params`` and
    ``batch_stats`` under flax names and layouts (``models.names``),
    ``opt_state`` in optax's tree, ``__meta__`` ``{"epoch",
    "train_method"}``; ``resume`` (or ``'auto'``, the newest checkpoint)
    reads the JAX trainer's files as well as its own, and a file without
    ``opt_state`` (initial weights) leaves the optimizer fresh.

Data-parallel over a process group (``TrainConfig.mesh_shape``; the JAX
trainer's batch sharded over the ``'data'`` axis, state replicated): every
rank draws the same permutation from the seed and takes its contiguous
block of each batch, so the global batch is the one-device batch; one
flattened ``all_reduce`` averages the gradients and the losses (every loss
is a sum over the batch divided by the batch size, so the mean of the
ranks' losses is the global batch's loss); training BatchNorm takes its
moments over the global batch (``models.hallucination.sync_batch_norm``);
every rank applies the same update, and sees the same averaged loss, so the
NaN abort is agreed; rank 0 writes the checkpoints and ``metrics.jsonl``.
"""

from __future__ import annotations

import dataclasses
import functools
import glob
import json
import math
import os
import re
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from cmdiad_tpu_torch.config import TrainConfig
from cmdiad_tpu_torch.data.feature_store import FeatureStore
from cmdiad_tpu_torch.device import resolve_device
from cmdiad_tpu_torch.models import names
from cmdiad_tpu_torch.models.backbone import init_weights
from cmdiad_tpu_torch.models.hallucination import (FtoFConv, FtoFMlp, FtoIConv, FtoIMlp,
                                                   sync_batch_norm)
from cmdiad_tpu_torch.models.hrnet import HRNet
from cmdiad_tpu_torch.parallel.mesh import Mesh, barrier, make_mesh, shard_batch
from cmdiad_tpu_torch.train.checkpoint import flatten, load_meta, load_pytree, save_pytree
from cmdiad_tpu_torch.train.optim import Adam, warmup_constant_lr

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
Batch = Dict[str, torch.Tensor]


def _to_channels_last(img: np.ndarray) -> np.ndarray:
    """Accept (N,3,H,W) reference-layout dumps or (N,H,W,3)."""
    if img.ndim == 4 and img.shape[1] == 3 and img.shape[-1] != 3:
        return np.transpose(img, (0, 2, 3, 1))
    return img


def build_train_setup(cfg: TrainConfig, feature_dim: int = 768):
    """-> (net, name table, loss_fn(net, batch, train) -> (loss, aux)), as
    the JAX package's ``build_train_setup``."""
    tm = cfg.train_method
    dtype = _DTYPES[cfg.compute_dtype]
    if tm == "HallucinationCrossModality":
        rgb_dim = 384 if cfg.rgb_backbone == "dino_small" else feature_dim
        net = FtoFMlp(feature_dim, rgb_dim, mlp_depth=cfg.mlp_depth, dtype=dtype)

        def loss_fn(net, batch, train):
            patch = batch["patch"]
            lx, lr = net(patch[:, :, :feature_dim], patch[:, :, feature_dim:],
                         cfg.dist_method)
            return lx + lr, {"loss_xyz": lx, "loss_rgb": lr}
        return net, names.ftof_mlp(cfg.mlp_depth), loss_fn

    if tm == "HallucinationCrossModalityConv":
        net = FtoFConv(feature_dim, feature_dim, dtype=dtype)

        def loss_fn(net, batch, train):
            patch = batch["patch"]
            lx, lr = net(patch[:, :, :feature_dim], patch[:, :, feature_dim:],
                         cfg.sigmoid_loss, train)
            return lx + lr, {"loss_xyz": lx, "loss_rgb": lr}
        return net, names.ftof_conv(), loss_fn

    if tm in ("RGBFeatureToXYZInputMLP", "XYZFeatureToRGBInputMLP",
              "RGBFeatureToXYZInputConv", "XYZFeatureToRGBInputConv"):
        out_ch = 1 if cfg.estimate_depth else 3
        if tm.endswith("MLP"):
            net, table = FtoIMlp(feature_dim, out_channels=out_ch, dtype=dtype), names.ftoi_mlp()
        else:
            net, table = FtoIConv(feature_dim, out_channels=out_ch, dtype=dtype), names.ftoi_conv()

        def loss_fn(net, batch, train):
            return net.loss(batch["feature"], batch["target"]), {}
        return net, table, loss_fn

    if tm in ("RGBInputToXYZFeatureHRNET", "XYZInputToRGBFeatureHRNET"):
        net = HRNet(feature_dim, dtype=dtype)

        def loss_fn(net, batch, train):
            return net.loss(batch["image"], batch["feature"], train), {}
        return net, names.hrnet(), loss_fn

    raise ValueError(f"unknown train_method {tm!r}")


def load_training_arrays(cfg: TrainConfig, split: str) -> Dict[str, np.ndarray]:
    """FeatureStore dumps -> batch columns for the selected train method
    (the reference's three dataset classes over the store's layouts)."""
    tm = cfg.train_method
    store = FeatureStore(cfg.data_path)
    if tm in ("HallucinationCrossModality", "HallucinationCrossModalityConv"):
        cols = store.load_stacked(split, ["patch"])
        return {"patch": cols["patch"].astype(np.float32)}
    if tm in ("RGBFeatureToXYZInputMLP", "RGBFeatureToXYZInputConv"):
        cols = store.load_stacked(split, ["frgb", "xyz"])     # frgb -> pc image
        return {"feature": cols["frgb"].astype(np.float32),
                "target": _to_channels_last(cols["xyz"]).astype(np.float32)}
    if tm in ("XYZFeatureToRGBInputMLP", "XYZFeatureToRGBInputConv"):
        cols = store.load_stacked(split, ["hfxyz", "rgb"])    # fxyz -> rgb image
        return {"feature": cols["hfxyz"].astype(np.float32),
                "target": _to_channels_last(cols["rgb"]).astype(np.float32)}
    if tm == "RGBInputToXYZFeatureHRNET":
        cols = store.load_stacked(split, ["rgb", "hfxyz"])
        return {"image": _to_channels_last(cols["rgb"]).astype(np.float32),
                "feature": cols["hfxyz"].astype(np.float32)}
    if tm == "XYZInputToRGBFeatureHRNET":
        cols = store.load_stacked(split, ["xyz", "frgb"])
        return {"image": _to_channels_last(cols["xyz"]).astype(np.float32),
                "feature": cols["frgb"].astype(np.float32)}
    raise ValueError(tm)


def train_mesh(cfg: TrainConfig, device) -> Optional[Mesh]:
    """The data-parallel mesh of a training run: ``cfg.mesh_shape`` over
    the process group (raises without one); with ``()``, every rank of an
    initialised group (the JAX trainer's widest data axis that divides the
    batch: a narrower one would leave ranks idle, which raises), or none."""
    if cfg.mesh_shape:
        mesh = make_mesh(cfg.mesh_shape, device)
    elif dist.is_available() and dist.is_initialized():
        mesh = make_mesh((dist.get_world_size(),), device)
    else:
        return None
    if cfg.batch_size % mesh.shape[0]:
        raise ValueError(f"batch_size {cfg.batch_size} does not split over the "
                         f"{mesh.shape[0]} ranks of the data axis")
    return mesh


@dataclasses.dataclass
class TrainResult:
    params: dict        # flax names and layouts, numpy leaves
    batch_stats: dict
    history: Dict[str, list]


class DistillTrainer:
    """Trains the ``cfg.train_method`` net on ``device`` (the card by
    default; raises without one; under a process group this rank's
    device).  ``arrays``/``test_arrays`` replace the dumps under
    ``cfg.data_path``, the whole of them on every rank; ``feature_dim`` is
    the feature width (768 for the reference's backbones)."""

    def __init__(self, cfg: TrainConfig, feature_dim: int = 768,
                 arrays: Optional[Dict[str, np.ndarray]] = None,
                 test_arrays: Optional[Dict[str, np.ndarray]] = None,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = train_mesh(cfg, self.device)
        self.net, self.table, self.loss_fn = build_train_setup(cfg, feature_dim)
        init_weights(self.net, cfg.seed, fan_in_scaled=True)
        self.net.to(self.device)
        if self.mesh is not None:
            sync_batch_norm(self.net, self.mesh.group or dist.group.WORLD)
        self.params = dict(self.net.named_parameters())

        self.arrays = arrays if arrays is not None else load_training_arrays(cfg, "train")
        self.test_arrays = (test_arrays if test_arrays is not None
                            else load_training_arrays(cfg, "test"))
        self.n_train = len(next(iter(self.arrays.values())))

        eff_batch = cfg.batch_size * cfg.accum_iter
        self.lr = cfg.lr if cfg.lr is not None else cfg.blr * eff_batch / 256.0
        updates_per_epoch = max((self.n_train // cfg.batch_size)
                                // max(cfg.accum_iter, 1), 1)
        self.opt = Adam(self.params,
                        warmup_constant_lr(self.lr, cfg.warmup_epochs, updates_per_epoch),
                        cfg.weight_decay, cfg.accum_iter)
        self.start_epoch = cfg.start_epoch
        resume = cfg.resume
        if resume == "auto":
            resume = self._latest_checkpoint()   # None: a fresh start
        if resume:
            self._resume(resume)

    # -- one step ------------------------------------------------------------
    def loss_and_grads(self, batch: Batch):
        """Loss, aux losses and {param name: gradient} of one training
        forward (BatchNorm statistics move, as in a step); on a mesh
        ``batch`` is this rank's block and all three are the global
        batch's."""
        loss, aux = self.loss_fn(self.net, batch, True)
        grads = torch.autograd.grad(loss, list(self.params.values()))
        loss, *rest = self._mean_over_ranks(
            [loss.detach(), *(v.detach() for v in aux.values()), *grads])
        return (loss, dict(zip(aux, rest[:len(aux)])),
                dict(zip(self.params, rest[len(aux):])))

    def _mean_over_ranks(self, tensors):
        """Each tensor's mean over the ranks, by one all_reduce of them all
        flattened into one vector (of their widest dtype)."""
        if self.mesh is None:
            return tensors
        dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
        flat = torch.cat([t.reshape(-1).to(dtype) for t in tensors])
        dist.all_reduce(flat, group=self.mesh.group)
        flat /= self.mesh.size
        out = []
        for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
            out.append(part.view_as(t).to(t.dtype))
        return out

    def step(self, batch: Batch):
        loss, aux, grads = self.loss_and_grads(batch)
        self.opt.step(grads)
        return loss, aux

    @torch.no_grad()
    def evaluate(self, batch: Batch):
        loss, aux = self.loss_fn(self.net, batch, False)
        loss, *aux_vals = self._mean_over_ranks([loss, *aux.values()])
        return loss, dict(zip(aux, aux_vals))

    def _batches(self, arrays, rng, batch_size, drop_last=True):
        n = len(next(iter(arrays.values())))
        order = rng.permutation(n) if rng is not None else np.arange(n)
        stop = (n // batch_size) * batch_size if drop_last else n
        for i in range(0, stop, batch_size):
            idx = order[i:i + batch_size]
            if len(idx) < batch_size:   # the test tail: pad with repeats
                idx = np.concatenate([idx, np.repeat(idx[-1:], batch_size - len(idx))])
            if self.mesh is not None:
                idx = shard_batch(idx, self.mesh, self.mesh.shape[0])[0]
            yield {k: torch.from_numpy(np.ascontiguousarray(v[idx])).to(self.device)
                   for k, v in arrays.items()}

    # -- checkpoints ---------------------------------------------------------
    def _named(self, tree: dict) -> Dict[str, np.ndarray]:
        """A flax params tree -> {param name: torch-layout array}."""
        return {k: v.numpy() for k, v in names.to_torch(self.table, {"params": tree}).items()}

    def state_tree(self) -> dict:
        """``{"params", "batch_stats", "opt_state"}`` as the JAX trainer's
        checkpoint holds them."""
        variables = names.to_flax(self.table, self.net.state_dict())
        return {"params": variables["params"],
                "batch_stats": variables.get("batch_stats", {}),
                "opt_state": self.opt.optax_state(
                    lambda d: names.to_flax(self.table, d, ("params",))["params"])}

    def _resume(self, path: str):
        meta = load_meta(path)
        tree = load_pytree(path)
        want = self.state_tree()
        for part in ("params", "batch_stats", "opt_state"):
            if part == "opt_state" and part not in tree:
                continue   # initial weights only: the optimizer stays fresh
            got_keys, want_keys = set(flatten(tree.get(part, {}))), set(flatten(want[part]))
            if got_keys != want_keys:
                raise ValueError(
                    f"{path}: {part} does not match the {self.cfg.train_method} net "
                    f"(missing {sorted(want_keys - got_keys)[:4]}, unexpected "
                    f"{sorted(got_keys - want_keys)[:4]})")
        self.net.load_state_dict(names.to_torch(
            self.table, {k: tree[k] for k in ("params", "batch_stats") if k in tree}))
        if "opt_state" in tree:
            self.opt.load_optax_state(tree["opt_state"], self._named)
        self.start_epoch = int(meta.get("epoch", -1)) + 1

    def _latest_checkpoint(self):
        if not self.cfg.output_dir:
            return None
        paths = glob.glob(f"{self.cfg.output_dir}/checkpoint-*.npz")
        if not paths:
            return None

        def epoch_of(p):
            m = re.search(r"checkpoint-(\d+)\.npz$", p)
            return int(m.group(1)) if m else -1
        return max(paths, key=epoch_of)

    def _log_metrics(self, record: dict):
        if not self.cfg.output_dir or not self._writes:
            return
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        with open(f"{self.cfg.output_dir}/metrics.jsonl", "a") as f:
            f.write(json.dumps(record) + "\n")

    @property
    def _writes(self) -> bool:
        return self.mesh is None or self.mesh.rank == 0

    def _save(self, epoch: int) -> None:
        if self._writes:
            save_pytree(f"{self.cfg.output_dir}/checkpoint-{epoch}.npz", self.state_tree(),
                        meta={"epoch": epoch, "train_method": self.cfg.train_method})
        barrier(self.mesh)

    # -- the loop ------------------------------------------------------------
    def train(self) -> TrainResult:
        cfg = self.cfg
        history = {"train_loss": [], "test_loss": []}
        rng = np.random.default_rng(cfg.seed)
        for epoch in range(self.start_epoch, cfg.epochs):
            t0 = time.perf_counter()
            losses, aux_acc = [], {}
            for batch in self._batches(self.arrays, rng, cfg.batch_size):
                loss, aux = self.step(batch)
                losses.append(loss)
                for k, v in aux.items():
                    aux_acc.setdefault(k, []).append(v)
            train_loss = float(torch.stack(losses).mean())
            if not math.isfinite(train_loss):
                raise FloatingPointError(
                    f"loss is {train_loss}, stopping training (as the reference "
                    f"aborts, pretrain:144-146)")
            history["train_loss"].append(train_loss)

            test_losses, test_aux_acc = [], {}
            for batch in self._batches(self.test_arrays, None, cfg.batch_size,
                                       drop_last=False):
                loss, aux = self.evaluate(batch)
                test_losses.append(loss)
                for k, v in aux.items():
                    test_aux_acc.setdefault(k, []).append(v)
            test_loss = (float(np.mean(torch.stack(test_losses).tolist()))
                         if test_losses else float("nan"))
            history["test_loss"].append(test_loss)
            record = {"epoch": epoch, "train_loss": train_loss, "test_loss": test_loss,
                      "epoch_s": time.perf_counter() - t0}
            # in the JAX trainer's order: its aux dicts come back from jit
            # with their keys sorted
            for k in sorted(aux_acc):
                record[f"train_{k}"] = float(torch.stack(aux_acc[k]).mean())
            for k in sorted(test_aux_acc):
                record[f"test_{k}"] = float(np.mean(torch.stack(test_aux_acc[k]).tolist()))
            self._log_metrics(record)
            if (epoch + 1) % cfg.save_every == 0 and cfg.output_dir:
                self._save(epoch)
        variables = names.to_flax(self.table, self.net.state_dict())
        return TrainResult(variables["params"], variables.get("batch_stats", {}), history)
