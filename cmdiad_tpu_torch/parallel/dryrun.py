"""A multi-device dry run of the port (the JAX package's
``__graft_entry__.dryrun_multichip``).

``dryrun_multichip(n, backend, devices)`` spawns ``n`` ranks and, on each:

1. one train step of an FtoFMlp on a ``('data', 'model')`` ``DeviceMesh``
   (``model`` 2 wide when ``n`` is even): the batch split over ``'data'``,
   the MLP hidden width over ``'model'`` with
   ``torch.distributed.tensor.parallel`` (``fc1`` column-wise, ``fc2``
   row-wise, everything else replicated, as the JAX dry run's
   ``param_spec``), the gradients averaged over ``'data'``, then the port's
   Adam.  The loss and every gradient are held to one device's step on the
   whole batch (``tests/test_torch_train.py``'s step tolerances), the
   updated parameters must be finite;
2. one sharded bank min (``parallel.eval.sharded_bank_min_dist``, the
   bank-min kernel on each rank's rows on a card) against the exact dense
   distances;
3. one data-parallel evaluation step: small dual backbones extract each
   rank's block, held to the whole batch's features (GEMMs of another
   batch size may sum in another order); ``dp_score_batch`` scores each
   rank's block of those features against a replicated bank, and
   ``sharded_score_batch`` the whole batch against row-sharded banks under
   ``l1`` (exact, so neither side chooses rows through a rounded product:
   the ``l2`` kernel's per-shard choice is step 2's); both are held to one
   device's scores of the whole batch (the JAX package's DP tolerances).

Run it as ``python -m cmdiad_tpu_torch.parallel.dryrun [n] [gloo|nccl]
[device ...]`` (default: 4 gloo ranks on the CPU).
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.distributed as dist

from cmdiad_tpu_torch.parallel.eval import (dp_score_batch, sharded_bank_min_dist,
                                            sharded_score_batch)
from cmdiad_tpu_torch.parallel.launch import spawn
from cmdiad_tpu_torch.parallel.mesh import gather_rows, make_mesh, shard_batch, shard_rows

DIM, TOKENS, SIZE = 16, 8, 64
# tests/test_torch_train.py's step tolerances; the JAX package's DP ones
# (tests/test_parallel.py)
LOSS_RTOL, GRAD_RTOL, GRAD_FLOOR = 1e-5, 1e-4, 1e-7
SCORE_RTOL, MAP_RTOL, MAP_ATOL = 1e-4, 1e-3, 1e-4
FEATURE_RTOL, FEATURE_ATOL = 1e-4, 1e-5


def _tp_plan(net) -> dict:
    from torch.distributed.tensor.parallel import ColwiseParallel, RowwiseParallel
    plan = {}
    for name, _ in net.named_modules():
        if name.endswith(".fc1"):
            plan[name] = ColwiseParallel()
        elif name.endswith(".fc2"):
            plan[name] = RowwiseParallel()
    return plan


def _full(t):
    """A DTensor's whole value on every rank.  Its shards are gathered with
    ``dist.all_gather``: DTensor's own gather (``full_tensor``, the
    functional ``all_gather_into_tensor``) crashes the process under gloo
    with CUDA tensors (torch 2.11, two ranks on one card)."""
    local = t.to_local()
    shard = [p for p in t.placements if p.is_shard()]
    if not shard:
        return local
    group = t.device_mesh.get_group()
    parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, local.contiguous(), group=group)
    return torch.cat(parts, dim=shard[0].dim)


def _train_step(device, rng, n):
    """DP + TP step of an FtoFMlp against one device's step; returns (loss,
    largest gradient error as a share of its leaf's largest value)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor
    from torch.distributed.tensor.parallel import parallelize_module
    from cmdiad_tpu_torch.models.backbone import init_weights
    from cmdiad_tpu_torch.models.hallucination import FtoFMlp
    from cmdiad_tpu_torch.train.optim import Adam

    model = 2 if n % 2 == 0 else 1
    data = n // model
    backend = dist.get_backend()
    dmesh = init_device_mesh(device.type, (data, model), mesh_dim_names=("data", "model"),
                             backend_override={"data": backend, "model": backend})
    tp = dmesh["model"]
    batch = 2 * data
    xyz = torch.from_numpy(rng.normal(size=(batch, TOKENS, DIM)).astype(np.float32)).to(device)
    rgb = torch.from_numpy(rng.normal(size=(batch, TOKENS, DIM)).astype(np.float32)).to(device)

    ref = FtoFMlp(DIM, DIM)
    init_weights(ref, 0, fan_in_scaled=True)
    ref.to(device)
    ref_loss = sum(ref(xyz, rgb, "l2"))
    ref_grads = dict(zip(dict(ref.named_parameters()),
                         torch.autograd.grad(ref_loss, list(ref.parameters()))))

    net = FtoFMlp(DIM, DIM)
    init_weights(net, 0, fan_in_scaled=True)
    net.to(device)
    parallelize_module(net, tp, _tp_plan(net))
    # the port's modules call F.linear on their parameters, so every
    # parameter and input is a DTensor on the 'model' mesh
    for mod in net.modules():
        for pname, p in list(mod.named_parameters(recurse=False)):
            if not isinstance(p, DTensor):
                setattr(mod, pname, torch.nn.Parameter(distribute_tensor(p.detach(), tp,
                                                                         [Replicate()])))
    params = dict(net.named_parameters())
    row = dmesh.get_local_rank("data")
    block = slice(row * 2, row * 2 + 2)
    xs, rs = (DTensor.from_local(t[block], tp, [Replicate()]) for t in (xyz, rgb))
    loss = sum(net(xs, rs, "l2"))
    grads = dict(zip(params, torch.autograd.grad(loss, list(params.values()))))
    data_group = dmesh["data"].get_group()
    loss_local = loss.detach().to_local().clone()
    dist.all_reduce(loss_local, group=data_group)
    loss_value = float(loss_local) / data
    for name, g in grads.items():
        local = g.to_local().clone()
        dist.all_reduce(local, group=data_group)
        grads[name] = DTensor.from_local(local / data, tp, g.placements)
    ref_value = float(ref_loss.detach())
    assert np.isclose(loss_value, ref_value, rtol=LOSS_RTOL), (loss_value, ref_value)
    worst = 0.0
    for name, g in grads.items():
        want = ref_grads[name]
        err = float((_full(g) - want).abs().max())
        limit = GRAD_RTOL * float(want.abs().max()) + GRAD_FLOOR
        assert err <= limit, (name, err, limit)
        worst = max(worst, err / max(float(want.abs().max()), 1e-30))
    Adam(params, lambda step: 1e-3).step(grads)
    for name, p in params.items():
        assert bool(torch.isfinite(_full(p)).all()), f"{name} diverged"
    return loss_value, worst


def _sharded_min(device, rng, n):
    """Sharded bank min against the exact distances; returns the largest
    relative distance error."""
    mesh = make_mesh((n,), device)
    bank = torch.from_numpy(rng.normal(size=(64 * n, 64)).astype(np.float32)).to(device)
    patch = torch.from_numpy(rng.normal(size=(TOKENS, 64)).astype(np.float32)).to(device)
    v, idx = sharded_bank_min_dist(mesh, patch, shard_rows(bank, mesh))
    exact = torch.cdist(patch.double(), bank.double())
    best = exact.min(1).values
    assert v.shape == (TOKENS,) and bool(torch.isfinite(v).all())
    # the distance of the chosen row, not the row: near ties may pick another
    # row inside the float32 rounding of |a|^2 + |b|^2 - 2ab (the JAX dry run's rtol)
    chosen = exact[torch.arange(TOKENS, device=device), idx]
    err = float(((v.double() - best).abs() / best).max())
    assert err <= 3e-3 and float(((chosen - best).abs() / best).max()) <= 3e-3, err
    return err


def _dp_eval(device, rng, n):
    """DP extraction + scoring and sharded-bank scoring of one batch against
    one device's scores of the whole batch; returns the largest errors."""
    from cmdiad_tpu_torch.models.backbone import DualBackbone
    from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
    from cmdiad_tpu_torch.models.vit import ViTConfig
    from cmdiad_tpu_torch.ops.scoring import bank_nn_table, patchcore_score

    mesh = make_mesh((n,), device)
    bb = DualBackbone(vit_config=ViTConfig(img_size=SIZE, embed_dim=64, depth=1, num_heads=2),
                      pm_config=PointMAEConfig(num_group=16, group_size=8, encoder_dims=16,
                                               trans_dim=32, depth=2, num_heads=2,
                                               fetch_idx=(0, 1)),
                      point_capacity=None, device=device)
    batch = 2 * n
    rgbs = rng.normal(size=(batch, SIZE, SIZE, 3)).astype(np.float32)
    pcs = (rng.normal(size=(batch, SIZE, SIZE, 3)) * 0.05).astype(np.float32)
    banks = [torch.from_numpy(rng.normal(size=(64 * n, 64)).astype(np.float32)).to(device)
             for _ in range(2)]

    def features(images, clouds):
        rgb_patch, _ = bb.rgb_patches(torch.from_numpy(images).to(device))
        xyz_patch = bb.xyz_patches(torch.from_numpy(clouds).to(device))["xyz_patch"]
        return ((rgb_patch, (8, 8)), (xyz_patch, (56, 56)))

    whole = features(rgbs, pcs)
    mine = features(shard_batch(rgbs, mesh)[0], shard_batch(pcs, mesh)[0])
    s_err = m_err = 0.0
    for (full, hw), (block, _), bank in zip(whole, mine, banks):
        torch.testing.assert_close(gather_rows(block, mesh), full, rtol=FEATURE_RTOL,
                                   atol=FEATURE_ATOL)
        runs = []
        for metric in ("l2", "l1"):
            want = patchcore_score(full, bank, hw, out_size=SIZE, metric=metric)
            if metric == "l2":
                got = dp_score_batch(mesh, shard_batch(full, mesh)[0], bank, hw,
                                     out_size=SIZE)
            else:
                got = sharded_score_batch(mesh, full, shard_rows(bank, mesh), hw,
                                          bank_nn_table(bank, metric=metric),
                                          out_size=SIZE, metric=metric)
            runs.append((*got, *want))
        for s, m, want_s, want_m in runs:
            assert s.shape == (batch,) and m.shape == (batch, SIZE, SIZE)
            torch.testing.assert_close(s, want_s, rtol=SCORE_RTOL, atol=0)
            torch.testing.assert_close(m, want_m, rtol=MAP_RTOL, atol=MAP_ATOL)
            s_err = max(s_err, float(((s - want_s).abs() / want_s.abs()).max()))
            m_err = max(m_err, float((m - want_m).abs().max()))
    return s_err, m_err


def _rank(device, n):
    rng = np.random.default_rng(0)    # the same draws on every rank
    loss, grad_err = _train_step(device, rng, n)
    min_err = _sharded_min(device, rng, n)
    s_err, m_err = _dp_eval(device, rng, n)
    return dict(loss=loss, grad_err=grad_err, min_err=min_err, score_err=s_err,
                map_err=m_err)


def dryrun_multichip(n: int = 4, backend: str = "gloo", devices=None) -> dict:
    """Spawn ``n`` ranks over ``backend`` on ``devices`` (default: the CPU
    for each) and run the dry run; raises where a check fails.  Returns
    rank 0's numbers, which every rank must share."""
    devices = list(devices) if devices is not None else ["cpu"] * n
    results = spawn(_rank, n, backend, devices, args=(n,))
    for r, res in enumerate(results[1:], 1):
        assert np.isclose(res["loss"], results[0]["loss"], rtol=1e-6), (r, res, results[0])
    out = results[0]
    model = 2 if n % 2 == 0 else 1
    print(f"dryrun_multichip({n}, {backend}, {devices}): mesh data {n // model} x model "
          f"{model}; train loss {out['loss']:.6f}, gradients within {out['grad_err']:.2e} of "
          f"one device's; sharded bank min within {out['min_err']:.2e} of exact; DP and "
          f"sharded scores within {out['score_err']:.2e}, maps within {out['map_err']:.2e} "
          f"of one device's -- OK")
    return out


if __name__ == "__main__":
    argv = sys.argv[1:]
    world = int(argv[0]) if argv else 4
    be = argv[1] if len(argv) > 1 else "gloo"
    dryrun_multichip(world, be, argv[2:] or None)
