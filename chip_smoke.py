"""Drive the PyTorch port's detection paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py              # every phase (needs one CUDA card)
    python3 chip_smoke.py --profile DIR  # also profile one evaluation pass
                                         # of each path and one training
                                         # step of each train method into DIR
    python3 chip_smoke.py --full_ocsvm   # also time one full 'jax' OCSVM fit

Phases:
  1. build the hand-written CUDA kernels from ``cmdiad_tpu_torch/csrc``;
  2. hold each kernel against its plain PyTorch version at the shapes the
     paths give it (inputs from a seed), with the tolerances stated below,
     and time kernel, plain version and, where one exists, a PyTorch
     library call computing the same function; the int8/bf16 tensor-core
     probe runs here, its launches counted around its own run;
  3. two paths at full width, ``DINO+Point_MAE`` (ViT-B/8 + Point-MAE,
     224², 1024 groups of 128, 32768-point capacity, batch 8) with random
     weights from a seed: ``CMDIADRunner.fit`` on 16 synthetic train
     samples, then ``evaluate`` on 8 test samples (4 good, 4 dented), with
     every kernel's launch count set to 0 before and read after each path:
       default     Config defaults (float32 backbones, ``l2`` scoring);
       throughput  ``compute_dtype='bfloat16'``, ``dist_method_s='l2_int8'``,
                   ``use_flash=True``, its metrics held to the default
                   path's within the JAX package's own envelopes.
     Each path's fitted state is then served on the CPU with the plain
     versions and the predictions compared, every bank row the two devices
     choose differently held to the quantised product's error envelope;
  4. detect from disk, at the same width: a fixture of two classes at
     MVTec 3D-AD's raw scan sizes (800² and 400²; per class 16 train
     samples, the validation sample, 4 good, 4 dented and 2 blotched test
     samples) written with the port's PNG and TIFF writers into a temporary
     directory, its round trips held exact; ``cli.main(["detect", ...])``
     over both classes with ``--bank_cache_dir``, then again on the same
     cache, where each class must be served (no bank pass) with identical
     metrics; then ``DINO``, ``Point_MAE`` and ``Depth`` on one class, each
     with its launch check.  Prints the loader's decode-plus-resize time per
     sample and each class's fit and evaluation times beside the in-memory
     path's;
  5. MTFI few-modal inference at the same width, on one shared backbone:
     each of the six ``mtfi_*`` presets (FtoF, ItoF, FtoI; rgb and xyz
     main) with a random fusion net from a seed fits on the 16 train
     samples and evaluates the 8 test samples holding only the main
     modality's keys; the main and fusion banks hold rows and the other
     modality's none; evaluation launches only the main path's kernels (no
     FPS or interpolation for FtoF/ItoF with the rgb main, FPS over every
     point of the hallucinated 224² cloud for FtoI's rgb main); the fusion
     net agrees with a CPU copy of it, and the card's predictions with the
     CPU's on the card's bank rows and hallucinated features;
  6. the throughput configuration's bfloat16 ViT-B/8 and Point-MAE at full
     width (two blocks each) held to the JAX package's outputs saved in
     ``tests/data/jax_bf16_backbones.npz`` (``tests/bf16_golden.py``
     rebuilds the weights and inputs from numpy's seeded stream); DINOv2
     ViT-B/14 at 518² and Point-BERT through the fused attention
     kernel against the same modules on the CPU, in float32; a backbone
     and a fusion net written to ``.pth`` files load back through
     ``rgb_ckpt_path``, ``xyz_ckpt_path`` and ``fusion_module_path`` to the
     in-memory weights' outputs.  Phase 2 also holds FPS and the
     interpolation over a dense 50176-point cloud, and attention at DINOv2's 1370 and Point-BERT's 1025
     tokens against their plain versions;
  7. the MTFI lifecycle with training, at the same width: ``DINO+Point_MAE``
     fits and evaluates phase 3's samples writing the three feature stores
     (FPS, interpolation and the bf16 bank-min launched, int8 bank-min and
     attention not); each of the eight train methods trains 2 epochs at
     batch 8 from them (FtoFMlp also in bfloat16 and with
     ``accum_iter=2``), a checkpoint every epoch, and one step of each,
     resumed from its last checkpoint, is held against the same step on a
     CPU copy; each method's step is timed at batch 64 in float32 and
     bfloat16 beside its FLOP bound and peak memory; the trained FtoF and
     HRNet checkpoints serve ``mtfi_ftof_xyz_main`` and
     ``mtfi_itof_rgb_main`` through ``fusion_module_path``, each
     evaluating from its main modality with its launch check;
  8. multi-device (``cmdiad_tpu_torch.parallel``), ranks started by
     ``parallel.launch.spawn``: (a) NCCL at world 1 on the card: the dry
     run, and ``DINO+Point_MAE`` fitted with ``mesh_shape=(1,)`` and with
     ``shard_bank=True``, predictions identical to phase 3's; (b) gloo at
     world 2 with both ranks on the card (NCCL refuses two ranks on one
     card): phase 3's fitted states served data-parallel (4 test samples a
     rank; default and throughput) and with sharded banks (4096 of the
     8192 padded rows a rank; default and throughput), each launch's batch
     or bank rows checked, every bank row chosen otherwise than phase 3's
     replicated bank held to the quantised product's envelope and the
     predictions on the mesh's rows to phase 3's; a data-parallel fit's
     metrics; one float64 training step of FtoFMlp and of HRNet at 2 x 32
     against one at 64; the dry run.  Two ranks on one card measure the
     collectives and the extra process, not scaling;
  9. the tail: (a) three 800² scans at MVTec 3D-AD's density (0.125 mm a
     pixel: a tilted plane, a domed object, a separate tuft) written to a
     temporary tree and rewritten by ``cli.main(["preprocess", ...,
     "--device", "cuda"])``, its RANSAC, DBSCAN and IO times per sample,
     the DBSCAN kernel's roots and counts held to its plain version on the
     full scene and the card's RANSAC plane to the CPU's on the same draw;
     (b) a 512² Eyecandies tree through ``preprocess-eyecandies`` on the
     card against the CPU; (c) the default path with ``quantized_blur``,
     every blurred map bit-equal to the CPU's blur of the same score map;
     (d) its fusers fitted with ``ocsvm_backend='jax'`` on the card
     (``TAIL_OCSVM_EPOCHS`` epochs through ``csrc/ocsvm_sgd.cu``;
     ``--full_ocsvm`` also times all 1000), the detect fuser's fit and
     the seg fuser's first epoch bit-equal to the kernel's plain version,
     beside the numpy 'sklearn' fitter's time; (e) ``cli heatmap`` over
     the maps phase 4 saved.

Prints the card, one ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result line,
when a phase fails or no CUDA card is present.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
# H100 SXM data-sheet peaks (dense): bf16 and int8 tensor cores, fp32 CUDA
# cores, HBM bandwidth.  The card's power limit is printed beside every time.
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# The special-function unit's exponentials per second (FlashAttention-3
# paper's H100 SXM figure): at head dim 64 one exponential per score costs
# as much time as the score's 256 bf16 tensor-core operations.
PEAK_SFU = 3.9e12
# The fp32 peak counts an FMA as two operations.  FPS and interp are built
# without FMA contraction, so each of their sub, mul, add and min is one
# instruction at half that rate.
PEAK_FP32_NO_FMA = PEAK_FP32 / 2


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int) -> float:
    """Device time per call of ``fn``: ``iters`` calls captured in one CUDA
    graph, the graph replayed between CUDA events.  The host's cost of a
    launch, which decides the eager time of a call of a few tens of
    microseconds on a shared host, drops out."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * iters)


def _bound(ops: float, peak_ops: float, nbytes: float, sfu_ops: float = 0.0):
    t_ops = max(ops / peak_ops, sfu_ops / PEAK_SFU) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def _disc_cloud(rng, batch: int, size: int = 224):
    """Organized clouds with a disc of valid points (about 25k of 50176)."""
    pc = rng.normal(size=(batch, size, size, 3)).astype(np.float32) * 0.05
    yy, xx = np.mgrid[0:size, 0:size]
    pc[:, ((yy - size // 2) ** 2 + (xx - size // 2) ** 2) > 90 ** 2] = 0.0
    return pc


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def check_bank_min(rng, dev, nq: int, nb: int, d: int = 768):
    import torch
    from cmdiad_tpu_torch.ops import bank_min as bm
    q = torch.from_numpy(rng.normal(size=(nq, d)).astype(np.float32)).to(dev)
    bank = torch.from_numpy(rng.normal(size=(nb, d)).astype(np.float32)).to(dev)
    qb = q.to(torch.bfloat16).contiguous()
    bb = bank.to(torch.bfloat16).contiguous()
    bnorm = torch.sum(bank * bank, dim=1).contiguous()
    kv, ki = bm._bank_min_cuda(qb, bb, bnorm)
    pv, pi = bm._bank_min_plain(qb, bb, bnorm)
    # CTAs publish their tiles' minima with atomics in no fixed order; the
    # packed (value, row) keys make the result independent of that order
    kv2, ki2 = bm._bank_min_cuda(qb, bb, bnorm)
    torch.cuda.synchronize()
    assert torch.equal(ki, ki2) and torch.equal(kv, kv2), "two launches differ"
    # the two differ only in float32 summation order: indices agree except
    # where two rows tie within that rounding; the raw values of the row
    # each chose agree to float32 rounding of |b|^2 + 2|b.q| (1e-5 relative)
    same = (ki == pi)
    raw_scale = (bnorm[ki] + 2.0 * torch.abs(bnorm.max())).max()
    raw_err = float(torch.max(torch.abs(kv - pv)))
    assert raw_err <= 1e-5 * float(raw_scale), (raw_err, float(raw_scale))
    # refined values: the exact float32 distance of the chosen row, held
    # against float64; a near-tie flip may report the other row's distance,
    # which must lie within the same rounding envelope of the plain one
    k_ref = bm.exact_refine(q, bank, ki)
    p_ref = bm.exact_refine(q, bank, pi)
    exact64 = torch.sqrt(torch.sum((q.double() - bank[ki].double()) ** 2, 1))
    assert torch.allclose(k_ref.double(), exact64, rtol=1e-5, atol=1e-5)
    ref_err = float(torch.max(torch.abs(k_ref - p_ref)))
    assert ref_err <= 1e-3 * float(p_ref.max()), ref_err
    n_flip = int((~same).sum())
    assert n_flip <= max(1, nq // 1000), n_flip

    ms = _time_ms(lambda: bm._bank_min_cuda(qb, bb, bnorm), 5)
    plain_ms = _time_ms(lambda: bm._bank_min_plain(qb, bb, bnorm), 3)
    library_ms = _time_ms(lambda: torch.cdist(q, bank).min(1), 3)
    flops = 2.0 * nq * nb * d
    nbytes = nq * d * 2 + nb * d * 2 + nb * 4 + nq * 8
    bound_ms, bound_by = _bound(flops, PEAK_BF16, nbytes)
    print(f"bank_min nq={nq} nb={nb} d={d}: index agreement "
          f"{1 - n_flip / nq:.6f} ({n_flip} near-tie flips), raw err {raw_err:.3e}, "
          f"refined err {ref_err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
          f"cdist+min {library_ms:.3f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
          f"{flops / ms / 1e9:.1f} TFLOP/s")
    return dict(max_abs_err=ref_err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


def check_fps(rng, dev, batch=8, capacity=32768, groups=1024, dense=False):
    """FPS over the compacted valid points of disc clouds, or with ``dense``
    over every point of a regressed 224² cloud (``capacity`` 50176, the
    FtoI rgb-main path's input)."""
    import torch
    from cmdiad_tpu_torch.ops import fps
    from cmdiad_tpu_torch.ops.masked import host_compact_points, nonzero_point_mask
    if dense:
        pts = torch.from_numpy(
            0.5 + 0.05 * rng.normal(size=(batch, capacity, 3)).astype(np.float32)).to(dev)
    else:
        pc = _disc_cloud(rng, batch)
        pts = torch.from_numpy(np.stack(
            [host_compact_points(pc[i], capacity) for i in range(batch)])).to(dev)
    mask = nonzero_point_mask(pts)
    ki = fps._fps_cuda(pts, mask, groups)
    ki2 = fps._fps_cuda(pts, mask, groups)
    pi = fps._fps_plain(pts, mask, groups)
    torch.cuda.synchronize()
    # exact: both compute ((dx*dx + dy*dy) + dz*dz) without FMA
    n_diff = int((ki != pi).sum())
    assert n_diff == 0, f"FPS indices differ in {n_diff} places"
    assert torch.equal(ki, ki2), "two FPS launches differ"
    ms = _time_ms(lambda: fps._fps_cuda(pts, mask, groups), 5)
    # both cluster sizes, forced, three readings each, interleaved: where
    # the card's choice is 16 it must beat 8 by more than the spread
    sizes = {8: [], 16: []}
    for c in sizes:
        assert torch.equal(fps._fps_cuda(pts, mask, groups, clusters=c), pi), c
    for _ in range(3):
        for c in sizes:
            sizes[c].append(_time_ms(
                lambda: fps._fps_cuda(pts, mask, groups, clusters=c), 5))
    plain_ms = _time_ms(lambda: fps._fps_plain(pts, mask, groups), 1)
    n_valid = float(mask.sum())
    ops = 9.0 * groups * n_valid          # 3 sub, 3 mul, 2 add, 1 min
    nbytes = batch * capacity * (12 + 1) + batch * groups * 4
    bound_ms, bound_by = _bound(ops, PEAK_FP32_NO_FMA, nbytes)
    print(f"fps B={batch} P={capacity} G={groups} ({int(n_valid)} valid): "
          f"indices identical, two launches identical; cluster of "
          f"{fps.cluster_size(batch, capacity)} CTAs per set; kernel {ms:.3f} ms "
          f"({1e3 * ms / groups:.3f} us per step), plain {plain_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}); forced clusters of 8 "
          f"{min(sizes[8]):.3f}-{max(sizes[8]):.3f} ms, of 16 "
          f"{min(sizes[16]):.3f}-{max(sizes[16]):.3f} ms (three readings each)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def check_interp(rng, dev, batch=8, size=224, groups=1024, d=768, dense=False):
    """Both output types at the paths' size, each bit-identical to the
    plain version and over two launches; returns the float32 row of the
    kernels line (the default path's) and prints the bfloat16 one (the
    throughput path's) with its own bound.  With ``dense`` every point of
    the 224² cloud is valid, as in the regressed cloud that FtoI rgb main
    re-encodes."""
    import torch
    from cmdiad_tpu_torch.ops import interpolate as ip
    from cmdiad_tpu_torch.ops.masked import nonzero_point_mask
    if dense:
        cloud = 0.5 + 0.05 * rng.normal(size=(batch, size, size, 3)).astype(np.float32)
    else:
        cloud = _disc_cloud(rng, batch, size)
    pts = torch.from_numpy(cloud.reshape(batch, size * size, 3)).to(dev)
    mask = nonzero_point_mask(pts)
    # centers are input points, as FPS gives them: coincident pairs
    # exercise the clamp at 0
    gen = torch.Generator().manual_seed(SEED)
    cidx = torch.stack([torch.nonzero(mask[i].cpu())[:, 0][
        torch.randperm(int(mask[i].sum()), generator=gen)[:groups]]
        for i in range(batch)]).to(dev)
    centers = torch.gather(pts, 1, cidx[..., None].expand(-1, -1, 3))
    feats = torch.from_numpy(rng.normal(size=(batch, groups, d)).astype(
        np.float32)).to(dev)
    if not dense:
        print("interp schedule: blocks of 128 points, eight a SM; the first "
              "warps search the valid points, one a lane, while the others write "
              "the masked points' zero rows; then every warp writes valid rows, "
              "keeping the last centers' feature pieces")
    res = {}
    for bf16 in (False, True):
        ko = ip._three_nn_cuda(pts, mask, centers, feats, bf16)
        ko2 = ip._three_nn_cuda(pts, mask, centers, feats, bf16)
        po = torch.cat([ip._three_nn_plain(pts[i:i + 1], mask[i:i + 1],
                                           centers[i:i + 1], feats[i:i + 1], bf16)
                        for i in range(batch)])
        torch.cuda.synchronize()
        # the same selections and float32 operations in the same order:
        # every bit equal, also between two launches
        bits = torch.int16 if bf16 else torch.int32
        n_diff = int((ko.view(bits) != po.view(bits)).sum())
        assert n_diff == 0, f"interp {ko.dtype}: {n_diff} values differ"
        assert torch.equal(ko.view(bits), ko2.view(bits)), "two launches differ"
        ms = _time_ms(lambda: ip._three_nn_cuda(pts, mask, centers, feats, bf16), 5)
        # the search alone (nothing written) and the writer alone (every
        # point written as masked: the output stream with no gather)
        search_ms, write_ms = (_time_ms(functools.partial(
            ip._three_nn_cuda, pts, mask, centers, feats, bf16, phases=ph), 5)
            for ph in (1, 2))
        plain_ms = _time_ms(lambda: [ip._three_nn_plain(
            pts[i:i + 1], mask[i:i + 1], centers[i:i + 1], feats[i:i + 1], bf16)
            for i in range(batch)], 1)
        n_valid = float(mask.sum())
        ops = 9.0 * groups * n_valid + 5.0 * n_valid * d
        p = size * size
        nbytes = batch * (p * 13 + groups * 12 + groups * d * 4
                          + p * d * ko.element_size())
        bound_ms, bound_by = _bound(ops, PEAK_FP32_NO_FMA, nbytes)
        print(f"interp {ko.dtype} B={batch} P={p} G={groups} D={d} "
              f"({int(n_valid)} valid): bit-identical to the plain version, two "
              f"launches identical; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}, output "
              f"{ko.element_size()} bytes a value), "
              f"{bound_ms / ms * 100:.1f} % of the bound; search alone "
              f"{search_ms:.3f} ms, zeros written alone {write_ms:.3f} ms")
        res[bf16] = dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
    return res[False]


def check_bank_min_int8(rng, dev, nq: int, nb: int, d: int = 768,
                        noload: bool = False):
    """Indices and raw values bit-identical to the plain version, and over
    two launches; with ``noload``, also the kernel timed on stages loaded
    once (its timing aid)."""
    import torch
    from cmdiad_tpu_torch.ops import bank_min as bm
    q = torch.from_numpy(rng.normal(size=(nq, d)).astype(np.float32)).to(dev)
    bank = torch.from_numpy(rng.normal(size=(nb, d)).astype(np.float32)).to(dev)
    q8, qs = bm.quantize_rows(q)
    b8, bs = bm.quantize_rows(bank)
    bnorm = torch.sum(bank * bank, dim=1).contiguous()
    kv, ki = bm._bank_min_int8_cuda(q8, qs, b8, bs, bnorm)
    pv, pi = bm._bank_min_int8_plain(q8, qs, b8, bs, bnorm)
    # CTAs publish their tiles' minima with atomics in no fixed order; the
    # packed (value, row) keys make the result independent of that order
    kv2, ki2 = bm._bank_min_int8_cuda(q8, qs, b8, bs, bnorm)
    torch.cuda.synchronize()
    assert torch.equal(ki, ki2) and torch.equal(
        kv.view(torch.int32), kv2.view(torch.int32)), "two launches differ"
    # exact: the s8 product is exact on both sides and the dequantise and
    # subtract steps are rounded one by one in the same order
    n_idx = int((ki != pi).sum())
    n_val = int((kv != pv).sum())
    assert n_idx == 0 and n_val == 0, (n_idx, n_val)
    run = functools.partial(bm._bank_min_int8_cuda, q8, qs, b8, bs, bnorm)
    ms = _time_ms(run, 5)
    plain_ms = _time_ms(lambda: bm._bank_min_int8_plain(q8, qs, b8, bs, bnorm), 3)
    library_ms = _time_ms(lambda: torch.cdist(q, bank).min(1), 3)
    ops = 2.0 * nq * nb * d
    nbytes = nq * d + nb * d + nb * 8 + nq * 4 + nq * 8
    bound_ms, bound_by = _bound(ops, PEAK_INT8, nbytes)
    print(f"bank_min_int8 nq={nq} nb={nb} d={d}: indices and raw values "
          f"identical on all {nq} queries, two launches identical; kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, cdist+min {library_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), {ops / ms / 1e9:.1f} TOP/s")
    if noload:
        # the main loop and fold with no load to wait for (wrong results)
        t = [_time_ms(functools.partial(run, reload=False), 5) for _ in range(3)]
        print(f"bank_min_int8 nq={nq} nb={nb}: on stages loaded once "
              f"{min(t):.3f}-{max(t):.3f} ms (three readings; the loads' "
              f"share of the time)")
    return dict(max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms)


# Fused attention against its plain version, tolerances fixed before the
# first run: float32 differs in summation order only; bfloat16 rounds p and
# the output at the same points, so an element differs where a float32 sum
# lands on the other side of a bfloat16 rounding boundary: one output ulp
# (2^-7 of the value) plus ulps of p (1e-3 absolute at these magnitudes).
FLASH_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2.0 ** -7, 1e-3)}


def check_flash(rng, dev, dtype: str, n: int, heads: int, batch: int = 8,
                d: int = 64):
    import torch
    import torch.nn.functional as F
    from cmdiad_tpu_torch.ops import flash_attn as fa
    tdt = getattr(torch, dtype)
    # q, k, v as the backbones hand them over: views of the qkv projection
    qkv = torch.from_numpy(rng.normal(size=(batch, n, 3, heads, d)).astype(
        np.float32)).to(dev, tdt)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    scale = d ** -0.5
    ko = fa._fused_attention_cuda(q, k, v, scale).float()
    po = fa._fused_attention_plain(q, k, v, scale).float()
    torch.cuda.synchronize()
    rtol, atol = FLASH_TOL[dtype]
    err = float(torch.max(torch.abs(ko - po)))
    excess = float(torch.max(torch.abs(ko - po) - rtol * torch.abs(po)))
    assert excess <= atol, (dtype, n, err, excess)
    ms = _time_ms(lambda: fa._fused_attention_cuda(q, k, v, scale), 10)
    plain_ms = _time_ms(lambda: fa._fused_attention_plain(q, k, v, scale), 3)
    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qh, kh, vh, scale=scale), 10)
    flops = 2 * 2.0 * batch * heads * n * n * d          # q.k^T and p.v
    n_exp = float(batch * heads * n * n)                 # one per score
    nbytes = 4 * batch * n * heads * d * qkv.element_size()
    bound_ms, bound_by = _bound(flops, PEAK_BF16 if dtype == "bfloat16"
                                else PEAK_FP32, nbytes, sfu_ops=n_exp)
    print(f"flash_attn {dtype} B={batch} H={heads} N={n} D={d}: max abs err "
          f"{err:.3e} (tolerance {rtol:g} relative + {atol:g}); kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, sdpa {library_ms:.3f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}), "
          f"{flops / ms / 1e9:.1f} TFLOP/s, {n_exp / ms / 1e9:.2f} T "
          f"exponentials/s (one per score)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


# the JAX probe's two shapes, one whose M and N are not multiples of the
# kernel's 128 x 256 tile, and one large enough (8192 x 8192 outputs) that
# the rates and not one tile's latency decide the ratio
PROBE_SHAPES = ((128, 256, 128), (192, 256, 320), (1024, 768, 2048),
                (8192, 768, 8192))
ROW_SHAPE = (1024, 768, 2048)   # the kernels line's int8 row


def phase_probe(rng, dev):
    """The int8-vs-bf16 tensor-core probe: one product per shape and type,
    launches counted around those calls alone, then each checked against
    its plain version (int8 exact, bf16 to float32 summation order), run
    once more (identical output) and timed against the PyTorch call that
    computes the same function, eagerly (the kernels line's times; the
    host's cost of a call decides them at the small shapes) and in CUDA
    graphs (device time), both printed."""
    import torch
    from cmdiad_tpu_torch import kernels
    from cmdiad_tpu_torch.ops import int8_dot as i8
    ops_in = []
    for m, k, n in PROBE_SHAPES:
        a = torch.from_numpy(rng.integers(-127, 127, (m, k)).astype(np.int8)).to(dev)
        b = torch.from_numpy(rng.integers(-127, 127, (n, k)).astype(np.int8)).to(dev)
        ops_in += [(a, b), (a.to(torch.bfloat16), b.to(torch.bfloat16))]
    kernels.reset_launches()
    outs = [i8.int8_dot(a, b) for a, b in ops_in]
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["int8_dot"]
    res, times, lib_times = None, {}, {}
    for (a, b), out in zip(ops_in, outs):
        m, k = a.shape
        n = b.shape[0]
        want = i8._int8_dot_plain(a, b)
        assert torch.equal(i8._int8_dot_cuda(a, b), out), "two launches differ"
        if a.dtype == torch.int8:
            assert torch.equal(out, want), "int8 probe product is not exact"
            err = 0.0
            library = functools.partial(torch._int_mm, a, b.t())
            label = "torch._int_mm"
            peak = PEAK_INT8
        else:
            err = float(torch.max(torch.abs(out - want)))
            # float32 sums of integers up to 127^2 * k: order-only rounding
            assert err <= 1e-6 * k * 127 * 127, err
            # float32 out from bfloat16 operands, as the kernel writes
            library = functools.partial(torch.mm, a, b.t(),
                                        out_dtype=torch.float32)
            label = "torch.mm out_dtype=float32"
            peak = PEAK_BF16
        kernel = functools.partial(i8._int8_dot_cuda, a, b)
        eager_ms, eager_lib_ms = _time_ms(kernel, 20), _time_ms(library, 20)
        ms, library_ms = _graph_ms(kernel, 20), _graph_ms(library, 20)
        plain_ms = _time_ms(lambda: i8._int8_dot_plain(a, b), 5)
        ops = 2.0 * m * n * k
        nbytes = (m + n) * k * a.element_size() + m * n * 4
        bound_ms, bound_by = _bound(ops, peak, nbytes)
        times[(m, k, n, str(a.dtype))] = ms
        lib_times[(m, k, n, str(a.dtype))] = library_ms
        print(f"int8_dot {a.dtype} {m}x{k}x{n}: max abs err {err:.3e}; "
              f"eager kernel {eager_ms:.4f} ms, library {eager_lib_ms:.4f} ms "
              f"({label}); in a CUDA graph kernel {ms:.4f} ms "
              f"({ops / ms / 1e9:.1f} TOP/s), library {library_ms:.4f} ms; "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by})")
        if a.dtype == torch.int8 and (m, k, n) == ROW_SHAPE:
            # the kernels line keeps the eager times, as every other row
            # and the probe's earlier rows have them
            res = dict(max_abs_err=err, ms=eager_ms, plain_ms=plain_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       library_ms=eager_lib_ms)
            # the host's share of an eager call: the C launcher alone
            # (three tensor-map encodings and the launch), output allocated
            # once, against the Python wrapper around it
            fn = kernels.library("int8_dot").int8_dot_launch
            stream = torch.cuda.current_stream().cuda_stream
            c_out = torch.empty_like(out)
            c_ms = _time_ms(lambda: fn(a.data_ptr(), b.data_ptr(),
                                       c_out.data_ptr(), m, n, k, 1, stream), 20)
            assert torch.equal(c_out, want)
            print(f"int8_dot {a.dtype} {m}x{k}x{n}: eager C launcher alone "
                  f"{c_ms:.4f} ms against {eager_ms:.4f} through the wrapper "
                  f"and {ms:.4f} of device time")
    for m, k, n in PROBE_SHAPES[2:]:
        key_b, key_i = (m, k, n, "torch.bfloat16"), (m, k, n, "torch.int8")
        print(f"int8_dot: int8 is {times[key_b] / times[key_i]:.2f}x the bf16 "
              f"speed at {m}x{k}x{n} under wgmma (the library calls: "
              f"{lib_times[key_b] / lib_times[key_i]:.2f}x; device times "
              f"in CUDA graphs)")
    print(f"int8_dot: {launches} probe launches")
    return res, launches


KERNEL_ROWS = (
    ("bank_min_bf16", "bank_min", "cmdiad_tpu_torch/csrc/bank_min.cu",
     "cmdiad_tpu/ops/pallas_scoring.py:98"),
    ("bank_min_int8", "bank_min_int8", "cmdiad_tpu_torch/csrc/bank_min_int8.cu",
     "cmdiad_tpu/ops/pallas_scoring.py:66"),
    ("masked_fps", "fps", "cmdiad_tpu_torch/csrc/fps.cu",
     "cmdiad_tpu/ops/fps.py:55"),
    ("three_nn_interp", "interp", "cmdiad_tpu_torch/csrc/interp.cu",
     "cmdiad_tpu/ops/pallas_interp.py:38"),
    ("flash_attn", "flash_attn", "cmdiad_tpu_torch/csrc/flash_attn.cu",
     "cmdiad_tpu/ops/flash_attn.py:59"),
    ("int8_dot", "int8_dot", "cmdiad_tpu_torch/csrc/int8_dot.cu",
     "benchmarks/probe_int8_dot.py:19"),
    # replace no TPU kernel: the JAX package's host routine, and its
    # XLA-compiled loop
    ("dbscan", "dbscan", "cmdiad_tpu_torch/csrc/dbscan.cu",
     "cmdiad_tpu/native/cmdiad_native.cc:268 dbscan (host C++)"),
    ("ocsvm_sgd", "ocsvm_sgd", "cmdiad_tpu_torch/csrc/ocsvm_sgd.cu",
     "cmdiad_tpu/fusion/ocsvm.py:78 _fit_jax (XLA scan)"),
)

# the kernels each detection path must launch; the JSON row of a kernel
# takes its launches from the first path listed here that runs it
PATHS = {
    "default": (dict(), ("bank_min", "fps", "interp")),
    "throughput": (dict(compute_dtype="bfloat16", dist_method_s="l2_int8",
                        use_flash=True),
                   ("bank_min_int8", "flash_attn", "fps", "interp")),
}


def phase_kernels(dev):
    rng = np.random.default_rng(SEED)
    res = {}
    res["bank_min"] = check_bank_min(rng, dev, 8 * 3136, 65536)
    check_bank_min(rng, dev, 8 * 784, 16384)
    # the banks of phase 3 (16 train samples, f_coreset 0.1) pad to 8192
    check_bank_min(rng, dev, 8 * 3136, 8192)
    check_bank_min(rng, dev, 8 * 784, 8192)
    print("bank_min_int8 schedule: 128 x 256 tiles, a 4-stage TMA ring of "
          "128-byte stages, two consumer warpgroups folding together (no "
          "ping-pong)")
    res["bank_min_int8"] = check_bank_min_int8(rng, dev, 8 * 3136, 65536,
                                               noload=True)
    check_bank_min_int8(rng, dev, 8 * 784, 16384)
    check_bank_min_int8(rng, dev, 8 * 3136, 8192)
    check_bank_min_int8(rng, dev, 8 * 784, 8192)
    res["fps"] = check_fps(rng, dev)
    check_fps(rng, dev, batch=1)
    check_fps(rng, dev, batch=3)
    # FtoI rgb main: every point of the hallucinated 224² cloud
    check_fps(rng, dev, capacity=224 * 224, dense=True)
    res["interp"] = check_interp(rng, dev)
    # FtoI rgb main: the regressed cloud, every one of its 50176 points valid
    check_interp(rng, dev, dense=True)
    # ViT-B/8 (785 tokens, 12 heads), Point-MAE (1024 tokens, 6 heads),
    # DINOv2 at 518² (1370 tokens, 12 heads), Point-BERT (1025, 6)
    res["flash_attn"] = check_flash(rng, dev, "bfloat16", 785, 12)
    for dtype in ("bfloat16", "float32"):
        for n, heads in ((1024, 6), (1370, 12), (1025, 6)) + (
                ((785, 12),) if dtype == "float32" else ()):
            check_flash(rng, dev, dtype, n, heads)
    # phase 8's shapes a rank: a 4096-row shard of the 8192-padded banks
    # (shard_bank at world 2), 4 of the 8 samples (data-parallel at world 2)
    check_bank_min(rng, dev, 8 * 3136, 4096)
    check_bank_min_int8(rng, dev, 8 * 3136, 4096)
    check_fps(rng, dev, batch=4)
    check_interp(rng, dev, batch=4)
    check_flash(rng, dev, "bfloat16", 785, 12, batch=4)
    res["int8_dot"], probe_launches = phase_probe(rng, dev)
    return res, probe_launches


# --------------------------------------------------------------------------
# phase 3: the detection paths
# --------------------------------------------------------------------------

# Throughput path against the default path on the same data: the JAX
# package's own envelopes, bfloat16 backbones (tests/test_e2e.py:237-238:
# 0.01 on pixel AUROC and AU-PRO) plus int8 scoring
# (tests/test_tpu_only.py:139-140: 0.02 and 0.05), summed.
THROUGHPUT_ENVELOPE = {"pixel_rocauc": 0.01 + 0.02, "au_pro": 0.01 + 0.05}


def phase_path(dev, name: str, samples, state_path: str, profile=None):
    """fit + evaluate one path with the launch counts set to 0 before and
    read after, profiling one more evaluation pass into the directory
    ``profile`` if given; the fitted state is written to ``state_path``.
    Returns (launches, metrics, eval ms a test image, (image scores, maps)
    of the first evaluation)."""
    import torch
    from cmdiad_tpu_torch import kernels
    from cmdiad_tpu_torch.config import Config
    from cmdiad_tpu_torch.runner import CMDIADRunner

    extra, required = PATHS[name]
    cfg = Config(batch_size=8, seed=SEED, **extra)
    train, test = samples
    runner = CMDIADRunner(cfg, device=dev)

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    runner.fit("synthetic", train)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    metrics = runner.evaluate("synthetic", test)
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"{name} path launches {launches}")
    for k in required:
        assert launches[k] > 0, f"kernel {k} was not launched on the {name} path"

    method = runner.method
    print(f"{name}: fit {fit_s:.2f} s (16 samples, batch 8; kernels built in "
          f"phase 1): " + ", ".join(f"{k} {v:.3f} s" for k, v in runner.timings.items())
          + f"; bank sizes {method.bank_sizes}; metrics {metrics}")
    for k, v in metrics.items():
        assert np.isfinite(v) and 0.0 <= v <= 1.0, (k, v)
    preds = np.stack(method.predictions)
    assert preds.shape == (8, 224, 224) and np.all(np.isfinite(preds))
    predictions = (np.asarray(method.image_preds), preds)
    method.save_state(state_path)

    # second passes, timed with CUDA events: evaluate again, and fit a fresh
    # runner that shares the (warm) backbone
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    method.reset_predictions()
    start.record()
    runner.evaluate("synthetic", test)
    end.record()
    torch.cuda.synchronize()
    eval_ms = start.elapsed_time(end) / len(test)
    refit = CMDIADRunner(cfg, backbone=method.backbone, device=dev)
    start.record()
    refit.fit("synthetic", train)
    end.record()
    torch.cuda.synchronize()
    fit_ms = start.elapsed_time(end) / len(train)
    print(f"{name}: evaluate {eval_ms:.2f} ms/image (second pass, batch 8, "
          f"including metrics); fit {fit_ms:.2f} ms/image (second pass: "
          + ", ".join(f"{k} {v:.3f} s" for k, v in refit.timings.items()) + ")")
    if profile:
        _profile_eval(runner, test, name, profile)

    compare_with_cpu(cfg, method, test[:2])
    return launches, metrics, eval_ms, predictions


@contextlib.contextmanager
def _bank_choices(log, forced=None):
    """Record each scoring call's (queries, bank, chosen rows) in ``log``;
    with ``forced`` (an earlier log) take that log's rows instead of
    searching, and report their exact distances."""
    from cmdiad_tpu_torch.ops import scoring
    from cmdiad_tpu_torch.ops.bank_min import exact_refine
    originals = {n: getattr(scoring, n) for n in ("bank_min_bf16", "bank_min_int8")}

    def chooser(search):
        def choose(patch, bank, **kw):
            if forced is None:
                val, idx = search(patch, bank, **kw)
            else:
                idx = forced[len(log)][2].to(patch.device)
                val = exact_refine(patch, bank, idx)
            log.append((patch.cpu(), bank.cpu(), idx.cpu()))
            return val, idx
        return choose

    for n, fn in originals.items():
        setattr(scoring, n, chooser(fn))
    try:
        yield
    finally:
        for n, fn in originals.items():
            setattr(scoring, n, fn)


def _predict(method, samples):
    from cmdiad_tpu_torch.data.loader import stack_batches
    method.reset_predictions()
    for batch in stack_batches(samples, len(samples)):
        method.predict_batch(batch)
    return np.asarray(method.image_preds), np.stack(method.predictions)


def _cross_term_envelope(metric, qabs, sq, ba, bb):
    """Bound on |q~.b~ - q.b| for rows ba and bb (per patch), for queries of
    magnitudes ``qabs`` and (int8) row scales ``sq``.
    bf16: each product of rounded operands errs by (2u + u^2)|q_i b_i|, the
    float32 sum by d 2^-24 sum|q_i b_i|.
    int8: |q~_i - q_i| <= sq/2 and |b~_i - b_i| <= sb/2, so the cross term
    errs by (sq/2) sum|b_i| + (sb/2) sum|q_i| + d sq sb / 4; the integer
    product is exact and its dequantisation rounds twice (2^-22 of it)."""
    d = qabs.shape[1]
    out = 0.0
    for b in (ba, bb):
        qb = (qabs * b.abs()).sum(1)
        if metric == "l2":
            u = 2.0 ** -8                      # bfloat16 unit roundoff
            out = out + (2 * u + u * u + d * 2.0 ** -24) * qb
        else:
            sb = b.abs().amax(1) / 127.0
            out = out + (sq / 2 * b.abs().sum(1) + sb / 2 * qabs.sum(1)
                         + d * sq * sb / 4 + 2.0 ** -22 * qb)
    return out


def _check_flips(metric, gpu_log, cpu_log, label: str = "card vs CPU") -> int:
    """Count the patches whose bank row differs between the card and the
    CPU, and hold each such pair of rows to the envelope in which the
    quantised product cannot order them.  Both devices minimise
    |b|^2 - 2 q~.b~; that differs from the exact |b|^2 - 2 q.b by twice the
    cross term's error, so two rows ordered differently by the two devices
    have exact squared distances within 2 (E_a + E_b), plus what the two
    devices' features (q_gpu - q_cpu) and float32 row norms change."""
    n_flip = n_all = 0
    for (qg, bank, ig), (qc, _, ic) in zip(gpu_log, cpu_log):
        n_all += ig.numel()
        flip = ig != ic
        n_flip += int(flip.sum())
        if not bool(flip.any()):
            continue
        qg, qc = qg[flip].double(), qc[flip].double()
        ba, bb = bank[ig[flip]].double(), bank[ic[flip]].double()
        d = qc.shape[1]
        qabs = qg.abs().maximum(qc.abs())
        sq = qabs.amax(1) / 127.0
        env = (2.0 * _cross_term_envelope(metric, qabs, sq, ba, bb)
               + 2.0 * (qg - qc).norm(dim=1) * (ba - bb).norm(dim=1)
               + d * 2.0 ** -23 * ((ba * ba).sum(1) + (bb * bb).sum(1)))
        gap = ((qc - ba) ** 2).sum(1) - ((qc - bb) ** 2).sum(1)
        worst = float((gap.abs() / env).max())
        print(f"  {int(flip.sum())} of {ig.numel()} patches chose another "
              f"bank row; largest |d_a^2 - d_b^2| is {worst:.3f} of its "
              f"{metric} envelope")
        assert worst <= 1.0, worst
    print(f"{label} bank rows: {n_flip} of {n_all} patches differ, "
          f"every one inside the {metric} envelope")
    return n_flip


# The maps the CPU computes on the card's bank rows, against the card's, as
# a share of the map maximum (limits fixed before the first run):
# float32 backbones differ in summation order only; bfloat16 backbones
# round their GEMM sums apart on the two devices, so features differ by
# bfloat16 ulps and each patch distance by at most |q_gpu - q_cpu|.
SAME_ROWS_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 1e-1)}


def _replay(outputs):
    """A stand-in for ``_hallucinate`` that hands back ``outputs`` in order,
    on the caller's device."""
    it = iter(outputs)
    return lambda dev, out: next(it).to(next(iter(out.values())).device)


def compare_with_cpu(cfg, method, samples):
    """Serve the card's fitted state on the CPU through the plain versions
    and hold the card's predictions for ``samples`` against it.  An MTFI
    method's fusion net is served on the CPU too, and the CPU scores the
    card's hallucinated features (FtoI re-encodes a regressed input, where
    the two devices' FPS may part at a near tie; ``check_fusion_net`` holds
    the nets themselves to each other).

    The two devices' backbones differ in summation order (float32: about
    1e-6; bfloat16: ulps of 2^-8), so where two bank rows lie within the
    quantised product's rounding of each other the two devices may choose
    different rows; the map then shows the other row's exact distance at
    that patch, spread by the blur.  Such flips are counted and each held to
    its envelope; the CPU is then run again on the card's rows, and the
    predictions must agree within ``SAME_ROWS_TOL`` and, patch by patch,
    within the triangle inequality's bound: the fused map moves by at most
    sum_k |w_k| lambda_k max |q_gpu - q_cpu| over the banks k."""
    from cmdiad_tpu_torch.methods.registry import build_method
    metric = cfg.dist_method_s
    dev = method.device
    gpu_log, cpu_log, forced_log, halls = [], [], [], []
    if method.fusion is not None:
        hallucinate = method._hallucinate
        method._hallucinate = lambda d, o: halls.append(hallucinate(d, o)) or halls[-1]
    with _bank_choices(gpu_log):
        gpu_s, gpu_maps = _predict(method, samples)
    method.__dict__.pop("_hallucinate", None)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        method.save_state(path)
        fusion = None if method.fusion is None else method.fusion.to("cpu")
        cpu_method = build_method(cfg, backbone=method.backbone.to("cpu"),
                                  device="cpu", fusion=fusion)
        cpu_method.load_state(path)
    logs = []
    for log, forced in ((cpu_log, None), (forced_log, gpu_log)):
        if halls:
            cpu_method._hallucinate = _replay(halls)
        with _bank_choices(log, forced=forced):
            logs.append(_predict(cpu_method, samples))
    (cpu_s, cpu_maps), (same_s, same_maps) = logs
    method.backbone.to(dev)
    if fusion is not None:
        fusion.to(dev)
    _check_flips(metric, gpu_log, cpu_log)

    # feature differences per bank, in the method's bank order
    dq, rel = [], []
    for (qg, _, _), (qc, _, _) in zip(gpu_log, cpu_log):
        diff = (qg.double() - qc.double())
        dq.append(float(diff.norm(dim=1).max()))
        rel.append(float(diff.norm() / qc.double().norm()))
    banks = [m[0] for m in method._batch_modalities()]
    print(f"card vs CPU {cfg.compute_dtype} features (normalised, "
          f"{' then '.join(banks)}): relative difference {', '.join(f'{r:.3e}' for r in rel)}; "
          f"largest patch |q_gpu - q_cpu| {', '.join(f'{x:.3e}' for x in dq)}")

    scale = float(np.max(np.abs(cpu_maps)))
    s_err = float(np.max(np.abs(gpu_s - cpu_s) / np.maximum(np.abs(cpu_s), 1e-6)))
    m_err = float(np.max(np.abs(gpu_maps - cpu_maps))) / scale
    s_same = float(np.max(np.abs(gpu_s - same_s) / np.maximum(np.abs(same_s), 1e-6)))
    m_same = float(np.max(np.abs(gpu_maps - same_maps))) / scale
    _, ws = cpu_method._fuser_weights()
    lam = [m[3] for m in method._batch_modalities()]
    m_bound = sum(abs(float(w)) * l * x
                  for w, l, x in zip(ws.cpu(), lam, dq)) / scale
    print(f"card vs CPU plain versions: image score rel err {s_err:.3e}, map "
          f"err {m_err:.3e} of the map maximum; on the card's bank rows: "
          f"{s_same:.3e} and {m_same:.3e} (triangle bound {m_bound:.3e})")
    s_tol, m_tol = SAME_ROWS_TOL[cfg.compute_dtype]
    assert s_same < s_tol and m_same < m_tol, (s_same, m_same)
    assert m_same <= m_bound * 1.001 + 1e-5, (m_same, m_bound)


def _profile_eval(runner, test, name, out_dir):
    """Kernel time by name over one more evaluation pass, written to
    <out_dir>/profile_eval_<name>.txt."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    runner.method.reset_predictions()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        runner.evaluate("synthetic", test)
        torch.cuda.synchronize()
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=30)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"profile_eval_{name}.txt"), "w") as f:
        f.write(table)
    print("\n".join(table.splitlines()[:25]))


# --------------------------------------------------------------------------
# phase 4: detect from disk
# --------------------------------------------------------------------------

# the fixture's two classes and their raw scan sizes; the CLI's class list
# is cut to them (the CLI runs MVTec 3D-AD's ten class names otherwise)
DISK_CLASSES = {"scan_800": 800, "scan_400": 400}
DISK_FIXTURE = dict(n_train=16, n_test_good=4, n_test_bad=4, n_test_color=2,
                    seed=SEED, anomaly_radius=(0.13, 0.18))
# the kernels each method launches on the disk path, and those it must not
METHOD_KERNELS = {
    "DINO": (("bank_min",), ("fps", "interp")),
    "Depth": (("bank_min",), ("fps", "interp")),
    "Point_MAE": (("bank_min", "fps", "interp"), ()),
}


def _detect(args):
    """``cli.main(["detect", ...])`` with the class list cut to the
    fixture's; -> (results, timings, launches in the run)."""
    import torch
    from unittest import mock
    from cmdiad_tpu_torch import cli, kernels
    from cmdiad_tpu_torch.data import mvtec3d
    kernels.reset_launches()
    with mock.patch.object(mvtec3d, "mvtec3d_classes", lambda: list(DISK_CLASSES)):
        results, timings = cli.main(["detect", "--device", "cuda", "--batch_size", "8",
                                     "--seed", str(SEED), *args])
    torch.cuda.synchronize()
    for cls, m in results.items():
        for k, v in m.items():
            assert np.isfinite(v) and 0.0 <= v <= 1.0, (cls, k, v)
    return results, timings, dict(kernels.LAUNCHES)


def phase_detect(card: str, memory_eval_ms: float, results_root: str) -> str:
    """-> the directory of the first run's saved segmentation maps (under
    ``results_root``, for phase 9's heatmaps)."""
    from cmdiad_tpu_torch.data import png, tiffio
    from cmdiad_tpu_torch.data.loader import iter_samples
    from cmdiad_tpu_torch.data.mvtec3d import MVTec3DDataset
    from cmdiad_tpu_torch.data.synthetic import make_synthetic_dataset, synthetic_files

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "mvtec")
        t0 = time.perf_counter()
        for cls, size in DISK_CLASSES.items():
            make_synthetic_dataset(root, class_names=(cls,), size=size, **DISK_FIXTURE)
        t1 = time.perf_counter()
        n = 0
        for cls, size in DISK_CLASSES.items():
            for rel, arr in synthetic_files((cls,), size=size, **DISK_FIXTURE):
                path = os.path.join(root, rel)
                got = (png.imread(path, "L" if arr.ndim == 2 else "RGB")
                       if rel.endswith(".png") else tiffio.imread(path))
                assert got.dtype == arr.dtype and np.array_equal(got, arr), rel
                n += 1
        print(f"detect from disk: wrote the fixture in {t1 - t0:.1f} s; {n} PNG "
              f"and TIFF files decode to the arrays written")
        for cls, size in DISK_CLASSES.items():
            ds = MVTec3DDataset(root, cls, "test")
            t0 = time.perf_counter()
            for i in range(4):
                png.imread(ds.records[i].rgb_path)
            decode = (time.perf_counter() - t0) / 4 * 1e3
            t0 = time.perf_counter()
            for i in range(4):
                ds.load(i)
            serial = (time.perf_counter() - t0) / 4 * 1e3
            t0 = time.perf_counter()
            k = sum(1 for _ in iter_samples(ds))
            threaded = (time.perf_counter() - t0) / k * 1e3
            print(f"{cls} ({size}²): decode + resize {threaded:.1f} ms a sample "
                  f"through iter_samples (6 threads, {k} test samples), "
                  f"{serial:.1f} ms a sample on one thread, of which the RGB "
                  f"PNG's decode {decode:.1f} ms; {card}")

        cache, res = os.path.join(tmp, "cache"), os.path.join(results_root, "results")
        common = ["--dataset_path", root, "--results_dir", res]
        first, t_first, launches = _detect([*common, "--bank_cache_dir", cache,
                                            "--save_seg_results", "true"])
        print(f"detect DINO+Point_MAE launches {launches}")
        for k in ("bank_min", "fps", "interp"):
            assert launches[k] > 0, f"{k} was not launched by detect"
        for cls, t in t_first.items():
            assert "bank_pass_s" in t and "bank_load_s" not in t, (cls, t)
            fit_s = t["bank_pass_s"] + t["coreset_s"] + t["late_fusion_s"]
            print(f"{cls}: fit {fit_s:.2f} s from disk ({DISK_FIXTURE['n_train']} samples, two passes: "
                  f"bank {t['bank_pass_s']:.2f} s, coreset {t['coreset_s']:.2f} s, "
                  f"calibration {t['late_fusion_s']:.2f} s); evaluate "
                  f"{1e3 / t['eval_images_per_s']:.2f} ms an image from disk against "
                  f"{memory_eval_ms:.2f} ms in memory (phase 3, default path); "
                  f"metrics {first[cls]}; {card}")
        again, t_again, launches = _detect([*common, "--bank_cache_dir", cache])
        for cls, t in t_again.items():
            assert "bank_load_s" in t and "bank_pass_s" not in t, (cls, t)
            assert again[cls] == first[cls], (cls, again[cls], first[cls])
            print(f"{cls}: served from the cache in {t['bank_load_s']:.3f} s, "
                  f"metrics identical; evaluate {1e3 / t['eval_images_per_s']:.2f} ms "
                  f"an image")
        assert launches["fps"] > 0 and launches["bank_min"] > 0, launches
        for method, (must, must_not) in METHOD_KERNELS.items():
            out, t, launches = _detect([*common, "--method_name", method,
                                        "--class_name", "scan_400"])
            print(f"detect {method} on scan_400: launches {launches}; fit "
                  f"{t['scan_400']['bank_pass_s']:.2f} s bank pass; metrics "
                  f"{out['scan_400']}")
            for k in must:
                assert launches[k] > 0, f"{method} did not launch {k}"
            for k in must_not:
                assert launches[k] == 0, f"{method} launched {k}"
    return os.path.join(res, "segmentation")


# --------------------------------------------------------------------------
# phase 5: MTFI few-modal inference
# --------------------------------------------------------------------------

# per preset: the kernels its evaluation (main modality only) must launch
# and those it must not; FtoI rgb main must also run FPS on every point of
# its hallucinated 224² cloud
MTFI_KERNELS = {
    "mtfi_ftof_rgb_main": (("bank_min",), ("fps", "interp")),
    "mtfi_itof_rgb_main": (("bank_min",), ("fps", "interp")),
    "mtfi_ftoi_rgb_main": (("bank_min", "fps", "interp"), ()),
    "mtfi_ftof_xyz_main": (("bank_min", "fps", "interp"), ()),
    "mtfi_itof_xyz_main": (("bank_min", "fps", "interp"), ()),
    "mtfi_ftoi_xyz_main": (("bank_min", "fps", "interp"), ()),
}
# the fusion net on the card against a copy on the CPU, same input, as a
# share of the output's largest value: float32 summation order (a limit
# fixed before the first run)
FUSION_NET_TOL = 1e-4
_META_KEYS = ("gt", "label", "rgb_path")


def check_fusion_net(method, batch):
    """The fusion net on the card and a CPU copy of it, on one batch's
    main-modality input (features from the card's backbone, or the raw
    input for HRNet)."""
    import copy
    import torch
    cfg = method.cfg
    dev = method.upload(batch, method._main_input_keys())
    out = method.backbone.extract(images=dev.get("rgb"),
                                  organized_pc=dev.get("organized_pc"),
                                  compact_pts=dev.get("points_compact"))
    rgb_main = cfg.main_modality == "rgb"
    if cfg.use_hrnet:
        x = dev["rgb" if rgb_main else "organized_pc"]
    else:
        x = out["rgb_patch2" if rgb_main else "xyz_patch"]
    if cfg.use_hn or cfg.use_hn_conv:
        def run(net, t):
            return net.generate(t, "xyz" if rgb_main else "rgb")
    else:
        def run(net, t):
            return net(t)
    with torch.no_grad():
        got = run(method.fusion, x).float().cpu()
        want = run(copy.deepcopy(method.fusion).to("cpu"), x.cpu()).float()
    err = float((got - want).abs().max() / want.abs().max())
    assert err <= FUSION_NET_TOL, err
    return err, tuple(got.shape)


def phase_mtfi(dev, samples, card: str, profile=None):
    """The six MTFI presets at full width on one shared backbone: fit on
    the 16 train samples, evaluate the 8 test samples with only the main
    modality's keys, check the banks, the launches, the fusion net and the
    predictions against the CPU; with ``profile``, one more evaluation pass
    of each preset profiled into that directory."""
    import torch
    from cmdiad_tpu_torch import kernels
    from cmdiad_tpu_torch.config import Config, method_preset
    from cmdiad_tpu_torch.data.loader import stack_batches
    from cmdiad_tpu_torch.methods.registry import build_backbone
    from cmdiad_tpu_torch.models import point_mae
    from cmdiad_tpu_torch.runner import CMDIADRunner

    train, test = samples
    backbone = build_backbone(Config(seed=SEED), dev)
    fps_points = []
    fps_call = point_mae.farthest_point_sample
    point_mae.farthest_point_sample = (
        lambda pts, *a: fps_points.append(pts.shape[1]) or fps_call(pts, *a))
    launches = {}
    try:
        for preset, (must, must_not) in MTFI_KERNELS.items():
            cfg = method_preset(preset, batch_size=8, seed=SEED)
            keep = (("rgb",) if cfg.main_modality == "rgb"
                    else ("organized_pc", "points_compact")) + _META_KEYS
            few = [{k: v for k, v in smp.items() if k in keep} for smp in test]
            runner = CMDIADRunner(cfg, backbone=backbone, device=dev)
            method = runner.method
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runner.fit("synthetic", train)
            torch.cuda.synchronize()
            fit_s = time.perf_counter() - t0
            kernels.reset_launches()
            del fps_points[:]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = runner.evaluate("synthetic", few)
            torch.cuda.synchronize()
            eval_ms = (time.perf_counter() - t0) / len(few) * 1e3
            launches[preset] = dict(kernels.LAUNCHES)
            for k, v in metrics.items():
                assert np.isfinite(v) and 0.0 <= v <= 1.0, (preset, k, v)
            main, other = cfg.main_modality, "xyz" if cfg.main_modality == "rgb" else "rgb"
            assert set(method.banks) == {main, "fusion"}, method.banks
            assert method.bank_sizes[main] > 0 and method.bank_sizes["fusion"] > 0
            assert other not in method.bank_sizes and not method._bank_acc[other]
            for k in must:
                assert launches[preset][k] > 0, f"{preset} did not launch {k}"
            for k in must_not:
                assert launches[preset][k] == 0, f"{preset} launched {k}"
            if preset == "mtfi_ftoi_rgb_main":
                assert set(fps_points) == {cfg.xyz_size ** 2}, fps_points
            err, shape = check_fusion_net(method, next(stack_batches(few[:2], 2)))
            print(f"{preset}: fit {fit_s:.2f} s (16 samples, batch 8: "
                  + ", ".join(f"{k} {runner.timings[k]:.3f} s"
                              for k in ("bank_pass_s", "coreset_s", "late_fusion_s"))
                  + f"); evaluate {eval_ms:.2f} ms an image (8 samples, main "
                  f"modality only, metrics included); banks {method.bank_sizes}; "
                  f"launches in evaluation {launches[preset]}"
                  + (f", FPS over {sorted(set(fps_points))} points" if fps_points else "")
                  + f"; fusion net {type(method.fusion).__name__} out {shape}, card "
                  f"vs CPU {err:.2e} of its largest value; metrics {metrics}; {card}")
            if profile:
                _profile_eval(runner, few, preset, profile)
            compare_with_cpu(cfg, method, few[:2])
    finally:
        point_mae.farthest_point_sample = fps_call
    return launches


# --------------------------------------------------------------------------
# phase 6: DINOv2, Point-BERT and checkpoints
# --------------------------------------------------------------------------

# card against CPU forwards of the same float32 modules, as a share of the
# features' largest value: summation order through 12 blocks (a limit
# fixed before the first run, the full-width CPU test's 1e-4)
BACKBONE_TOL = 1e-4


def check_bf16_golden(dev, card: str) -> None:
    """The throughput configuration's bfloat16 backbones at full width
    (ViT-B/8 at 224², Point-MAE over 1024 groups of 128, two blocks each;
    attention through the fused kernel) on the card, held to the JAX
    package's outputs saved in ``tests/data/jax_bf16_backbones.npz`` for
    the same weights and inputs, rebuilt here from their numpy recipe
    (``tests/bf16_golden.py``), within its stated bfloat16 tolerances."""
    import torch
    from cmdiad_tpu_torch import kernels
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    import bf16_golden

    tb, _ = bf16_golden.port_backbone(dev)
    images, pc = bf16_golden.inputs()
    kernels.reset_launches()
    out = tb.extract(images=torch.from_numpy(images), organized_pc=torch.from_numpy(pc))
    torch.cuda.synchronize()
    launches = kernels.LAUNCHES["flash_attn"]
    assert launches == 2 * bf16_golden.DEPTH, launches
    got = bf16_golden.summarize({k: v.cpu().numpy() for k, v in out.items()})
    dev_ = bf16_golden.check(got, bf16_golden.load())
    print(f"bf16 backbones at full width (ViT-B/8 224², 785 tokens x 12 heads; Point-MAE "
          f"1024 groups, 1024 tokens x 6 heads; {bf16_golden.DEPTH} blocks each; "
          f"{launches} fused-attention launches) against the saved JAX outputs, as shares "
          f"of the largest value (limits: rows {bf16_golden.ROW_TOL}, means and norms "
          f"{bf16_golden.SUMMARY_TOL}): "
          + ", ".join(f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v} differ"
                      for k, v in dev_.items()) + f"; {card}")


def phase_backbones(dev, card: str):
    """The bfloat16 backbones against the saved JAX outputs; DINOv2
    ViT-B/14 at 518² and Point-BERT, both through the fused attention
    kernel, on the card and on the CPU; then a backbone and a fusion net
    written to ``.pth`` files and loaded back through the config's
    checkpoint paths."""
    import torch
    from cmdiad_tpu_torch import kernels
    from cmdiad_tpu_torch.config import Config, method_preset
    from cmdiad_tpu_torch.methods.registry import build_backbone, build_fusion
    from cmdiad_tpu_torch.models.backbone import DualBackbone
    from cmdiad_tpu_torch.models.point_mae import PointMAEConfig
    from cmdiad_tpu_torch.models.vit import VIT_CONFIGS, LayerScale
    from cmdiad_tpu_torch.ops.masked import host_compact_points

    check_bf16_golden(dev, card)
    rng = np.random.default_rng(SEED)
    bb = DualBackbone(vit_config=VIT_CONFIGS["vit_base_patch14_dinov2.lvd142m"],
                      pm_config=PointMAEConfig(encoder_dims=256), use_flash=True,
                      device=dev, seed=SEED)
    with torch.no_grad():        # LayerScale's 1e-5 init would mute the blocks
        for m in bb.vit.modules():
            if isinstance(m, LayerScale):
                m.gamma.fill_(1.0)
    vc = bb.vit_config
    img = torch.from_numpy(rng.normal(size=(2, vc.img_size, vc.img_size, 3)).astype(
        np.float32))
    pc = _disc_cloud(rng, 2)
    compact = torch.from_numpy(np.stack([host_compact_points(p, 32768) for p in pc]))
    pc = torch.from_numpy(pc)
    kernels.reset_launches()
    t0 = time.perf_counter()
    got_rgb = bb.rgb_patches(img)
    got_xyz = bb.xyz_patches(pc, compact)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    assert launches["flash_attn"] == vc.depth + bb.pm_config.depth, launches
    bb.to("cpu")
    want_rgb = bb.rgb_patches(img)
    want_xyz = bb.xyz_patches(pc, compact)
    assert got_rgb[0].shape == (2, vc.grid ** 2, vc.embed_dim)
    assert got_rgb[1].shape == (2, 3136, vc.embed_dim)
    errs = {}
    for name, g, w in (("dinov2 rgb_patch", got_rgb[0], want_rgb[0]),
                       ("dinov2 rgb_patch2", got_rgb[1], want_rgb[1]),
                       ("point_bert group_feats", got_xyz["group_feats"],
                        want_xyz["group_feats"]),
                       ("point_bert xyz_patch", got_xyz["xyz_patch"],
                        want_xyz["xyz_patch"])):
        errs[name] = float((g.cpu() - w).abs().max() / w.abs().max())
        assert errs[name] <= BACKBONE_TOL, (name, errs[name])
    assert torch.equal(got_xyz["center_idx"].cpu(), want_xyz["center_idx"])
    print(f"DINOv2 ViT-B/14 at 518² (37² grid, 1370 tokens) and Point-BERT "
          f"(encoder 256 -> 384, cls token; 1025 tokens), float32, fused "
          f"attention ({launches['flash_attn']} launches), batch 2: card vs CPU "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
          + f" of the largest value; FPS centres identical; card forwards "
          f"{card_s:.2f} s including first-call set-up; {card}")

    with tempfile.TemporaryDirectory() as tmp:
        cfg = method_preset("mtfi_ftof_xyz_main", seed=SEED)
        src = build_backbone(cfg, dev)
        net = build_fusion(cfg, src, dev)
        paths = {k: os.path.join(tmp, f"{k}.pth") for k in ("vit", "point", "fusion")}
        torch.save({"model": src.vit.state_dict()}, paths["vit"])
        torch.save({f"base_model.{k}": v for k, v in src.point.state_dict().items()},
                   paths["point"])
        torch.save({"model": net.state_dict()}, paths["fusion"])
        loaded_cfg = cfg.replace(rgb_ckpt_path=paths["vit"], xyz_ckpt_path=paths["point"],
                                 fusion_module_path=paths["fusion"], seed=SEED + 11)
        loaded = build_backbone(loaded_cfg, dev)
        loaded_net = build_fusion(loaded_cfg, loaded, dev)
        img = torch.from_numpy(rng.normal(
            size=(2, cfg.rgb_size, cfg.rgb_size, 3)).astype(np.float32))
        pc = torch.from_numpy(_disc_cloud(rng, 2, cfg.xyz_size))
        outs = []
        with torch.no_grad():
            for b, n in ((src, net), (loaded, loaded_net)):
                feats = b.extract(images=img, organized_pc=pc)
                outs.append((feats["rgb_patch"], feats["xyz_patch"],
                             n.generate(feats["xyz_patch"], "rgb")))
        errs = [float((a - b).abs().max() / b.abs().max()) for a, b in zip(*outs)]
        assert max(errs) <= 1e-6, errs
        print(f"checkpoints: ViT-B/8 (timm names), Point-MAE (base_model. prefix) "
              f"and the FtoF MLP written to .pth and loaded through rgb_ckpt_path, "
              f"xyz_ckpt_path and fusion_module_path: rgb_patch, xyz_patch and "
              f"the hallucinated features differ from the in-memory weights' by "
              + ", ".join(f"{e:.1e}" for e in errs) + " of the largest value")


# --------------------------------------------------------------------------
# phase 7: the MTFI lifecycle, training included
# --------------------------------------------------------------------------

# train method -> the feature store (stage 1's dumps) it trains from
TRAIN_STORES = {
    "HallucinationCrossModality": "fusion",
    "HallucinationCrossModalityConv": "fusion",
    "RGBFeatureToXYZInputMLP": "frgb_xyz",
    "XYZFeatureToRGBInputMLP": "rgb_fxyz",
    "RGBFeatureToXYZInputConv": "frgb_xyz",
    "XYZFeatureToRGBInputConv": "rgb_fxyz",
    "RGBInputToXYZFeatureHRNET": "rgb_fxyz",
    "XYZInputToRGBFeatureHRNET": "frgb_xyz",
}
# FtoFMlp's extra runs: bfloat16 compute, gradient accumulation
TRAIN_VARIANTS = {"bfloat16": dict(compute_dtype="bfloat16"), "accum_iter=2": dict(accum_iter=2)}
# one step on the card against the same step on a CPU copy (same checkpoint,
# same batch of 2; limits fixed before the first run): the loss to rtol
# 1e-4 and each BatchNorm statistic to 1e-4 of its leaf's largest value in
# float32 (summation order, cuDNN's algorithm); each updated parameter to
# 1e-4 of its leaf's largest value in float64, because float32 keeps only
# about two digits of some BatchNorm nets' gradients (a BatchNorm bias
# followed by ReLU, a conv and another BatchNorm: its gradient cancels down
# to border effects), which Adam's normalised step would carry into the
# parameters on either device
TRAIN_RTOL = 1e-4
TRAIN_BATCH = 64   # the reference's batch, for the step times
# phase 7's MTFI presets serving a trained net: preset -> train method
SERVE_OCSVM_EPOCHS = 2
TRAINED_PRESETS = {"mtfi_ftof_xyz_main": "HallucinationCrossModality",
                   "mtfi_itof_rgb_main": "RGBInputToXYZFeatureHRNET"}


def _leaf_err(got: dict, want: dict) -> float:
    """The largest max|Δ| / max|leaf| over the leaves of two flat maps."""
    worst = 0.0
    for k, w in want.items():
        scale = float(np.abs(w).max())
        err = float(np.abs(np.asarray(got[k], np.float64) - w).max())
        worst = max(worst, err / scale if scale else err)
    return worst


def _to_float64(trainer) -> None:
    """The trainer's net and optimizer state in float64, in place."""
    import torch
    trainer.net.double()
    trainer.net.dtype = torch.float64
    for state in (trainer.opt.mu, trainer.opt.nu, trainer.opt.acc):
        for k in state:
            state[k] = state[k].double()


def check_train_step(cfg, ckpt, arrays, dev, feature_dim):
    """The step of phase 7's check: one trainer on the card and one on the
    CPU resume ``ckpt`` and take ``accum_iter`` steps (one update) on the
    first 2 samples, in float32 and again in float64; returns the largest
    errors (loss, BatchNorm statistics, parameters)."""
    import torch
    from cmdiad_tpu_torch.models import names
    from cmdiad_tpu_torch.train.checkpoint import flatten
    from cmdiad_tpu_torch.train.distill import DistillTrainer

    cfg = cfg.replace(resume=ckpt, output_dir="")
    batch = {k: torch.from_numpy(np.ascontiguousarray(v[:2])) for k, v in arrays.items()}
    out = {}
    for dtype in (torch.float32, torch.float64):
        runs = {}
        for d in (dev, "cpu"):
            t = DistillTrainer(cfg, feature_dim, arrays=arrays, test_arrays=arrays, device=d)
            if dtype == torch.float64:
                _to_float64(t)
            losses = [float(t.step({k: v.to(t.device, dtype) for k, v in batch.items()})[0])
                      for _ in range(cfg.accum_iter)]
            runs[d] = (losses, flatten(names.to_flax(t.table, t.net.state_dict())))
        (card_loss, card), (cpu_loss, cpu) = runs[dev], runs["cpu"]
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(card_loss, cpu_loss))
        assert loss_err <= TRAIN_RTOL, (cfg.train_method, dtype, card_loss, cpu_loss)
        stats = {k: v for k, v in cpu.items() if k.startswith("batch_stats")}
        params = {k: v for k, v in cpu.items() if k.startswith("params")}
        out[dtype] = (loss_err, _leaf_err(card, stats) if stats else 0.0,
                      _leaf_err(card, params))
        if dtype == torch.float32:
            assert out[dtype][1] <= TRAIN_RTOL, (cfg.train_method, "batch_stats", out[dtype])
        else:
            assert out[dtype][2] <= TRAIN_RTOL, (cfg.train_method, "params", out[dtype])
    return out


def time_train_step(cfg, shapes, dev, gen, feature_dim, profile=None):
    """ms a training step at batch 64 (5 steps after 2 warm-up steps,
    between CUDA events, no host sync inside), the peak device memory, and
    the step's counted FLOPs (``torch.utils.flop_counter`` over one step at
    batch 2, times 32); with ``profile``, kernel time by name over one more
    step, written to <profile>/profile_train_<method>_<dtype>.txt."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from cmdiad_tpu_torch.train.distill import DistillTrainer

    placeholder = {k: np.zeros((TRAIN_BATCH, 1), np.float32) for k in shapes}
    trainer = DistillTrainer(cfg, feature_dim, arrays=placeholder,
                             test_arrays=placeholder, device=dev)
    batch = {k: torch.randn((TRAIN_BATCH, *shape), generator=gen, device=dev)
             for k, shape in shapes.items()}
    small = {k: v[:2] for k, v in batch.items()}
    with FlopCounterMode(display=False) as counter:
        trainer.step(small)
    flops = counter.get_total_flops() * TRAIN_BATCH / 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        trainer.step(batch)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        trainer.step(batch)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 5
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if profile:
        from torch.profiler import ProfilerActivity, profile as trace
        with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trainer.step(batch)
            torch.cuda.synchronize()
        os.makedirs(profile, exist_ok=True)
        name = f"profile_train_{cfg.train_method}_{cfg.compute_dtype}.txt"
        with open(os.path.join(profile, name), "w") as f:
            f.write(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30))
    del trainer, batch
    torch.cuda.empty_cache()
    return ms, peak, flops


def phase_train(dev, samples, card: str, profile=None):
    """Stage 1: ``DINO+Point_MAE`` at full width writes the three feature
    stores; stage 2: each train method trains 2 epochs at batch 8 from them
    (FtoFMlp also in bfloat16 and with accumulation), a step of each held
    against the CPU, and every method's step timed at batch 64 in float32
    and bfloat16; stage 3: two MTFI presets serve trained checkpoints."""
    import torch
    from cmdiad_tpu_torch import kernels
    from cmdiad_tpu_torch.config import TRAIN_METHODS, Config, TrainConfig, method_preset
    from cmdiad_tpu_torch.methods.registry import build_backbone
    from cmdiad_tpu_torch.runner import CMDIADRunner
    from cmdiad_tpu_torch.train.distill import DistillTrainer, load_training_arrays

    t_phase = time.perf_counter()
    train, test = samples
    backbone = build_backbone(Config(seed=SEED), dev)
    feature_dim = backbone.pm_config.out_dim    # 768, as the ViT's
    assert backbone.vit_config.embed_dim == feature_dim
    with tempfile.TemporaryDirectory() as tmp:
        # stage 1: the dumps
        stores = {k: os.path.join(tmp, k) for k in ("fusion", "frgb_xyz", "rgb_fxyz")}
        cfg = Config(batch_size=8, seed=SEED, save_feature_for_fusion=True,
                     save_path=stores["fusion"], save_frgb_xyz=True,
                     save_path_frgb_xyz=stores["frgb_xyz"], save_rgb_fxyz=True,
                     save_path_rgb_fxyz=stores["rgb_fxyz"])
        runner = CMDIADRunner(cfg, backbone=backbone, device=dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        runner.fit("synthetic", train)
        metrics = runner.evaluate("synthetic", test)
        torch.cuda.synchronize()
        dump_s = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        for k in ("bank_min", "fps", "interp"):
            assert launches[k] > 0, f"the dumping run did not launch {k}"
        for k in ("bank_min_int8", "flash_attn"):
            assert launches[k] == 0, f"the dumping run launched {k}"
        for k, v in metrics.items():
            assert np.isfinite(v) and 0.0 <= v <= 1.0, (k, v)
        n_files = {k: len(os.listdir(os.path.join(d, "train"))) + len(os.listdir(
            os.path.join(d, "test"))) for k, d in stores.items()}
        assert all(n == len(train) + len(test) for n in n_files.values()), n_files
        print(f"phase 7 stage 1: DINO+Point_MAE fit + evaluate with the three feature "
              f"stores, {dump_s:.1f} s ({n_files} files); launches {launches}")

        # stage 2: training from the dumps
        ckpts, shapes = {}, {}
        for tm in TRAIN_METHODS:
            base = TrainConfig(train_method=tm, data_path=stores[TRAIN_STORES[tm]],
                               epochs=2, batch_size=8, save_every=1, seed=SEED)
            arrays = load_training_arrays(base, "train")
            test_arrays = load_training_arrays(base, "test")
            shapes[tm] = {k: v.shape[1:] for k, v in arrays.items()}
            runs = {"float32": {}}
            if tm == "HallucinationCrossModality":
                runs.update(TRAIN_VARIANTS)
            for name, extra in runs.items():
                out = os.path.join(tmp, f"run_{tm}_{name}")
                cfg = base.replace(output_dir=out, **extra)
                t0 = time.perf_counter()
                history = DistillTrainer(cfg, feature_dim, arrays=arrays,
                                         test_arrays=test_arrays, device=dev).train().history
                torch.cuda.synchronize()
                train_s = time.perf_counter() - t0
                assert all(np.isfinite(history[k]).all() for k in history), history
                assert sorted(os.listdir(out)) == ["checkpoint-0.npz", "checkpoint-1.npz",
                                                   "metrics.jsonl"], os.listdir(out)
                line = (f"{tm} ({name}): 2 epochs of {len(train)} samples, batch 8, "
                        f"{train_s:.2f} s; train loss {history['train_loss']}, test loss "
                        f"{history['test_loss']}")
                if name == "float32":
                    ckpts[tm] = os.path.join(out, "checkpoint-1.npz")
                    errs = check_train_step(cfg, ckpts[tm], arrays, dev, feature_dim)
                    line += ("; one step card vs CPU from checkpoint-1, batch 2: float32 "
                             f"loss {errs[torch.float32][0]:.1e}, BatchNorm statistics "
                             f"{errs[torch.float32][1]:.1e}, parameters "
                             f"{errs[torch.float32][2]:.1e}; float64 loss "
                             f"{errs[torch.float64][0]:.1e}, parameters "
                             f"{errs[torch.float64][2]:.1e} of the leaf's largest")
                print(line)

        # the step times at the reference's batch
        gen = torch.Generator(device=dev).manual_seed(SEED)
        peaks = {"float32": PEAK_FP32, "bfloat16": PEAK_BF16}
        for tm in TRAIN_METHODS:
            for dtype, peak in peaks.items():
                cfg = TrainConfig(train_method=tm, batch_size=TRAIN_BATCH, seed=SEED,
                                  output_dir="", compute_dtype=dtype, warmup_epochs=0)
                ms, mem, flops = time_train_step(cfg, shapes[tm], dev, gen, feature_dim,
                                                 profile)
                bound = flops / peak * 1e3
                print(f"train step {tm} {dtype} batch {TRAIN_BATCH}: {ms:.2f} ms, bound "
                      f"{bound:.2f} ms ({flops / 1e12:.2f} TFLOP counted at "
                      f"{peak / 1e12:.0f} TFLOP/s), peak memory {mem:.1f} GiB; {card}")

        # stage 3: the trained nets serve few-modal inference
        for preset, tm in TRAINED_PRESETS.items():
            must, must_not = MTFI_KERNELS[preset]
            # the calibration's numpy OCSVM took 42-46 s of FtoF xyz main's
            # serving run on an H100 (some 3 s an epoch, up to 20 epochs)
            # and repeats phase 5's; its epochs are cut to keep the script
            # in time
            cfg = method_preset(preset, batch_size=8, seed=SEED, fusion_module_path=ckpts[tm],
                                ocsvm_maxiter=SERVE_OCSVM_EPOCHS)
            keep = (("rgb",) if cfg.main_modality == "rgb"
                    else ("organized_pc", "points_compact")) + _META_KEYS
            few = [{k: v for k, v in smp.items() if k in keep} for smp in test]
            runner = CMDIADRunner(cfg, backbone=backbone, device=dev)
            t0 = time.perf_counter()
            runner.fit("synthetic", train)
            kernels.reset_launches()
            metrics = runner.evaluate("synthetic", few)
            torch.cuda.synchronize()
            launches = dict(kernels.LAUNCHES)
            for k, v in metrics.items():
                assert np.isfinite(v) and 0.0 <= v <= 1.0, (preset, k, v)
            for k in must:
                assert launches[k] > 0, f"{preset} did not launch {k}"
            for k in must_not:
                assert launches[k] == 0, f"{preset} launched {k}"
            print(f"{preset} serving the trained {tm} checkpoint: fit + evaluate "
                  f"{time.perf_counter() - t0:.1f} s; launches in evaluation {launches}; "
                  f"metrics {metrics}")
    print(f"phase 7: {time.perf_counter() - t_phase:.1f} s; {card}")


# --------------------------------------------------------------------------
# phase 8: multi-device
# --------------------------------------------------------------------------

# the argument of each kernel's C launcher that says what a rank gave it:
# a bank-min kernel's bank rows, the other kernels' batch
LAUNCH_SHAPE_ARG = {"bank_min": 4, "bank_min_int8": 6, "fps": 2, "interp": 5,
                    "flash_attn": 4}
# phase 3's fitted states served on the mesh, and phase 8's own fits:
# tag -> (path, Config overrides, serve phase 3's state (else fit))
MULTI_RUNS = {
    1: {"dp": ("default", dict(mesh_shape=(1,)), False),
        "shard": ("default", dict(shard_bank=True), False)},
    2: {"dp": ("default", dict(mesh_shape=(2,)), True),
        "dp_fit": ("default", dict(mesh_shape=(2,)), False),
        "dp_throughput": ("throughput", dict(mesh_shape=(2,)), True),
        "shard": ("default", dict(shard_bank=True), True),
        "shard_throughput": ("throughput", dict(shard_bank=True), True)},
}
# what each world-2 run must launch, and with which shape: data-parallel
# runs extract 4 of the 8 test samples a rank, sharded banks hold 4096 of
# the 8192 padded rows a rank
MULTI_SHAPES = {"dp": {"bank_min": None, "fps": {4}, "interp": {4}},
                "dp_throughput": {"bank_min_int8": None, "fps": {4}, "interp": {4},
                                  "flash_attn": {4}},
                "shard": {"bank_min": {4096}, "fps": {8}, "interp": {8}},
                "shard_throughput": {"bank_min_int8": {4096}, "flash_attn": {8}}}
# How phase 8's predictions are held to phase 3's (fixed before the first
# run).  A data-parallel rank extracts 4 samples where phase 3 extracted 8,
# so its GEMMs may take other cuBLAS algorithms and its features move by
# rounding; a sharded bank lets each shard choose its row through the
# quantised product and the exact distances of the shards' rows decide, so
# a near tie across shards may pick another row than the whole bank's
# choice.  Either way a patch may take another bank row, as the card and
# the CPU may in phase 3: phase 3's replicated state is served here again
# with the rows each scoring call chose recorded, every row the mesh chose
# differently is held to the quantised product's envelope
# (``_check_flips``), and the replicated state is served once more on the
# mesh's rows, where the predictions must agree within SAME_ROWS_TOL.  A
# data-parallel fit's metrics: the JAX package's DP tolerance, 5e-3
# (tests/test_parallel.py).
DP_METRIC_TOL = 5e-3
# one DP training step at 2 x 32 against one step at 64, float64
# parameters, as a share of a leaf's largest value: the MLP's LayerNorm
# computes in float32 in a float64 net (phase 7's card-vs-CPU limit, 1e-4);
# HRNet's is tests/test_torch_parallel_train.py's 1e-8 (its BatchNorm-bias
# gradients cancel down to border effects, so float64 keeps fewer of their
# digits, and Adam's first step moves a parameter by up to lr times its
# gradient's relative error)
MULTI_TRAIN = {"HallucinationCrossModality": ({"patch": (3136, 1536)}, 1e-4),
               "RGBInputToXYZFeatureHRNET": ({"image": (224, 224, 3),
                                              "feature": (3136, 768)}, 1e-8)}


def _rank_detect(device, world, samples, states):
    """Phase 8's detection runs on this rank (``MULTI_RUNS[world]``): serve
    phase 3's fitted state, or fit, then evaluate phase 3's test samples in
    one batch of 8, every launch's shape recorded.  Returns, per run, the
    metrics, predictions, launches, launch shapes, bank rows and the ms a
    test image of a second evaluation."""
    import torch
    from cmdiad_tpu_torch import kernels
    from cmdiad_tpu_torch.config import Config
    from cmdiad_tpu_torch.methods.registry import build_backbone, build_method
    from cmdiad_tpu_torch.runner import CMDIADRunner

    from cmdiad_tpu_torch.parallel import eval as parallel_eval

    shapes = {}
    launch = kernels.launch
    sharded_min = parallel_eval.sharded_bank_min_dist
    rows = []

    def sharded_rows(mesh, patch, bank_local, *a, **k):
        v, idx = sharded_min(mesh, patch, bank_local, *a, **k)
        rows.append((patch.cpu(), None, idx.cpu()))
        return v, idx
    parallel_eval.sharded_bank_min_dist = sharded_rows

    def recording(name, *args):
        if name in LAUNCH_SHAPE_ARG:
            shapes.setdefault(name, set()).add(args[LAUNCH_SHAPE_ARG[name]])
        launch(name, *args)
    kernels.launch = recording
    train, test = samples
    backbones, out = {}, {}
    for tag, (path, extra, serve) in MULTI_RUNS[world].items():
        cfg = Config(batch_size=8, seed=SEED, **PATHS[path][0], **extra)
        if path not in backbones:
            backbones[path] = build_backbone(cfg, device)
        if serve:
            method = build_method(cfg, backbone=backbones[path])
            method.load_state(states[path])
        else:
            runner = CMDIADRunner(cfg, backbone=backbones[path], device=device)
            runner.fit("synthetic", train)
            method = runner.method
        kernels.reset_launches()
        shapes.clear()
        rows.clear()
        with _bank_choices(rows):        # the data-parallel path's choices
            _predict(method, test)
        torch.cuda.synchronize(device)
        result = dict(launches=dict(kernels.LAUNCHES), shapes=dict(shapes),
                      rows=[(q, idx) for q, _, idx in rows],
                      metrics=method.calculate_metrics(),
                      preds=(np.asarray(method.image_preds), np.stack(method.predictions)),
                      bank_rows={n: int(b.shape[0]) for n, b in method.banks.items()})
        t0 = time.perf_counter()
        _predict(method, test)
        torch.cuda.synchronize(device)
        result["ms"] = (time.perf_counter() - t0) * 1e3 / len(test)
        out[tag] = result
    kernels.launch = launch
    parallel_eval.sharded_bank_min_dist = sharded_min
    return out


def _train_batch(shapes, dev):
    """A float64 batch of 64 of ``shapes``, the same in every process."""
    import torch
    gen = torch.Generator(device=dev).manual_seed(SEED)
    return {k: torch.randn((TRAIN_BATCH, *shape), generator=gen, device=dev,
                           dtype=torch.float64) for k, shape in shapes.items()}


def _train_step64(dev, tm, mesh_shape):
    """One float64 training step of ``tm`` at batch 64 (this rank's block
    of it on a mesh); returns (loss, flat parameters)."""
    from cmdiad_tpu_torch.config import TrainConfig
    from cmdiad_tpu_torch.models import names
    from cmdiad_tpu_torch.parallel.mesh import shard_batch
    from cmdiad_tpu_torch.train.checkpoint import flatten
    from cmdiad_tpu_torch.train.distill import DistillTrainer

    shapes = MULTI_TRAIN[tm][0]
    cfg = TrainConfig(train_method=tm, batch_size=TRAIN_BATCH, seed=SEED, output_dir="",
                      warmup_epochs=0, mesh_shape=mesh_shape)
    placeholder = {k: np.zeros((TRAIN_BATCH, 1), np.float32) for k in shapes}
    trainer = DistillTrainer(cfg, 768, arrays=placeholder, test_arrays=placeholder, device=dev)
    _to_float64(trainer)
    batch = _train_batch(shapes, dev)
    if trainer.mesh is not None:
        batch = {k: shard_batch(v, trainer.mesh)[0] for k, v in batch.items()}
    loss, _ = trainer.step(batch)
    params = {k: v for k, v in flatten(names.to_flax(
        trainer.table, trainer.net.state_dict())).items() if k.startswith("params")}
    return float(loss), params


def _rank_train(device):
    """Each of ``MULTI_TRAIN``'s steps data-parallel on this rank; rank 0
    returns the losses and parameters."""
    import torch
    import torch.distributed as dist
    out = {}
    for tm in MULTI_TRAIN:
        out[tm] = _train_step64(device, tm, (dist.get_world_size(),))
        torch.cuda.empty_cache()
    return out if dist.get_rank() == 0 else None


def _hold_to_replicated(tag, path, ranks, states, test, dev, card):
    """Hold the mesh run ``tag`` (every rank's rows of each scoring call,
    in rank order for a data-parallel batch) to phase 3's fitted state of
    ``path`` served here, replicated: each bank row chosen differently
    inside the quantised product's envelope, the same predictions on the
    mesh's rows within SAME_ROWS_TOL."""
    import torch
    from cmdiad_tpu_torch.config import Config
    from cmdiad_tpu_torch.methods.registry import build_backbone, build_method

    cfg = Config(batch_size=8, seed=SEED, **PATHS[path][0])
    method = build_method(cfg, backbone=build_backbone(cfg, dev))
    method.load_state(states[path])
    whole_log = []
    with _bank_choices(whole_log):
        whole = _predict(method, test)
    calls = zip(*(r[tag]["rows"] for r in ranks)) if tag.startswith("dp") else (
        (call,) for call in ranks[0][tag]["rows"])
    mesh_log = [(torch.cat([q for q, _ in parts]), bank, torch.cat([i for _, i in parts]))
                for parts, (_, bank, _) in zip(calls, whole_log)]
    assert len(mesh_log) == len(whole_log) and all(
        m[2].shape == w[2].shape for m, w in zip(mesh_log, whole_log)), tag
    print(f"  {tag} ({path}) against phase 3's state served replicated:")
    n_flip = _check_flips(cfg.dist_method_s, mesh_log, whole_log, f"{tag} vs replicated")
    forced_log = []
    with _bank_choices(forced_log, forced=mesh_log):
        same = _predict(method, test)
    got = ranks[0][tag]["preds"]
    scale = float(np.max(np.abs(whole[1])))
    s_raw = float(np.max(np.abs(got[0] - whole[0]) / np.abs(whole[0])))
    m_raw = float(np.max(np.abs(got[1] - whole[1]))) / scale
    s_same = float(np.max(np.abs(got[0] - same[0]) / np.abs(same[0])))
    m_same = float(np.max(np.abs(got[1] - same[1]))) / scale
    s_tol, m_tol = SAME_ROWS_TOL[cfg.compute_dtype]
    print(f"  {tag}: {n_flip} patches on other rows; image scores within {s_raw:.3e}, maps "
          f"within {m_raw:.3e} of the map maximum; on the mesh's rows {s_same:.3e} and "
          f"{m_same:.3e} (limits {s_tol}, {m_tol}); {card}")
    assert s_same < s_tol and m_same < m_tol, (tag, s_same, m_same)


def phase_multi(dev, samples, card: str, states, preds, metrics, eval_ms):
    """(a) NCCL at world 1 on the card: the dry run, and ``DINO+Point_MAE``
    fitted with ``mesh_shape=(1,)`` and with ``shard_bank=True``,
    predictions identical to phase 3's.  (b) gloo at world 2, both ranks
    on the card: phase 3's fitted states served data-parallel (default and
    throughput) and with sharded banks, a data-parallel fit, one float64
    training step of FtoFMlp and HRNet at 2 x 32 against one at 64, and the
    dry run."""
    import torch
    from cmdiad_tpu_torch.parallel.dryrun import dryrun_multichip
    from cmdiad_tpu_torch.parallel.launch import spawn

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    cuda = str(dev if dev.index is not None else torch.device("cuda", 0))

    # (a) NCCL, world 1
    dryrun_multichip(1, "nccl", [cuda])
    (one,) = spawn(_rank_detect, 1, "nccl", [cuda], args=(1, samples, states))
    for tag, res in one.items():
        assert np.array_equal(res["preds"][0], preds["default"][0]), tag
        assert np.array_equal(res["preds"][1], preds["default"][1]), tag
        assert res["metrics"] == metrics["default"], (tag, res["metrics"])
        for k in PATHS["default"][1]:
            assert res["launches"][k] > 0, (tag, k, res["launches"])
        print(f"phase 8 (a) NCCL world 1, {tag}: predictions identical to phase 3's; "
              f"launches {res['launches']}, shapes {res['shapes']}; {res['ms']:.2f} ms a "
              f"test image (phase 3: {eval_ms['default']:.2f}); {card}")

    # (b) gloo, world 2 on one card
    ranks = spawn(_rank_detect, 2, "gloo", [cuda, cuda], args=(2, samples, states))
    for r, res in enumerate(ranks):
        for tag, run in res.items():
            for k, v in run["metrics"].items():
                assert np.isfinite(v) and 0.0 <= v <= 1.0, (r, tag, k, v)
            other = ranks[0][tag]
            assert run["metrics"] == other["metrics"], (r, tag)
            assert np.array_equal(run["preds"][1], other["preds"][1]), (r, tag)
            for k, want in MULTI_SHAPES.get(tag, {}).items():
                assert run["launches"][k] > 0, (r, tag, k, run["launches"])
                assert want is None or run["shapes"][k] == want, (r, tag, k, run["shapes"])
    res = ranks[0]
    print(f"phase 8 (b) gloo world 2, both ranks on {cuda}: launches and their shapes "
          f"(bank rows for the bank-min kernels, batch otherwise), rank 0:")
    for tag, run in res.items():
        print(f"  {tag}: launches {run['launches']}, shapes "
              f"{ {k: sorted(v) for k, v in run['shapes'].items()} }, bank rows a rank "
              f"{run['bank_rows']}; {run['ms']:.2f} ms a test image")
    for tag, (path, _, serve) in MULTI_RUNS[2].items():
        if serve:
            _hold_to_replicated(tag, path, ranks, states, samples[1], dev, card)
    for k in metrics["default"]:
        delta = abs(res["dp_fit"]["metrics"][k] - metrics["default"][k])
        print(f"  DP fit vs phase 3 {k}: |delta| {delta:.4f} (limit {DP_METRIC_TOL})")
        assert delta <= DP_METRIC_TOL, (k, delta)
    print(f"phase 8 (b): ms a test image, default world 1 (phase 3) "
          f"{eval_ms['default']:.2f}, world 2 DP {res['dp']['ms']:.2f} (two ranks on one "
          f"card: the collectives' and the extra process's cost, not scaling); {card}")

    train = spawn(_rank_train, 2, "gloo", [cuda, cuda])[0]
    torch.cuda.empty_cache()
    for tm, (_, limit) in MULTI_TRAIN.items():
        loss, want = _train_step64(dev, tm, ())
        got_loss, got = train[tm]
        err = _leaf_err(got, want)
        print(f"phase 8 (b) train {tm}: one float64 step at 2 x 32 vs one at 64: loss "
              f"{got_loss:.10g} vs {loss:.10g}, parameters within {err:.2e} of a leaf's "
              f"largest (limit {limit:g}); {card}")
        assert abs(got_loss - loss) <= 1e-6 * abs(loss) and err <= limit, (tm, err)
        torch.cuda.empty_cache()
    dryrun_multichip(2, "gloo", [cuda, cuda])
    print(f"phase 8: {time.perf_counter() - t_phase:.1f} s; {card}")


# --------------------------------------------------------------------------
# phase 9: the tail — preprocessing, the quantized blur, the 'jax' fitter,
# heatmaps
# --------------------------------------------------------------------------

# MVTec 3D-AD-density scans: 800 x 800 pixels at 0.125 mm a pixel (its
# objects are some 10 cm across 800 pixels), a tilted background plane, a
# domed object on a step and a separate tuft; the reference's eps = 6 mm
# then holds about 7000 points
TAIL_SIZE, TAIL_PITCH, TAIL_SAMPLES = 800, 1.25e-4, 3
# the H100 SXM sheet's float64 rate (34 TFLOP/s counting an FMA as two);
# dbscan.cu is built without FMA, so each of a pair test's 8 float64
# operations is one instruction at half that rate
PEAK_FP64_NO_FMA = 34e12 / 2
# the fusers' epochs on the card in this phase: the JAX fitter runs every
# one of max_iter epochs over the seg fuser's 802816 calibration rows;
# --full_ocsvm times all 1000
TAIL_OCSVM_EPOCHS = 10


def _scan_sample(rng, i: int):
    """(pc (800, 800, 3) float32, rgb uint8, gt uint8) of scan ``i``."""
    size, pitch = TAIL_SIZE, TAIL_PITCH
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float64) / size     # in image widths
    z = 0.55 + (0.06 * (xx - 0.5) - 0.04 * (yy - 0.5)) * size * pitch
    r = 0.275 + 0.025 * i
    r2 = (xx - 0.5 - 0.0375 * i) ** 2 + (yy - 0.5) ** 2
    obj = r2 < r ** 2
    z = z - np.where(obj, 0.008 + 0.012 * np.sqrt(np.clip(1 - r2 / r ** 2, 0, 1)), 0.0)
    tuft = (yy - 0.1625) ** 2 + (xx - 0.825) ** 2 < 0.0175 ** 2
    z = z - np.where(tuft, 0.02, 0.0)
    xx, yy = xx * size, yy * size
    pc = np.stack([(xx - size / 2) * pitch, (yy - size / 2) * pitch, z], -1)
    pc = (pc + rng.normal(0, 4e-5, pc.shape)).astype(np.float32)
    pc[rng.random((size, size)) < 0.01] = 0.0
    shade = ((z - z.min()) / np.ptp(z) * 200).astype(np.uint8)
    rgb = np.stack([shade, 255 - shade, shade // 2], -1)
    gt = np.zeros((size, size), np.uint8)
    if i == 1:
        gt[size // 2 - 20:size // 2 + 20, size // 2:size // 2 + 40] = 255
    return pc, rgb, gt, obj, tuft


def _tail_tmp() -> str:
    """A temporary directory whose path holds neither 'xyz' nor 'tiff'
    (the preprocessing finds a sample's rgb and gt files by replacing them)."""
    while True:
        path = tempfile.mkdtemp(prefix="tail_")
        if "xyz" not in path and "tiff" not in path:
            return path
        os.rmdir(path)


def check_dbscan(dev, pc: np.ndarray):
    """The kernel against its plain version, both on the card, on the
    points the preprocessing clusters: the scan's plane removed, padded,
    its valid points.  -> the kernels line's row."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from cmdiad_tpu_torch.preprocess import cluster, mvtec, plane
    t = torch.from_numpy(pc).to(dev)
    removed, _ = plane.remove_plane(t, torch.zeros_like(t, dtype=torch.uint8))
    flat = mvtec.pad_to_square(removed).reshape(-1, 3)
    pts = flat[(flat != 0).all(dim=1)].contiguous()
    eps, min_points = 0.006, 30
    root, count = cluster._roots_cuda(pts, eps, min_points)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_root, p_count = cluster._roots_plain(pts, eps, min_points, chunk_elems=1 << 26)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    assert torch.equal(count, p_count), "dbscan: neighbour counts differ"
    assert torch.equal(root, p_root), "dbscan: roots differ"
    labels = cluster._rank(root)
    n = pts.shape[0]
    pairs = (int(count.sum()) - n) // 2
    ms = _time_ms(lambda: cluster._roots_cuda(pts, eps, min_points), 3)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        cluster._roots_cuda(pts, eps, min_points)
        torch.cuda.synchronize()
    split = {e.key: getattr(e, "device_time_total", 0) / 1e3 for e in prof.key_averages()
             if any(k in e.key for k in ("count_neighbours", "unite_cores",
                                         "flatten_cores", "label_points"))}
    # each unordered eps-pair needs one float64 test (3 sub, 3 mul, 2 add);
    # read the points once, write a root a point
    bound_ms, bound_by = _bound(8.0 * pairs, PEAK_FP64_NO_FMA, n * 12 + n * 8)
    err = float(torch.max(torch.abs(root - p_root))) if n else 0.0
    print(f"dbscan on the card on the full scene ({TAIL_SIZE}² scan at {TAIL_PITCH * 1e3} mm a "
          f"pixel, eps {eps}, min_points {min_points}): {n} valid points, {pairs} eps-pairs, "
          f"{int((count >= min_points).sum())} core, {int(labels.max()) + 1} clusters, "
          f"{int((labels < 0).sum())} noise; roots and counts equal to the plain version's "
          f"(also on the card); wrapper {ms:.3f} ms (grid sort included), plain {plain_ms:.1f} "
          f"ms, bound {bound_ms:.4f} ms ({bound_by}); kernels (profiler, ms): "
          + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def _eyecandies_tree(rng, root: str, size: int = 512, n_train: int = 2, n_test: int = 2):
    """A raw Eyecandies tree written with the port's writers: 16-bit depth,
    its normalisation yaml, a camera pose, the rgb and the mask (test 1 has
    a defect), padded to the reference's 17 files a sample."""
    from cmdiad_tpu_torch.data import png
    yy, xx = np.mgrid[0:size, 0:size] / size
    c, s_ = np.cos(0.1), np.sin(0.1)
    pose = np.array([[1, 0, 0, 0.01], [0, c, -s_, 0.02], [0, s_, c, 0.3], [0, 0, 0, 1.0]])
    for split, n in (("train", n_train), ("test_public", n_test)):
        d = os.path.join(root, "Candy", split, "data")
        os.makedirs(d)
        for i in range(n):
            stem = str(i).zfill(3 if split == "train" else 2)
            bowl = 0.3 + 0.4 * ((xx - 0.5) ** 2 + (yy - 0.5) ** 2) + rng.uniform(0, 0.01, xx.shape)
            png.imwrite_grey16(os.path.join(d, f"{stem}_depth.png"),
                               (np.clip(bowl, 0, 1) * 65535).astype(np.uint16))
            with open(os.path.join(d, f"{stem}_info_depth.yaml"), "w") as fh:
                fh.write("normalization:\n  max: 1.5\n  min: 0.5\n")
            np.savetxt(os.path.join(d, f"{stem}_pose.txt"), pose)
            png.imwrite(os.path.join(d, f"{stem}_image_4.png"),
                        rng.integers(0, 256, (size, size, 3)).astype(np.uint8))
            mask = np.zeros((size, size, 3), np.uint8)
            if split == "test_public" and i == 1:
                mask[size // 5:size // 3, size // 5:size // 3] = 255
            png.imwrite(os.path.join(d, f"{stem}_mask.png"), mask)
            for j in range(12):
                with open(os.path.join(d, f"{stem}_pad{j}.txt"), "w") as fh:
                    fh.write("x")


def check_ocsvm_sgd(dev, x: np.ndarray, nu: float):
    """The OCSVM kernel against its plain version on the first epoch of the
    'jax' fit of the rows ``x`` (the seg fuser's): the same rows in the same
    order from the same state, the states bit-equal.  -> the kernels line's
    row."""
    import torch
    from cmdiad_tpu_torch import prng
    from cmdiad_tpu_torch.fusion import ocsvm
    n, d = x.shape
    consts = ocsvm._jax_constants(x, nu)
    order = prng.permutations(prng.split(prng.prng_key(42, dev), 1), n).reshape(-1)
    rows = torch.as_tensor(x, dtype=torch.float32).to(dev)[order].contiguous()
    start = torch.zeros(ocsvm.STATE, dtype=torch.float32, device=dev)
    start[ocsvm.MAX_D + 1] = 1.0
    card = start.clone()
    ocsvm.sgd_steps(rows, card, *consts)
    plain, host_rows = start.cpu(), rows.cpu()
    t0 = time.perf_counter()
    ocsvm.sgd_steps(host_rows, plain, *consts)
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = float((card.cpu() - plain).abs().max())
    assert torch.equal(card.cpu(), plain), (card.cpu(), plain)
    ms = _time_ms(lambda: ocsvm.sgd_steps(rows, start.clone(), *consts), 3)
    # a step: eta (add, mul, div), the dot (2d - 1), the margin and its test
    # (2), per column 5 (alpha w, active x, their difference, eta times it,
    # the update), rho (3), t (1); no FMA, so each at half the fp32 peak.
    # Each row read once, the state read and written.
    bound_ms, bound_by = _bound(n * (8 + 7 * d), PEAK_FP32_NO_FMA,
                                n * d * 4 + 2 * ocsvm.STATE * 4)
    print(f"ocsvm_sgd on the card, one epoch of the seg fuser's rows ({n} steps, d {d}): "
          f"state bit-equal to the plain version's (float32 step by step, also run on "
          f"the host); kernel {ms:.2f} ms ({ms / n * 1e6:.2f} ns a step), plain "
          f"{plain_ms:.0f} ms, bound {bound_ms:.4f} ms ({bound_by}; the steps depend on "
          f"each other, so the card's rates do not bound them)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None)


def _ulps(a, b) -> int:
    ia = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int(np.abs(ia - ib).max(initial=0))


def phase_tail(dev, samples, card: str, seg_dir: str, full_ocsvm: bool = False):
    """(a) ``cli preprocess`` over MVTec-density scans on the card, its
    phases timed, the DBSCAN kernel and the card's RANSAC held to their
    CPU / plain counterparts; (b) ``cli preprocess-eyecandies`` on the card
    against the CPU; (c) the default path with ``quantized_blur=True``, its
    maps bit-equal to the CPU's blur of the same score maps; (d) the fusers
    fitted with ``ocsvm_backend='jax'`` on the card, the OCSVM kernel held
    to its plain version; (e) ``cli heatmap`` over phase 4's saved maps.
    -> (the dbscan and ocsvm_sgd rows, their launches in (a) and in the
    path of (c) and (d))."""
    import torch
    from unittest import mock
    from cmdiad_tpu_torch import cli, kernels
    from cmdiad_tpu_torch.config import Config
    from cmdiad_tpu_torch.data import png, tiffio
    from cmdiad_tpu_torch.fusion import ocsvm
    from cmdiad_tpu_torch.ops import blur, scoring
    from cmdiad_tpu_torch.preprocess import eyecandies, plane
    from cmdiad_tpu_torch.runner import CMDIADRunner

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    tmp = _tail_tmp()
    try:
        # (a) MVTec 3D-AD preprocessing
        root = os.path.join(tmp, "mvtec")
        scans = []
        for i in range(TAIL_SAMPLES):
            pc, rgb, gt, obj, tuft = _scan_sample(rng, i)
            scans.append((pc, obj, tuft))
            for sub, arr in (("xyz", pc), ("rgb", rgb), ("gt", gt)):
                d = os.path.join(root, "scan", "test", "good", sub)
                os.makedirs(d, exist_ok=True)
                path = os.path.join(d, f"{i:03d}." + ("tiff" if sub == "xyz" else "png"))
                tiffio.imwrite(path, arr) if sub == "xyz" else png.imwrite(path, arr)
        border = torch.from_numpy(scans[0][0])
        got, best = plane.ransac(plane.border_points(border.to(dev)))
        want, want_best = plane.ransac(plane.border_points(border))
        sign = 1.0 if float(got[:3].cpu() @ want[:3]) > 0 else -1.0
        plane_err = float(torch.max(torch.abs(sign * got.cpu() - want)))
        print(f"phase 9 (a) RANSAC on the card vs the CPU, the same draw: best iteration "
              f"{best} and {want_best}, planes within {plane_err:.2e} (limit 1e-9, float64 "
              f"both); {len(plane.border_points(border))} border points")
        assert best == want_best and plane_err < 1e-9, (best, want_best, plane_err)
        dbscan_row = check_dbscan(dev, scans[0][0])
        kernels.reset_launches()
        torch.cuda.synchronize()
        n, seconds = cli.main(["preprocess", "-d", root, "-n", "6", "--device", "cuda"])
        torch.cuda.synchronize()
        launches = kernels.LAUNCHES["dbscan"]
        assert n == TAIL_SAMPLES and launches == TAIL_SAMPLES, (n, launches)
        for i, (pc, obj, tuft) in enumerate(scans):
            out = tiffio.imread(os.path.join(root, "scan", "test", "good", "xyz", f"{i:03d}.tiff"))
            valid = np.all(out != 0, axis=-1)
            assert out.shape == pc.shape, out.shape
            assert valid[obj].mean() > 0.9 and not valid[tuft].any(), i
            assert valid[~obj].mean() < 0.01, i
        print(f"phase 9 (a) cli preprocess --device cuda: {n} scans, launches {launches} "
              f"dbscan; ms a sample (thread sums / {n}): ransac "
              f"{seconds['ransac_s'] / n * 1e3:.1f}, dbscan {seconds['dbscan_s'] / n * 1e3:.1f}, "
              f"io {seconds['io_s'] / n * 1e3:.1f}; wall {seconds['wall_s'] / n * 1e3:.1f} ms "
              f"a sample over 6 threads; objects kept, tufts and planes gone; {card}")

        # (b) Eyecandies
        eye = os.path.join(tmp, "eye")
        _eyecandies_tree(rng, eye)
        t0 = time.perf_counter()
        cli.main(["preprocess-eyecandies", "--dataset_path", eye, "--target_dir",
                  os.path.join(tmp, "eye_card"), "--device", "cuda"])
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) / 4 * 1e3
        t0 = time.perf_counter()
        eyecandies.convert_dataset(eye, os.path.join(tmp, "eye_cpu"), device="cpu")
        cpu_ms = (time.perf_counter() - t0) / 4 * 1e3
        worst, files = 0, 0
        for dirpath, _, names in os.walk(os.path.join(tmp, "eye_cpu")):
            for name in names:
                a = os.path.join(dirpath, name)
                b = a.replace("eye_cpu", "eye_card")
                if name.endswith(".tiff"):
                    worst = max(worst, _ulps(tiffio.imread(b), tiffio.imread(a)))
                else:
                    assert np.array_equal(png.imread(a), png.imread(b)), name
                files += 1
        assert files == 10 and worst <= 2, (files, worst)   # 4 xyz, 4 rgb, 2 gt
        print(f"phase 9 (b) cli preprocess-eyecandies --device cuda (512², 4 samples): "
              f"{card_ms:.1f} ms a sample on the card, {cpu_ms:.1f} on the CPU; clouds within "
              f"{worst} float32 ulps of the CPU's (limit 2), rgb and gt equal; {card}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (c) + (d): the default path with the quantized blur and the 'jax' fitter
    blurs, fits = [], []
    q_blur, fit = scoring.quantized_knn_gaussian_blur, ocsvm.SGDOneClassSVM.fit

    def record_blur(s_map, radius=4.0):
        out = q_blur(s_map, radius)
        blurs.append((s_map.detach().cpu(), out.detach().cpu()))
        return out

    def record_fit(self, x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit(self, x)
        torch.cuda.synchronize()
        fits.append((np.array(x), self, time.perf_counter() - t0))
        return self

    cfg = Config(batch_size=8, seed=SEED, quantized_blur=True, ocsvm_backend="jax",
                 ocsvm_maxiter=TAIL_OCSVM_EPOCHS)
    train, test = samples
    with mock.patch.object(scoring, "quantized_knn_gaussian_blur", record_blur), \
            mock.patch.object(ocsvm.SGDOneClassSVM, "fit", record_fit):
        runner = CMDIADRunner(cfg, device=dev)
        kernels.reset_launches()
        runner.fit("synthetic", train)
        metrics = runner.evaluate("synthetic", test)
        torch.cuda.synchronize()
    path_launches = dict(kernels.LAUNCHES)
    for k in PATHS["default"][1]:
        assert path_launches[k] > 0, (k, path_launches)
    for k, v in metrics.items():
        assert np.isfinite(v) and 0.0 <= v <= 1.0, (k, v)
    assert blurs and all(torch.equal(blur.quantized_knn_gaussian_blur(s), out)
                         for s, out in blurs), "quantized blur: card and CPU differ"
    print(f"phase 9 (c) default path with quantized_blur=True: {len(blurs)} blurred batches "
          f"({sum(s.shape[0] for s, _ in blurs)} maps), every map bit-equal to the CPU's blur of "
          f"the same score map; launches {path_launches}; metrics {metrics}")
    assert len(fits) == 2 and path_launches["ocsvm_sgd"] > 0, path_launches
    (x_det, det, det_s), (x_seg, seg, seg_s) = fits
    assert det.backend == seg.backend == "jax"
    # the detect fuser's few rows: its whole fit again with the plain version
    w, rho = ocsvm._fit_jax(x_det, cfg.ocsvm_nu, TAIL_OCSVM_EPOCHS, 42, "cpu")
    assert np.array_equal(det.coef_.ravel(), w) and det.offset_[0] == rho, "detect fuser"
    print(f"phase 9 (d) detect fuser, 'jax' fitter, {x_det.shape[0]} x {x_det.shape[1]} rows, "
          f"{TAIL_OCSVM_EPOCHS} epochs: card {det_s:.2f} s, bit-equal to the plain version")
    row = check_ocsvm_sgd(dev, x_seg, cfg.ocsvm_nu)
    t0 = time.perf_counter()
    ocsvm.sklearn_shuffle.cache_clear()
    ocsvm.sklearn_shuffle(len(x_seg), ocsvm.sklearn_seed(42))
    shuffle_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    numpy_fit = ocsvm.SGDOneClassSVM(nu=cfg.ocsvm_nu, max_iter=1000, random_state=42,
                                     backend="sklearn")
    fit(numpy_fit, x_seg)
    numpy_s = time.perf_counter() - t0
    print(f"phase 9 (d) seg fuser, 'jax' fitter, {x_seg.shape[0]} x {x_seg.shape[1]} rows, "
          f"{TAIL_OCSVM_EPOCHS} epochs on the card: {seg_s:.2f} s ({path_launches['ocsvm_sgd']} "
          f"ocsvm_sgd launches in the path's fit); the numpy 'sklearn' fitter {numpy_s:.2f} s "
          f"({numpy_fit.n_iter_} epochs, its stopping rule; {shuffle_s:.2f} s of it sklearn's "
          f"Fisher-Yates order); {card}")
    if full_ocsvm:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ocsvm._fit_jax(x_seg, cfg.ocsvm_nu, 1000, 42, dev)
        torch.cuda.synchronize()
        print(f"phase 9 (d) seg fuser, 'jax' fitter, all 1000 epochs on the card: "
              f"{time.perf_counter() - t0:.1f} s; {card}")

    # (e) heatmaps of phase 4's saved maps
    with tempfile.TemporaryDirectory() as out:
        n_maps = sum(len([f for f in fs if f.endswith(".npz")]) for _, _, fs in os.walk(seg_dir))
        t0 = time.perf_counter()
        assert cli.main(["heatmap", "--seg_dir", seg_dir, "--out_dir", out]) == n_maps > 0
        pngs = sorted(os.listdir(out))
        img = png.imread(os.path.join(out, pngs[0]))
        assert len(pngs) == n_maps and img.shape == (224, 2 * 224 + 8, 3), (len(pngs), img.shape)
        print(f"phase 9 (e) cli heatmap: {n_maps} maps of phase 4 in "
              f"{time.perf_counter() - t0:.1f} s; {pngs[0]} decodes to {img.shape}")
    print(f"phase 9: {time.perf_counter() - t_phase:.1f} s; {card}")
    return ({"dbscan": dbscan_row, "ocsvm_sgd": row},
            {"dbscan": launches, "ocsvm_sgd": path_launches["ocsvm_sgd"]})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one evaluation pass of each path and "
                         "MTFI preset and one training step of each train "
                         "method (torch.profiler) and write the tables to DIR")
    ap.add_argument("--full_ocsvm", action="store_true",
                    help="also time the seg fuser's 'jax' fit over all 1000 epochs "
                         "in phase 9")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    from cmdiad_tpu_torch import kernels
    from cmdiad_tpu_torch.device import resolve_device

    dev = resolve_device("cuda")
    card = _card()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    diag = kernels.build_all(ptxas_verbose=True)
    print(f"built {len(diag)} kernels in {time.perf_counter() - t0:.1f} s")
    for name, out in diag.items():
        lines = [ln for ln in out.splitlines() if "Used" in ln or "spill" in ln]
        print(f"  {name}: " + " | ".join(ln.strip() for ln in lines))

    res, probe_launches = phase_kernels(dev)
    from cmdiad_tpu_torch.data.synthetic import make_synthetic_samples
    samples = make_synthetic_samples(
        n_train=16, n_test_good=4, n_test_bad=4, size=224, seed=SEED,
        anomaly_radius=(0.13, 0.18), point_capacity=32768)
    work = tempfile.TemporaryDirectory()
    states = {name: os.path.join(work.name, f"{name}.npz") for name in PATHS}
    launches, metrics, eval_ms, preds = {}, {}, {}, {}
    for name in PATHS:
        launches[name], metrics[name], eval_ms[name], preds[name] = phase_path(
            dev, name, samples, states[name], args.profile)
    for k, limit in THROUGHPUT_ENVELOPE.items():
        delta = abs(metrics["throughput"][k] - metrics["default"][k])
        print(f"throughput vs default {k}: |delta| {delta:.4f} (limit {limit})")
        assert delta <= limit, (k, delta, limit)
    seg_dir = phase_detect(card, eval_ms["default"], work.name)
    phase_mtfi(dev, samples, card, args.profile)
    phase_backbones(dev, card)
    phase_train(dev, samples, card, args.profile)
    phase_multi(dev, samples, card, states, preds, metrics, eval_ms)
    tail_rows, tail_launches = phase_tail(dev, samples, card, seg_dir, args.full_ocsvm)
    res.update(tail_rows)
    work.cleanup()

    rows = []
    for name, key, src, replaces in KERNEL_ROWS:
        n = probe_launches if key == "int8_dot" else tail_launches[key] if key in tail_launches \
            else next(launches[p][key] for p in PATHS if key in PATHS[p][1])
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces, "launches": n, **res[key]})
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
