"""Drive the PyTorch port's detection paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py              # every phase (needs one CUDA card)
    python3 chip_smoke.py --profile DIR  # also profile one evaluation pass
                                         # of each path into DIR

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
     path's.

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


def check_fps(rng, dev, batch=8, capacity=32768, groups=1024):
    import torch
    from cmdiad_tpu_torch.ops import fps
    from cmdiad_tpu_torch.ops.masked import host_compact_points, nonzero_point_mask
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


def check_interp(rng, dev, batch=8, size=224, groups=1024, d=768):
    """Both output types at the paths' size, each bit-identical to the
    plain version and over two launches; returns the float32 row of the
    kernels line (the default path's) and prints the bfloat16 one (the
    throughput path's) with its own bound."""
    import torch
    from cmdiad_tpu_torch.ops import interpolate as ip
    from cmdiad_tpu_torch.ops.masked import nonzero_point_mask
    pts = torch.from_numpy(_disc_cloud(rng, batch, size).reshape(
        batch, size * size, 3)).to(dev)
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
    res["interp"] = check_interp(rng, dev)
    # ViT-B/8 (785 tokens, 12 heads) and Point-MAE (1024 tokens, 6 heads)
    res["flash_attn"] = check_flash(rng, dev, "bfloat16", 785, 12)
    check_flash(rng, dev, "bfloat16", 1024, 6)
    check_flash(rng, dev, "float32", 785, 12)
    check_flash(rng, dev, "float32", 1024, 6)
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


def phase_path(dev, name: str, samples, profile=None):
    """fit + evaluate one path with the launch counts set to 0 before and
    read after, profiling one more evaluation pass into the directory
    ``profile`` if given; returns (launches, metrics)."""
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
    return launches, metrics, eval_ms


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


def _check_flips(metric, gpu_log, cpu_log) -> int:
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
    print(f"card vs CPU bank rows: {n_flip} of {n_all} patches differ, "
          f"every one inside the {metric} envelope")
    return n_flip


# The maps the CPU computes on the card's bank rows, against the card's, as
# a share of the map maximum (limits fixed before the first run):
# float32 backbones differ in summation order only; bfloat16 backbones
# round their GEMM sums apart on the two devices, so features differ by
# bfloat16 ulps and each patch distance by at most |q_gpu - q_cpu|.
SAME_ROWS_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (5e-2, 1e-1)}


def compare_with_cpu(cfg, method, samples):
    """Serve the card's fitted state on the CPU through the plain versions
    and hold the card's predictions for ``samples`` against it.

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
    gpu_log, cpu_log, forced_log = [], [], []
    with _bank_choices(gpu_log):
        gpu_s, gpu_maps = _predict(method, samples)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "state.npz")
        method.save_state(path)
        cpu_method = build_method(cfg, backbone=method.backbone.to("cpu"),
                                  device="cpu")
        cpu_method.load_state(path)
    with _bank_choices(cpu_log):
        cpu_s, cpu_maps = _predict(cpu_method, samples)
    with _bank_choices(forced_log, forced=gpu_log):
        same_s, same_maps = _predict(cpu_method, samples)
    _check_flips(metric, gpu_log, cpu_log)

    # feature differences per bank (the log holds the xyz then the rgb call)
    dq, rel = [], []
    for (qg, _, _), (qc, _, _) in zip(gpu_log, cpu_log):
        diff = (qg.double() - qc.double())
        dq.append(float(diff.norm(dim=1).max()))
        rel.append(float(diff.norm() / qc.double().norm()))
    print(f"card vs CPU {cfg.compute_dtype} backbone features (normalised, "
          f"xyz then rgb): relative difference {', '.join(f'{r:.3e}' for r in rel)}; "
          f"largest patch |q_gpu - q_cpu| {', '.join(f'{x:.3e}' for x in dq)}")

    scale = float(np.max(np.abs(cpu_maps)))
    s_err = float(np.max(np.abs(gpu_s - cpu_s) / np.maximum(np.abs(cpu_s), 1e-6)))
    m_err = float(np.max(np.abs(gpu_maps - cpu_maps))) / scale
    s_same = float(np.max(np.abs(gpu_s - same_s) / np.maximum(np.abs(same_s), 1e-6)))
    m_same = float(np.max(np.abs(gpu_maps - same_maps))) / scale
    _, ws = cpu_method._fuser_weights()
    lam = (cfg.xyz_smap_lambda, cfg.rgb_smap_lambda)
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


def phase_detect(card: str, memory_eval_ms: float):
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

        cache, res = os.path.join(tmp, "cache"), os.path.join(tmp, "results")
        common = ["--dataset_path", root, "--results_dir", res]
        first, t_first, launches = _detect([*common, "--bank_cache_dir", cache])
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


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", metavar="DIR",
                    help="also profile one evaluation pass of each path "
                         "(torch.profiler) and write the tables to DIR")
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
    launches, metrics, eval_ms = {}, {}, {}
    for name in PATHS:
        launches[name], metrics[name], eval_ms[name] = phase_path(
            dev, name, samples, args.profile)
    for k, limit in THROUGHPUT_ENVELOPE.items():
        delta = abs(metrics["throughput"][k] - metrics["default"][k])
        print(f"throughput vs default {k}: |delta| {delta:.4f} (limit {limit})")
        assert delta <= limit, (k, delta, limit)
    phase_detect(card, eval_ms["default"])

    rows = []
    for name, key, src, replaces in KERNEL_ROWS:
        n = probe_launches if key == "int8_dot" else next(
            launches[p][key] for p in PATHS if key in PATHS[p][1])
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
