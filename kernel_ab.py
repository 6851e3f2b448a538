"""Time two checkouts of the port's int8 bank-min and 3-NN interpolation
kernels on one CUDA card, in turns.

    python3 kernel_ab.py                    # this checkout only
    python3 kernel_ab.py --parent DIR       # DIR holds another checkout's
                                            # cmdiad_tpu_torch/: parent,
                                            # this, this, parent

Each turn is a fresh process that imports ``cmdiad_tpu_torch`` from its
checkout (building the kernels into that checkout's ``_build/``), makes the
same inputs from one seed, checks each kernel against its plain version
(int8 bank-min: indices and raw values identical; interpolation: output
identical) and times it eagerly between CUDA events, as ``chip_smoke.py``
times the kernels line: the bank-min at the four shapes the smoke runs,
the interpolation at the paths' B 8 x 50176 points x 1024 centers x 768 in
float32 and bfloat16.  Prints the card, one line per turn and shape, and a
JSON object of all readings as its last line.  Exits non-zero without a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np

SEED = 0
BANK_SHAPES = ((25088, 65536), (6272, 16384), (25088, 8192), (6272, 8192))


def _time_ms(fn, iters: int = 5, readings: int = 3):
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(readings):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / iters)
    return out


def _interp_inputs(dev, batch=8, size=224, groups=1024, d=768,
                   surface=False):
    """Disc clouds of about 25k valid points of 50176 per image, centers
    drawn from the valid points, unit normal features.  The points are
    random (``chip_smoke.py``'s cloud: grid neighbours are not neighbours in
    space) or, with ``surface``, a smooth height field over the grid, as an
    organized scan is, so that neighbouring grid points share centers."""
    import torch
    rng = np.random.default_rng(SEED)
    yy, xx = np.mgrid[0:size, 0:size]
    if surface:
        u, v = xx / size - 0.5, yy / size - 0.5
        h = 0.05 * np.sin(6 * u) * np.cos(5 * v)
        pc = np.broadcast_to(np.stack([u, v, h], -1).astype(np.float32) + 1.0,
                             (batch, size, size, 3)).copy()
    else:
        pc = rng.normal(size=(batch, size, size, 3)).astype(np.float32) * 0.05
    pc[:, ((yy - size // 2) ** 2 + (xx - size // 2) ** 2) > 90 ** 2] = 0.0
    pts = pc.reshape(batch, size * size, 3)
    mask = np.all(pts != 0, -1)
    cidx = np.stack([rng.choice(np.flatnonzero(mask[i]), groups, replace=False)
                     for i in range(batch)])
    centers = np.take_along_axis(pts, cidx[..., None], 1)
    feats = rng.normal(size=(batch, groups, d)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (pts, mask, centers, feats)]


def worker(tree: str) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import cmdiad_tpu_torch
    from cmdiad_tpu_torch.ops import bank_min as bm
    from cmdiad_tpu_torch.ops import interpolate as ip
    here = os.path.dirname(os.path.abspath(cmdiad_tpu_torch.__file__))
    assert here.startswith(os.path.abspath(tree)), here
    dev = torch.device("cuda")
    res = {}
    for surface in (False, True):
        pts, mask, centers, feats = _interp_inputs(dev, surface=surface)
        for bf16 in (False, True):
            got = ip._three_nn_cuda(pts, mask, centers, feats, bf16)
            want = torch.cat([ip._three_nn_plain(
                pts[i:i + 1], mask[i:i + 1], centers[i:i + 1], feats[i:i + 1],
                bf16) for i in range(pts.shape[0])])
            bits = torch.int16 if bf16 else torch.int32
            n_diff = int((got.view(bits) != want.view(bits)).sum())
            key = (f"interp {'bf16' if bf16 else 'f32'} B8 x 50176 x 1024 x 768"
                   f" {'surface' if surface else 'random'} points")
            res[key] = dict(ms=_time_ms(
                lambda: ip._three_nn_cuda(pts, mask, centers, feats, bf16)),
                values_differing=n_diff)
        del pts, mask, centers, feats
    rng = np.random.default_rng(SEED)
    for nq, nb in BANK_SHAPES:
        q = torch.from_numpy(rng.normal(size=(nq, 768)).astype(np.float32)).to(dev)
        bank = torch.from_numpy(rng.normal(size=(nb, 768)).astype(np.float32)).to(dev)
        q8, qs = bm.quantize_rows(q)
        b8, bs = bm.quantize_rows(bank)
        bnorm = torch.sum(bank * bank, dim=1).contiguous()
        kv, ki = bm._bank_min_int8_cuda(q8, qs, b8, bs, bnorm)
        pv, pi = bm._bank_min_int8_plain(q8, qs, b8, bs, bnorm)
        n_diff = int(((ki != pi) | (kv != pv)).sum())
        res[f"bank_min_int8 {nq} x {nb} x 768"] = dict(ms=_time_ms(
            lambda: bm._bank_min_int8_cuda(q8, qs, b8, bs, bnorm)),
            values_differing=n_diff)
        if (nq, nb) == BANK_SHAPES[0]:
            # the card's SM clock and power while each bank-min runs for a
            # while: int8 against bf16 at the same shape
            qb, bb = q.to(torch.bfloat16), bank.to(torch.bfloat16)
            res["clocks while running, int8 / bf16 bank-min"] = [
                _clocks_while(lambda: bm._bank_min_int8_cuda(q8, qs, b8, bs, bnorm)),
                _clocks_while(lambda: bm._bank_min_cuda(qb, bb, bnorm))]
    return res


def _clocks_while(fn, calls: int = 600) -> str:
    """nvidia-smi's SM clock and power draw, read once the card has run
    ``fn`` for a while, with ``calls`` more calls queued behind."""
    import torch
    for _ in range(calls):
        fn()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader"], capture_output=True, text=True)
    torch.cuda.synchronize()
    return out.stdout.strip()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", metavar="DIR",
                    help="another checkout to time in turns with this one")
    ap.add_argument("--worker", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        print(json.dumps(worker(args.worker)))
        return 0

    import torch
    if not torch.cuda.is_available():
        print("no CUDA device: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    here = os.path.dirname(os.path.abspath(__file__))
    turns = ([("parent", args.parent), ("this", here), ("this", here),
              ("parent", args.parent)] if args.parent else [("this", here)])
    readings = []
    for label, tree in turns:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--worker", tree], capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        res = json.loads(out.stdout.strip().splitlines()[-1])
        for key, r in res.items():
            if key.startswith("clocks"):
                print(f"{label:6s} {key}: {r}")
                continue
            print(f"{label:6s} {key}: " + " / ".join(f"{t:.4f}" for t in r["ms"])
                  + f" ms, {r['values_differing']} values differ from the "
                  f"plain version")
        readings.append({"turn": label, "readings": res})
    print(json.dumps({"card": card, "turns": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
