"""Time the port's data loader from disk, with and without the PNG decoder's
sweep lock (``cmdiad_tpu_torch.data.png._SWEEP_LOCK``).

    python3 loader_bench.py                 # 800² class, 400² class to preload
    python3 loader_bench.py --size 64 --next_size 64 --readings 1   # a quick check

Writes ``chip_smoke.py``'s phase-4 fixture (16 train samples, the validation
sample, 4 good, 4 dented and 2 blotched test samples a class) for a class at
``--size`` and one at ``--next_size`` into a temporary directory, then reads
the first class's train and test splits through ``iter_samples`` (decode,
resize, point compaction: what ``detect`` streams) at 1, 2, 3 and 6 threads,
each with the lock and with it replaced by a no-op, and once more at 6
threads while a thread preloads the second class as ``run_detection`` does
(``preload_class_samples``).  The settings run in turn, forwards then
backwards, ``--readings`` times over.  Prints the card, one line per
reading (ms a sample of the first class; with a preload also the preload's
ms a sample), and a JSON object of all readings as its last line.  Needs
no card: the loader runs on the host's cores.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import threading
import time

FIXTURE = dict(n_train=16, n_test_good=4, n_test_bad=4, n_test_color=2,
               seed=0, anomaly_radius=(0.13, 0.18))
WORKERS = (1, 2, 3, 6)


def _card() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "no NVIDIA card"


def _stream(root: str, cls: str, workers: int) -> int:
    from cmdiad_tpu_torch.data.loader import iter_samples
    from cmdiad_tpu_torch.data.mvtec3d import MVTec3DDataset
    n = 0
    for split in ("train", "test"):
        for _ in iter_samples(MVTec3DDataset(root, cls, split), num_workers=workers):
            n += 1
    return n


def _reading(root: str, workers: int, locked: bool, preload: bool) -> dict:
    from cmdiad_tpu_torch.config import Config
    from cmdiad_tpu_torch.data import png
    from cmdiad_tpu_torch.runner import preload_class_samples
    lock = png._SWEEP_LOCK
    png._SWEEP_LOCK = lock if locked else contextlib.nullcontext()
    try:
        out = {"workers": workers, "lock": locked, "preload": preload}
        pre = {}
        if preload:
            cfg = Config(dataset_path=root)

            def _run():
                t0 = time.perf_counter()
                n = sum(len(v) for v in preload_class_samples(cfg, "next").values())
                pre["ms"] = (time.perf_counter() - t0) / n * 1e3

            thread = threading.Thread(target=_run)
            thread.start()
        t0 = time.perf_counter()
        n = _stream(root, "first", workers)
        out["ms"] = (time.perf_counter() - t0) / n * 1e3
        if preload:
            thread.join()
            out["preload_ms"] = pre["ms"]
        return out
    finally:
        png._SWEEP_LOCK = lock


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--size", type=int, default=800)
    ap.add_argument("--next_size", type=int, default=400)
    ap.add_argument("--readings", type=int, default=2)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cmdiad_tpu_torch.data.synthetic import make_synthetic_dataset

    card = _card()
    print(f"card: {card}; host: {os.cpu_count()} CPU cores", flush=True)
    settings = [(w, lk, False) for w in WORKERS for lk in (True, False)]
    settings += [(6, True, True), (6, False, True)]
    readings = []
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "mvtec")
        make_synthetic_dataset(root, class_names=("first",), size=args.size, **FIXTURE)
        make_synthetic_dataset(root, class_names=("next",), size=args.next_size, **FIXTURE)
        _reading(root, 6, True, False)   # warm the page cache and numpy
        for r in range(args.readings):
            for w, lk, pre in (settings if r % 2 == 0 else settings[::-1]):
                got = _reading(root, w, lk, pre)
                readings.append(got)
                line = (f"{args.size}²: {w} threads, lock {'on' if lk else 'off'}: "
                        f"{got['ms']:.1f} ms a sample")
                if pre:
                    line += (f", while the {args.next_size}² class preloads at "
                             f"{got['preload_ms']:.1f} ms a sample")
                print(f"{line}; {card}", flush=True)
    print(json.dumps({"card": card, "size": args.size, "next_size": args.next_size,
                      "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
