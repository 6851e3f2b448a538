"""Read the check's numbers over many seeds in one process, for the
program and for its control, to set ``perfbench/limits/<cell>.json``.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        --control_seeds 4 5 6 [--seconds 3] [--out FILE]

Each seed is a whole run of the cell (set-up, a short window that covers
a pass through the pool, the check) at the cell's own size; the control
runs the same with the port's ``compute_dtype='bfloat16'``, the precision
below the configuration's float32.  Prints one JSON line a run and writes
them all to ``--out``.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control_seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from perfbench.core import cell as cell_mod, spec
    cell_mod.use_cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    wanted = spec.load_cell(args.workload)
    cell_mod.log(f"card: {cell_mod.card_name_and_power()}")
    rows = []
    for kind, seeds, over in (("program", args.seeds, None),
                              ("control", args.control_seeds, {"compute_dtype": "bfloat16"})):
        for seed in seeds:
            t0 = time.time()
            numbers = {}
            r = cell_mod.run(wanted, seed, args.seconds, False, "cuda", t0=t0, overrides=over,
                             numbers_out=numbers)
            row = {"kind": kind, "seed": seed, "correct": r["correct"], **numbers,
                   **{k: v["value"] for k, v in r["metrics"].items()},
                   "run_s": time.time() - t0}
            rows.append(row)
            print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
