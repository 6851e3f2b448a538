"""Run one cell of ``BENCHMARK.json`` on the card and print one JSON line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Exits non-zero and prints no result when no card is present, when the
program is missing, or when JAX or the JAX package was loaded.  The last
lines on standard error and the ``checks`` key, last in the result, give
each number the check compared with its limit.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "cmdiad_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    from perfbench.core import cell as cell_mod, spec
    cell_mod.use_cache_dirs()
    import torch

    wanted = spec.load_cell(args.workload)
    chips = next(w["chips"] for w in spec.manifest()["workloads"] if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} present",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    cell_mod.log(f"card: {cell_mod.card_name_and_power()}; torch {torch.__version__}, "
                 f"CUDA {torch.version.cuda}")
    result = cell_mod.run(wanted, args.seed, args.seconds, bool(args.trace), "cuda", t0=T0)
    found = forbidden_modules()
    if found:
        print(f"perfbench: the process loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        cell_mod.log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
