"""Command-line interface of the port.

  python -m cmdiad_tpu_torch.cli detect [--<Config field> value ...] [--device cuda|cpu]

``detect`` fits and evaluates every class of the dataset at
``--dataset_path`` (or the one ``--class_name``) with the configured
method, prints one markdown table a metric and, with ``--save_results``
(default true), appends them to ``<results_dir>/*.md``.  Every ``Config``
field is a flag.  ``--device`` defaults to ``cuda``; ``--trace_dir DIR``
writes a ``torch.profiler`` trace of the run to ``DIR/trace.json``.

The tables are the text of pandas' ``DataFrame.to_markdown(index=False)``
(tabulate's ``pipe`` format), written without pandas.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, List, Sequence

import numpy as np

from cmdiad_tpu_torch.config import Config


def _parse_int_tuple(s: str) -> tuple:
    """'4,2' -> (4, 2); '8' -> (8,); '' -> () (single device)."""
    s = s.strip().strip("()")
    return tuple(int(x) for x in s.split(",") if x.strip()) if s else ()


def _field_type(f):
    """Concrete scalar type of a dataclass field, incl. Optional[int/float]."""
    t = str(f.type)
    if "Tuple" in t or "tuple" in t:
        return tuple
    if "bool" in t:
        return bool
    if "int" in t:
        return int
    if "float" in t:
        return float
    if "str" in t:
        return str
    return None


def _add_config_args(parser: argparse.ArgumentParser) -> None:
    for f in dataclasses.fields(Config):
        name, default, typ = "--" + f.name, f.default, _field_type(f)
        if typ is bool:
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=default)
        elif typ is tuple:
            parser.add_argument(name, type=_parse_int_tuple, default=default,
                                help="comma-separated ints, e.g. '8'")
        elif typ is not None:
            parser.add_argument(name, type=typ, default=default)


def _config_from_args(args) -> Config:
    return Config(**{f.name: getattr(args, f.name) for f in dataclasses.fields(Config)})


def _afterpoint(cell: str) -> int:
    """Digits after the decimal point (or exponent mark) of a formatted
    number; -1 for an integer (tabulate's ``_afterpoint``)."""
    if cell.lstrip("+-").isdigit():
        return -1
    pos = cell.rfind(".")
    if pos < 0:
        pos = cell.lower().rfind("e")
    return len(cell) - pos - 1 if pos >= 0 else -1


def markdown_table(headers: Sequence[str], rows: Sequence[Sequence]) -> str:
    """``pandas.DataFrame(rows, columns=headers).to_markdown(index=False)``
    for columns of strings or of floats: a float column is formatted with
    ``'g'``, its decimal points aligned and the column right-aligned; a
    string column is left-aligned; every column is at least its header's
    width plus 2."""
    columns = []
    for j, head in enumerate(headers):
        vals = [r[j] for r in rows]
        numeric = all(isinstance(v, (int, float, np.integer, np.floating))
                      and not isinstance(v, bool) for v in vals)
        cells = [format(v, "g") if numeric else str(v) for v in vals]
        if numeric:
            after = [_afterpoint(c) for c in cells]
            cells = [c + " " * (max(after) - a) for c, a in zip(cells, after)]
        width = max([len(head) + 2] + [len(c) for c in cells])
        just = str.rjust if numeric else str.ljust
        columns.append(([just(head, width)] + [just(c, width) for c in cells],
                        "-" * (width + 1) + ":" if numeric else ":" + "-" * (width + 1)))
    lines = ["| " + " | ".join(col[0][0] for col in columns) + " |",
             "|" + "|".join(col[1] for col in columns) + "|"]
    for i in range(len(rows)):
        lines.append("| " + " | ".join(col[0][i + 1] for col in columns) + " |")
    return "\n".join(lines)


_TABLE_FILES = {"image_rocauc": "image_rocauc_results.md",
                "pixel_rocauc": "pixel_rocauc_results.md",
                "au_pro": "aupro_results.md",
                "au_pro_001": "aupro_001_results.md"}


def result_rows(cfg: Config, results: Dict[str, Dict[str, float]]) -> Dict[str, tuple]:
    """metric -> (headers, one row): the method, each class's value rounded
    to 3 places, and their mean rounded to 3 places (the numpy mean and
    rounding that pandas applies)."""
    tables = {}
    for k in _TABLE_FILES:
        vals = {cls.title(): round(m[k], 3) for cls, m in results.items()}
        mean = round(np.float64(np.mean(np.asarray(list(vals.values()), np.float64))), 3)
        tables[k] = (["Method", *vals, "Mean"], [cfg.method_name, *vals.values(), mean])
    return tables


def write_result_tables(cfg: Config, results: Dict[str, Dict[str, float]]) -> Dict[str, str]:
    """Print one markdown table a metric and, with ``cfg.save_results``,
    append each to its file under ``cfg.results_dir``; returns the texts."""
    texts = {}
    for k, (headers, row) in result_rows(cfg, results).items():
        texts[k] = markdown_table(headers, [row])
        print(f"\n===== {k} =====")
        print(texts[k])
    if cfg.save_results:
        os.makedirs(cfg.results_dir, exist_ok=True)
        for k, text in texts.items():
            with open(os.path.join(cfg.results_dir, _TABLE_FILES[k]), "a") as fh:
                fh.write("\n\n" + cfg.experiment_note + "\n")
                fh.write(text)
    return texts


def _classes(cfg: Config) -> List[str]:
    from cmdiad_tpu_torch.data.mvtec3d import eyecandies_classes, mvtec3d_classes
    if cfg.class_name:
        return [cfg.class_name]
    return eyecandies_classes() if cfg.dataset_type == "eyecandies" else mvtec3d_classes()


def cmd_detect(args):
    """-> (results {class: metrics}, timings {class: timings})."""
    from cmdiad_tpu_torch.runner import run_detection

    cfg = _config_from_args(args).validate()
    timings: Dict[str, Dict[str, float]] = {}

    def done(cls, metrics, t):
        timings[cls] = dict(t)
        print(f"class {cls}: timings " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))

    def run():
        return run_detection(cfg, _classes(cfg), device=args.device, on_class_done=done)

    if args.trace_dir:
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.device(args.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            results = run()
        os.makedirs(args.trace_dir, exist_ok=True)
        path = os.path.join(args.trace_dir, "trace.json")
        prof.export_chrome_trace(path)
        print(f"torch.profiler trace written to {path} (chrome://tracing or Perfetto)")
    else:
        results = run()
    write_result_tables(cfg, results)
    return results, timings


def main(argv=None):
    parser = argparse.ArgumentParser("cmdiad_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("detect", help="memory-bank detection / evaluation")
    _add_config_args(p)
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")
    p.add_argument("--trace_dir", default="",
                   help="write a torch.profiler trace of the run to DIR/trace.json")
    p.set_defaults(fn=cmd_detect)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
