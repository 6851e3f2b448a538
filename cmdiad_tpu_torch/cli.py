"""Command-line interface of the port.

  python -m cmdiad_tpu_torch.cli detect [--<Config field> value ...] [--device cuda|cpu]
  python -m cmdiad_tpu_torch.cli train [--<TrainConfig field> value ...] [--device cuda|cpu]
  python -m cmdiad_tpu_torch.cli convert-ckpt --src net.pth --dst net.npz --kind KIND
  python -m cmdiad_tpu_torch.cli preprocess --dataset_path DIR [--num_process 6] [--device cuda|cpu]
  python -m cmdiad_tpu_torch.cli preprocess-eyecandies --dataset_path SRC --target_dir DST [--device cuda|cpu]
  python -m cmdiad_tpu_torch.cli heatmap --seg_dir DIR --out_dir DIR [--limit N]

``detect`` fits and evaluates every class of the dataset at
``--dataset_path`` (or the one ``--class_name``) with the configured
method, prints one markdown table a metric and, with ``--save_results``
(default true), appends them to ``<results_dir>/*.md``.  Every ``Config``
field is a flag.  ``--device`` defaults to ``cuda``; ``--trace_dir DIR``
writes a ``torch.profiler`` trace of the run to ``DIR/trace.json``, which
holds the port's ``span.*`` ranges (``tracing.SPANS``: the predict call,
its upload and readback, the point path's FPS, KNN, group encoder,
blocks and regrid, each ViT block's attention and MLP, and the gated
FFN's gate inside the MLP), and prints the predict path's counters a call
(host syncs, MB uploaded) beside the trace's path.
The MTFI methods take their fusion net from ``--fusion_module_path`` (a
reference ``.pth`` or the JAX package's ``.npz``), the backbones their
weights from ``--rgb_ckpt_path`` and ``--xyz_ckpt_path``.

``train`` runs MTFI distillation training (``train.distill``) on the
dumps under ``--data_path`` and prints the JAX CLI's JSON line: the last
epoch's ``final_train_loss`` and ``final_test_loss``, or ``{"status":
"already complete", ...}`` when the resumed run has no epoch left.  Every
``TrainConfig`` field is a flag; ``--device`` defaults to ``cuda``.

``convert-ckpt`` writes a reference torch checkpoint in the JAX package's
npz layout, the same file as the JAX CLI's ``convert-ckpt``.

``preprocess`` rewrites an MVTec 3D-AD tree in place (plane removal,
padding, largest-cluster cleaning; ``preprocess.mvtec``) and prints the
JAX CLI's ``preprocessed N tiffs`` and a line of summed seconds;
``preprocess-eyecandies`` converts an Eyecandies tree to that layout
(``preprocess.eyecandies``); both run their device work on ``--device``
(default ``cuda``).  ``heatmap`` renders the ``.npz`` maps that
``--save_seg_results`` writes (``utils.heatmap``, host code) and prints
``N heatmaps rendered``.

``detect`` and ``train`` run on several devices under torchrun, one
process a rank (``--device cuda``: NCCL, rank r on ``cuda:{LOCAL_RANK}``;
``--device cpu``: gloo), with ``--mesh_shape n`` (and ``--shard_bank true``
for detection); tables, the JSON line and files come from rank 0:

  torchrun --standalone --nproc_per_node 2 -m cmdiad_tpu_torch.cli detect --mesh_shape 2 ...

The tables are the text of pandas' ``DataFrame.to_markdown(index=False)``
(tabulate's ``pipe`` format), written without pandas.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, List, Sequence

import numpy as np
import torch.distributed as dist

from cmdiad_tpu_torch import tracing
from cmdiad_tpu_torch.config import Config, TrainConfig
from cmdiad_tpu_torch.models import convert, names
from cmdiad_tpu_torch.parallel.mesh import init_from_env


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


def _add_config_args(parser: argparse.ArgumentParser, dc_type=Config) -> None:
    for f in dataclasses.fields(dc_type):
        name, default, typ = "--" + f.name, f.default, _field_type(f)
        if typ is bool:
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=default)
        elif typ is tuple:
            parser.add_argument(name, type=_parse_int_tuple, default=default,
                                help="comma-separated ints, e.g. '8'")
        elif typ is not None:
            parser.add_argument(name, type=typ, default=default)


def _config_from_args(args, dc_type=Config):
    return dc_type(**{f.name: getattr(args, f.name) for f in dataclasses.fields(dc_type)})


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


def _rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def counters_line(c: Dict[str, int]) -> str:
    """One line of the predict path's counters (``tracing.counters()``) a
    call."""
    calls = max(c["calls"], 1)
    return (f"predict path: {c['host_syncs'] / calls:.2f} host syncs and "
            f"{c['h2d_bytes'] / calls / 1e6:.4f} MB uploaded a call over "
            f"{c['calls']} calls, {c['images']} images")


def cmd_detect(args):
    """-> (results {class: metrics}, timings {class: timings})."""
    from cmdiad_tpu_torch.runner import run_detection

    cfg = _config_from_args(args).validate()
    device = init_from_env(args.device)
    timings: Dict[str, Dict[str, float]] = {}

    def done(cls, metrics, t):
        timings[cls] = dict(t)
        if _rank0():
            print(f"class {cls}: timings " + ", ".join(f"{k} {v:.4f}" for k, v in t.items()))

    def run():
        return run_detection(cfg, _classes(cfg), device=device, on_class_done=done)

    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        tracing.reset_counters()
        with profile(activities=acts) as prof:
            results = run()
        if _rank0():
            os.makedirs(args.trace_dir, exist_ok=True)
            path = os.path.join(args.trace_dir, "trace.json")
            prof.export_chrome_trace(path)
            print(f"torch.profiler trace written to {path} (chrome://tracing or Perfetto)")
            print(counters_line(tracing.counters()))
    else:
        results = run()
    if _rank0():
        write_result_tables(cfg, results)
    return results, timings


def cmd_train(args) -> dict:
    """Train, print and return the JAX CLI's JSON record."""
    from cmdiad_tpu_torch.train.distill import DistillTrainer
    cfg = _config_from_args(args, TrainConfig)
    trainer = DistillTrainer(cfg, device=init_from_env(args.device))
    history = trainer.train().history
    if not history["train_loss"]:
        record = {"status": "already complete", "start_epoch": trainer.start_epoch,
                  "epochs": cfg.epochs}
    else:
        record = {"final_train_loss": history["train_loss"][-1],
                  "final_test_loss": history["test_loss"][-1]}
    if _rank0():
        print(json.dumps(record))
    return record


# convert-ckpt --kind -> the name table of a reference state dict, told by
# its keys; the backbones at the JAX CLI's depth of 12, which keeps blocks
# 0-11 of a deeper ViT, as that CLI does
_TABLES = {
    "vit": lambda sd: names.vit(layer_scale="blocks.0.ls1.gamma" in sd,
                                registers="reg_token" in sd,
                                qkv_bias="blocks.0.attn.qkv.bias" in sd),
    "point_mae": lambda sd: names.point_mae(point_bert="reduce_dim.weight" in sd),
    "ftof_mlp": lambda sd: names.ftof_mlp(),
    "ftof_conv": lambda sd: names.ftof_conv(),
    "ftoi_mlp": lambda sd: names.ftoi_mlp(),
    "ftoi_conv": lambda sd: names.ftoi_conv(),
    "hrnet": lambda sd: names.hrnet(),
}


def cmd_convert_ckpt(args) -> None:
    from cmdiad_tpu_torch.train.checkpoint import save_pytree
    sd = convert.load_torch_checkpoint(args.src)
    if args.kind == "point_mae":
        sd = convert.strip_pointmae_prefixes(sd)
    tree = names.to_flax(_TABLES[args.kind](sd), sd)
    save_pytree(args.dst, tree, meta={"kind": args.kind, "src": args.src})
    print(f"converted {args.src} -> {args.dst}")


def cmd_preprocess(args):
    """-> (tiffs preprocessed, summed seconds by phase)."""
    from cmdiad_tpu_torch.preprocess.mvtec import preprocess_dataset
    n, seconds = preprocess_dataset(args.dataset_path, num_workers=args.num_process,
                                    device=args.device)
    print(f"preprocessed {n} tiffs")
    print("seconds summed over the tiffs: " + ", ".join(f"{k} {v:.4f}" for k, v in seconds.items()))
    return n, seconds


def cmd_preprocess_eyecandies(args) -> None:
    from cmdiad_tpu_torch.preprocess.eyecandies import convert_dataset
    convert_dataset(args.dataset_path, args.target_dir, device=args.device)


def cmd_heatmap(args) -> int:
    from cmdiad_tpu_torch.utils.heatmap import render_run
    n = render_run(args.seg_dir, args.out_dir, args.limit)
    print(n, "heatmaps rendered")
    return n


def _add_device_arg(p) -> None:
    p.add_argument("--device", default="cuda",
                   help="'cuda' (default; raises without a card) or 'cpu'")


def main(argv=None):
    parser = argparse.ArgumentParser("cmdiad_tpu_torch")
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("detect", help="memory-bank detection / evaluation")
    _add_config_args(p)
    _add_device_arg(p)
    p.add_argument("--trace_dir", default="",
                   help="write a torch.profiler trace of the run to DIR/trace.json")
    p.set_defaults(fn=cmd_detect)
    p = sub.add_parser("train", help="MTFI distillation training")
    _add_config_args(p, TrainConfig)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_train)
    p = sub.add_parser("convert-ckpt", help="torch .pth -> the JAX package's .npz params")
    p.add_argument("--src", required=True)
    p.add_argument("--dst", required=True)
    p.add_argument("--kind", required=True, choices=list(_TABLES))
    p.set_defaults(fn=cmd_convert_ckpt)
    p = sub.add_parser("preprocess", help="MVTec 3D-AD in-place preprocessing")
    p.add_argument("--dataset_path", "-d", required=True)
    p.add_argument("--num_process", "-n", type=int, default=6)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_preprocess)
    p = sub.add_parser("preprocess-eyecandies")
    p.add_argument("--dataset_path", required=True)
    p.add_argument("--target_dir", required=True)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_preprocess_eyecandies)
    p = sub.add_parser("heatmap", help="render saved segmentation maps")
    p.add_argument("--seg_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--limit", type=int, default=0)
    p.set_defaults(fn=cmd_heatmap)
    args = parser.parse_args(argv)
    try:
        return args.fn(args)
    finally:
        if "RANK" in os.environ and dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
