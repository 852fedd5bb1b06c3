"""Parity harness: one command from dataset to recorded numbers, on the
card.

The port's copy of ``pointnet_autoencoder_tpu/cli/parity.py``, with the
same flags, the same record keys and the same table, plus ``--device``;
``--compilation_cache_dir`` (an XLA cache there) has no counterpart and is
refused. Pointed at a
``shapenetcore_partanno_segmentation_benchmark_v0`` directory, it:

1. checks the dataset against the real archive's split sizes (Chair
   trainval = 3371, test = 704), or says that it runs on a stand-in
   fixture when the counts differ;
2. runs the reference README's command (``train.py --model model
   --num_point 2048 --category Chair --no_rotation``, README.md:27) for the
   requested epochs through the port's ``Trainer``;
3. appends the best checkpoint's eval Chamfer and the training throughput
   to ``docs/RESULTS_TORCH.md`` (the port's record; ``docs/RESULTS.md``
   holds the TPU's rows).

``--synth_fixture`` writes a synthetic fixture at ``--data_path`` first;
``--fixture_shapes 4045 --fixture_categories Chair`` gives the real Chair
trainval count, so 201 epochs at batch 32 are 21,105 steps:

    python -m pointnet_autoencoder_tpu_torch.cli.parity --synth_fixture \\
        --fixture_shapes 4045 --fixture_categories Chair \\
        --data_path <root> --log_dir <dir> [--device cuda]
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import subprocess
import sys
import time

from pointnet_autoencoder_tpu_torch.config import refuse_unported

# Real-archive invariants (train_test_split/*.json of the 635 MB archive,
# reference README.md:18; counts quoted in SURVEY.md).
REAL_CHAIR_TRAINVAL = 3371
REAL_CHAIR_TEST = 704


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_path",
                   default="data/shapenetcore_partanno_segmentation_benchmark_v0")
    p.add_argument("--synth_fixture", action="store_true",
                   help="Generate a synthetic fixture at --data_path first "
                        "(for environments without the real archive)")
    p.add_argument("--fixture_shapes", type=int, default=48,
                   help="Shapes per category for --synth_fixture. 4045 "
                        "makes the trainval split exactly the real Chair "
                        "count (3371; splits are 4/6 train, 1/6 val, 1/6 "
                        "test)")
    p.add_argument("--fixture_categories", default=None,
                   help="Comma-separated category names for "
                        "--synth_fixture [default: Chair, Table, Lamp]")
    p.add_argument("--category", default="Chair")
    p.add_argument("--model", default="model")
    p.add_argument("--num_point", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--max_epoch", type=int, default=201,
                   help="Reference README trains 201 epochs; lower for a "
                        "smoke run")
    p.add_argument("--log_dir", default="log_parity")
    p.add_argument("--results", default=None,
                   help="Results file to append to [default: "
                        "docs/RESULTS_TORCH.md next to the package]")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--compilation_cache_dir", default=None,
                   help="Not ported (no XLA programs to cache)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def check_splits(data_path: str, category: str):
    """Returns (is_real_archive, counts dict). Counts come from the loader
    (split json intersected with on-disk shapes), the view training sees.

    The real-archive check is defined for Chair only (the category whose
    real split counts are recorded); any other category is recorded as
    count-unverified, neither a fixture nor REAL."""
    from pointnet_autoencoder_tpu_torch.data.shapenet_part import PartDataset

    counts = {
        split: len(PartDataset(data_path, npoints=8, split=split,
                               class_choice=[category]))
        for split in ("trainval", "test")
    }
    is_real = (category == "Chair"
               and counts["trainval"] == REAL_CHAIR_TRAINVAL
               and counts["test"] == REAL_CHAIR_TEST)
    return is_real, counts


def run(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    refuse_unported("compilation_cache_dir", args.compilation_cache_dir)

    if args.synth_fixture and not os.path.exists(
            os.path.join(args.data_path, "synsetoffset2category.txt")):
        from pointnet_autoencoder_tpu_torch.data import synthetic

        # Variable per-shape point counts, as the real (ragged) archive has.
        cats = (args.fixture_categories.split(",")
                if args.fixture_categories else None)
        synthetic.write_fixture(args.data_path,
                                shapes_per_category=args.fixture_shapes,
                                points_per_shape=900, seed=args.seed,
                                variable_points=True, categories=cats)

    is_real, counts = check_splits(args.data_path, args.category)
    if is_real:
        data_kind = "real shapenetcore_partanno archive"
    elif args.category == "Chair":
        data_kind = "stand-in fixture (NOT the real archive)"
    else:
        data_kind = (f"counts unverified ({args.category}: no recorded "
                     "real split sizes)")
    print(f"dataset: {data_kind}")
    print(f"  {args.category} trainval={counts['trainval']} "
          f"test={counts['test']}"
          + ("" if is_real or args.category != "Chair" else
             f"  (real archive: trainval={REAL_CHAIR_TRAINVAL} "
             f"test={REAL_CHAIR_TEST})"))

    # The README command (reference README.md:27), TrainConfig-shaped.
    from pointnet_autoencoder_tpu_torch.config import TrainConfig
    from pointnet_autoencoder_tpu_torch.train.loop import Trainer

    cfg = TrainConfig(
        model=args.model, category=args.category, log_dir=args.log_dir,
        num_point=args.num_point, max_epoch=args.max_epoch,
        batch_size=args.batch_size, no_rotation=True,
        data_path=args.data_path, seed=args.seed,
    )
    t0 = time.time()
    trainer = Trainer(cfg, device=args.device)
    try:
        best_loss = trainer.train()
    finally:
        trainer.close()
    wall = time.time() - t0

    # The Chamfer recorded is the eval 'pcloss' (raw mean Chamfer, which
    # every loss family reports) at the best-*loss* eval epoch, the one the
    # saved best checkpoint holds, from this run's records only.
    best_chamfer = _eval_pcloss_at_best_loss(args.log_dir, since=t0)
    if best_chamfer is None:
        best_chamfer = float("nan")
    steps = trainer.state.step
    shapes = steps * args.batch_size
    throughput = shapes / wall if wall > 0 else float("nan")
    # The wall time includes the kernels' first build; the steady rate is
    # the slope across the run's own train records.
    steady = _post_warmup_throughput(args.log_dir, args.batch_size,
                                     since=t0)

    record = {
        "date": datetime.date.today().isoformat(),
        "data": data_kind,
        "counts": counts,
        "command": (f"parity --model {args.model} --category {args.category} "
                    f"--num_point {args.num_point} --max_epoch "
                    f"{args.max_epoch} (README command, no_rotation)"),
        "best_eval_loss": best_loss,
        "best_eval_chamfer": best_chamfer,
        "train_steps": steps,
        "wall_seconds_incl_compile": round(wall, 1),
        "throughput_incl_compile_shapes_per_sec": round(throughput, 1),
        "post_warmup_shapes_per_sec": (
            round(steady, 1) if steady is not None else None),
        "backend": _backend_name(trainer.device),
    }

    results_path = args.results or os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)))), "docs", "RESULTS_TORCH.md")
    _append_results(results_path, record, is_real)
    print(json.dumps(record))
    return record


def _backend_name(device) -> str:
    """``cpu``, or ``cuda x<cards> <name>, <power limit>`` as nvidia-smi
    reads them (the speed of a card depends on its power limit)."""
    if device.type != "cuda":
        return device.type
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index}"],
        capture_output=True, text=True, timeout=60, check=True)
    return f"cuda x{torch.cuda.device_count()} {smi.stdout.strip()}"


def _scan_scalars(log_dir: str, split: str, since: float = 0.0):
    """Yield this run's scalars.jsonl records for one split (scalars.jsonl
    is append-only across runs; ``since`` keeps records newer than the
    run's start)."""
    path = os.path.join(log_dir, "scalars.jsonl")
    if not os.path.exists(path):
        return
    with open(path) as f:
        for ln in f:
            try:
                rec = json.loads(ln)
            except ValueError:
                continue
            if rec.get("split") == split and rec.get("time", 0.0) >= since:
                yield rec


def _eval_pcloss_at_best_loss(log_dir: str, since: float = 0.0):
    """'pcloss' of the eval record with the least eval *loss* (the key the
    best-checkpoint policy selects on), so the Chamfer recorded is the one
    the saved best checkpoint reaches. None if eval never ran (a test
    split smaller than one batch)."""
    best = None
    for rec in _scan_scalars(log_dir, "test", since):
        if "pcloss" not in rec:
            continue
        key = float(rec.get("loss", rec["pcloss"]))
        if best is None or key < best[0]:
            best = (key, float(rec["pcloss"]))
    return None if best is None else best[1]


def _post_warmup_throughput(log_dir: str, batch_size: int,
                            since: float = 0.0):
    """Steady shapes/s: the step/time slope between this run's first and
    last train records. The first record lands after the first batches,
    so the kernels' build is left out; eval and checkpoint time between
    records is in, as in a real run. None with fewer than two records or
    a span under 1 s."""
    recs = [r for r in _scan_scalars(log_dir, "train", since)
            if "step" in r and "time" in r]
    if len(recs) < 2:
        return None
    dt = recs[-1]["time"] - recs[0]["time"]
    dstep = recs[-1]["step"] - recs[0]["step"]
    if dt < 1.0 or dstep <= 0:
        return None
    return dstep * batch_size / dt


_TABLE_HEADER = ("| date | data | command | best-ckpt eval Chamfer | steps "
                 "| wall (incl. compile) | post-warmup shapes/s | backend |\n")
_TABLE_MARKER = "|---|---|---|---|---|---|---|---|\n"


def _append_results(path: str, record: dict, is_real: bool) -> None:
    header = "## Real-data parity runs"
    steady = record["post_warmup_shapes_per_sec"]
    if is_real:
        kind = "REAL"
    elif "fixture" in record["data"]:
        kind = "fixture"
    else:
        kind = "unverified"
    line = (f"| {record['date']} | {kind} "
            f"| `{record['command']}` | {record['best_eval_chamfer']:.4f} "
            f"| {record['train_steps']} "
            f"| {record['wall_seconds_incl_compile']:.0f}s "
            f"| {f'{steady:.0f}' if steady is not None else 'n/a'} "
            f"| {record['backend']} |\n")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    text = ""
    if os.path.exists(path):
        with open(path) as f:
            text = f.read()
    hdr_at = text.find(header)
    if hdr_at == -1:
        text += (
            f"\n{header}\n\n"
            "Appended by `python -m pointnet_autoencoder_tpu_torch.cli."
            "parity`.\n"
            "'fixture' rows are synthetic stand-ins; a 'REAL' row appears\n"
            "once the 635 MB ShapeNetPart archive is present. Chamfer is\n"
            "the eval pcloss at the best-loss epoch (what the saved best\n"
            "checkpoint reaches); the wall time includes the kernels' first\n"
            "build; the post-warmup column is the steady rate.\n\n"
            + _TABLE_HEADER + _TABLE_MARKER
        )
        hdr_at = text.find(header)
    # Search for the table only inside this section.
    next_section = text.find("\n## ", hdr_at + 1)
    section_end = next_section if next_section != -1 else len(text)
    marker_at = text.find(_TABLE_MARKER, hdr_at, section_end)
    if marker_at == -1:
        # The section holds a table of other columns: start a table of the
        # current columns at its end rather than lose the row.
        insert = "\n" + _TABLE_HEADER + _TABLE_MARKER
        text = text[:section_end] + insert + text[section_end:]
        marker_at = text.index(_TABLE_MARKER, hdr_at)
    at = marker_at + len(_TABLE_MARKER)
    text = text[:at] + line + text[at:]
    with open(path, "w") as f:
        f.write(text)
    print(f"recorded in {path}")


def main():
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
