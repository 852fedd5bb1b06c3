"""Convert a reference TF-1.x checkpoint (or reference-named ``.npz``)
into a serving bundle of the port.

    python -m pointnet_autoencoder_tpu_torch.cli.import_tf \\
        --model model --tf_checkpoint /path/log/model.ckpt \\
        --num_point 2048 --out serving/imported

``--tf_checkpoint`` is the Saver prefix the reference's train.py wrote
(reading it needs tensorflow), or a ``.npz`` archive keyed by variable
name (no tensorflow needed), such as the JAX package's or the port's
``cli.export --format reference_npz``. The output opens with
``InferenceSession.from_bundle`` and ``cli.test --model_path``; the
mapping rules are in ``pointnet_autoencoder_tpu_torch/tf_import.py``.
Without ``--out`` the command checks the mapping and prints the report
only (a dry run). The conversion runs on the host; no device is used.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="model",
                   help="Registry name matching the checkpoint's --model")
    p.add_argument("--tf_checkpoint", required=True,
                   help="TF Saver checkpoint prefix (or .npz archive)")
    p.add_argument("--num_point", type=int, default=2048)
    p.add_argument("--out", default=None,
                   help="Bundle output directory (omit for a dry run)")
    p.add_argument("--allow_unknown", action="store_true",
                   help="Tolerate unmapped checkpoint variables instead of "
                        "failing (forks with extra layers)")
    return p


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    from pointnet_autoencoder_tpu_torch.tf_import import (
        import_reference_checkpoint,
    )

    _, report = import_reference_checkpoint(
        args.model, args.tf_checkpoint, args.num_point, out_dir=args.out,
        strict=not args.allow_unknown)
    print(json.dumps(report, indent=2))
    return report


if __name__ == "__main__":
    main(sys.argv[1:])
