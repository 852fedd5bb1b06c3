"""Export a params-only serving bundle, or reference-named weights, from
a training checkpoint of the port.

    python -m pointnet_autoencoder_tpu_torch.cli.export \\
        --model model --model_path log/best_model_epoch_087.ckpt \\
        --num_point 2048 --out serving/chair_fc [--format reference_npz]

``--format bundle`` (the default) writes a serving bundle, which
``InferenceSession.from_bundle``, ``cli.test --model_path`` and
``cli.serve --model_path`` open; ``reference_npz`` writes one ``.npz``
keyed by the reference stack's variable names in its layouts, which the
port, the JAX package's ``cli.import_tf`` and a TF Saver can read. Both
hold the model's weights and BN statistics in f32, without optimizer
state. The flags are those of ``pointnet_autoencoder_tpu/cli/export.py``,
plus ``--device`` (``cuda`` by default; ``cpu`` to run without a card).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="model",
                   help="Registry name the checkpoint was trained with")
    p.add_argument("--model_path", required=True,
                   help="Training checkpoint directory (model.ckpt / "
                        "best_model_epoch_NNN.ckpt)")
    p.add_argument("--num_point", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=32,
                   help="Batch size of the session that loads the weights")
    p.add_argument("--out", required=True,
                   help="Bundle output directory (or .npz path with "
                        "--format reference_npz)")
    p.add_argument("--format", default="bundle",
                   choices=("bundle", "reference_npz"),
                   help="bundle: serving bundle (default). reference_npz: "
                        "a flat numpy archive keyed by the reference "
                        "stack's variable names, in its layouts")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def main(argv=None) -> str:
    args = build_parser().parse_args(argv)
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession

    sess = InferenceSession(args.model, args.model_path, args.num_point,
                            batch_size=args.batch_size, device=args.device)
    if args.format == "reference_npz":
        import numpy as np

        from pointnet_autoencoder_tpu_torch.tf_import import (
            export_reference_arrays,
        )

        arrays = export_reference_arrays(sess.model.state_dict())
        out = args.out if args.out.endswith(".npz") else args.out + ".npz"
        np.savez(out, **arrays)
        print(f"reference-named weights ({len(arrays)} arrays) written "
              f"to {out}")
        return out
    out = sess.export_bundle(args.out)
    print(f"serving bundle written to {out}")
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
