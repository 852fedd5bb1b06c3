"""Test CLI: the reference's test.py (reconstruction of the test split,
per-shape Chamfer, renders), on the card.

    python -m pointnet_autoencoder_tpu_torch.cli.test \\
        --model model --model_path log/model.ckpt --category Chair \\
        --out_dir renders [--device cuda]

Every flag of ``pointnet_autoencoder_tpu/cli/test.py`` is accepted, plus
``--device`` (``cuda`` by default, which fails without a card; ``cpu``
runs the kernels' plain PyTorch versions). ``--gpu`` is accepted for
reference compatibility and ignored; ``--compilation_cache_dir`` has no
counterpart (the port compiles no XLA programs) and raises
NotImplementedError when given.

``--model_path`` is anything ``InferenceSession`` opens: a training
checkpoint of the port, a serving bundle, a reference-named ``.npz`` or a
``.pt`` state_dict. The session serves one shape per launch
(``batch_size=1``): ``reconstruct``, ``chamfer`` and, with
``--fscore_threshold``, ``fscore``. Renders (ground truth, reconstruction
and, with ``--num_group`` above 1, the reconstruction colored by decoder
group) go to ``--out_dir`` (default ``<model_path dir>/renders``), drawn
by the native renderer, or to the OpenCV viewer with ``--interactive``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from pointnet_autoencoder_tpu_torch.config import TestConfig, refuse_unported


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    d = TestConfig()
    p.add_argument("--gpu", type=int, default=0,
                   help="Accepted for reference compatibility; ignored "
                        "(use --device cuda:N)")
    p.add_argument("--num_point", type=int, default=d.num_point,
                   help="Point Number [default: 2048]")
    p.add_argument("--category", default=None,
                   help="Which single class to test on [default: None]")
    p.add_argument("--model", default=d.model,
                   help="Model name [default: model]")
    p.add_argument("--model_path", default=d.model_path,
                   help="model checkpoint path [default: log/model.ckpt]")
    p.add_argument("--num_group", type=int, default=d.num_group,
                   help="Number of groups of generated points -- used for "
                        "hierarchical FC decoder. [default: 1]")
    p.add_argument("--data_path", default=d.data_path)
    p.add_argument("--out_dir", default=None,
                   help="Write rendered PNGs here [default: "
                        "<model_path dir>/renders]")
    p.add_argument("--interactive", action="store_true",
                   help="Open the OpenCV viewer instead of writing PNGs")
    p.add_argument("--num_shapes", type=int, default=None,
                   help="How many test shapes to process [default: all]")
    p.add_argument("--cache_dir", default=None,
                   help="On-disk cache of decoded shapes (.npz)")
    p.add_argument("--fscore_threshold", type=float, default=None,
                   help="Also report reconstruction F-score at this "
                        "distance threshold (e.g. 0.01; off by default "
                        "to keep the reference's output surface)")
    p.add_argument("--compilation_cache_dir", default=None,
                   help="Not ported (no XLA programs to cache)")
    p.add_argument("--seed", type=int, default=d.seed)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; fails without a card) or cpu")
    return p


def main(argv=None) -> dict:
    """Run the test loop; returns {"chamfer": [...], "fscore": [...] or
    None, "indices": dataset indices in order, "out_dir": ...}."""
    args = build_parser().parse_args(argv)
    refuse_unported("compilation_cache_dir", args.compilation_cache_dir)

    from pointnet_autoencoder_tpu_torch.data.shapenet_part import PartDataset
    from pointnet_autoencoder_tpu_torch.inference import InferenceSession
    from pointnet_autoencoder_tpu_torch.viz import render

    class_choice = [args.category] if args.category else None
    dataset = PartDataset(args.data_path, npoints=args.num_point,
                          class_choice=class_choice, split="test",
                          seed=args.seed, cache_dir=args.cache_dir)
    print(len(dataset))

    session = InferenceSession(args.model, args.model_path, args.num_point,
                               batch_size=1, device=args.device)

    out_dir = args.out_dir
    if args.interactive:
        # The interactive branch renders to the viewer only; never claim
        # PNGs were written.
        if out_dir:
            print("--interactive ignores --out_dir (no PNGs are written)")
        out_dir = None
    elif out_dir is None:
        out_dir = os.path.join(
            os.path.dirname(os.path.abspath(args.model_path)), "renders")
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    rng = np.random.default_rng(args.seed)
    indices = rng.permutation(len(dataset))
    count = len(indices) if args.num_shapes is None else min(
        args.num_shapes, len(indices))
    group_colors = (render.group_colors(args.num_point, args.num_group,
                                        rng) if args.num_group > 1 else None)

    chamfers, fscores = [], []
    for i in range(count):
        ps, _ = dataset[int(indices[i])]
        pred = session.reconstruct(ps)
        cd = float(session.chamfer(pred[None], ps[None])[0])
        chamfers.append(cd)
        if args.fscore_threshold is not None:
            fs = float(session.fscore(pred[None], ps[None],
                                      args.fscore_threshold)[0])
            fscores.append(fs)
            print(f"shape {i}: chamfer {cd:.6f} "
                  f"fscore@{args.fscore_threshold:g} {fs:.4f}")
        else:
            print(f"shape {i}: chamfer {cd:.6f}")
        if args.interactive:
            render.showpoints(ps, ballradius=8)
            render.showpoints(pred, ballradius=8)
            if group_colors is not None:
                render.showpoints(pred, c_gt=group_colors, ballradius=8)
        else:
            render.save_image(render.render_points(ps, ballradius=8),
                              os.path.join(out_dir, f"{i:04d}_gt.png"))
            render.save_image(render.render_points(pred, ballradius=8),
                              os.path.join(out_dir, f"{i:04d}_pred.png"))
            if group_colors is not None:
                render.save_image(
                    render.render_points(pred, colors=group_colors,
                                         ballradius=8),
                    os.path.join(out_dir, f"{i:04d}_pred_groups.png"))
    if count:
        print(f"mean chamfer over {count} shapes: "
              f"{sum(chamfers) / count:.6f}")
        if args.fscore_threshold is not None:
            print(f"mean fscore@{args.fscore_threshold:g} over {count} "
                  f"shapes: {sum(fscores) / count:.4f}")
    if out_dir:
        print(f"renders written to {out_dir}")
    return {"chamfer": chamfers,
            "fscore": fscores if args.fscore_threshold is not None else None,
            "indices": [int(j) for j in indices[:count]], "out_dir": out_dir}


if __name__ == "__main__":
    main(sys.argv[1:])
