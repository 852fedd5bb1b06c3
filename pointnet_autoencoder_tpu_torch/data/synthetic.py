"""Synthetic on-disk ShapeNetPart fixture, the port's copy of
``pointnet_autoencoder_tpu/data/synthetic.py:write_fixture``.

Writes a small dataset in the exact layout ``PartDataset`` reads
(synsetoffset2category.txt, train_test_split/*.json, <synset>/points/*.pts,
<synset>/points_label/*.seg), so the loader, the pipeline, the CLI and
end-to-end training run without the real archive. Shapes are parametric
surfaces (sphere, box shell, cylinder) with part labels by region, which
gives the autoencoder something to learn. The same arguments write the
same files as the reference's fixture. ``write_real_scale_fixture``
writes one at the real archive's scale (16 categories, 16,881 shapes,
ragged point counts) for wall-clock and memory calibration.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

# The 16 ShapeNetPart categories with their synset offsets (the v0
# archive's synsetoffset2category.txt). Chair, Table and Lamp are the
# default trio, so small fixtures stay small.
_DEFAULT_CATEGORIES = ("Chair", "Table", "Lamp")
_SYNSETS = {
    "Airplane": "02691156", "Bag": "02773838", "Cap": "02954340",
    "Car": "02958343", "Chair": "03001627", "Earphone": "03261776",
    "Guitar": "03467517", "Knife": "03624134", "Lamp": "03636649",
    "Laptop": "03642806", "Motorbike": "03790512", "Mug": "03797390",
    "Pistol": "03948459", "Rocket": "04099429", "Skateboard": "04225987",
    "Table": "04379243",
}

# Published per-category shape totals of the ShapeNetPart segmentation
# benchmark (16,881 shapes; the table from the PointNet/ShapeNetPart
# literature). Approximate per-category ground truth for the v0 archive,
# used only to size the calibration fixture.
REAL_V0_COUNTS = {
    "Airplane": 2690, "Bag": 76, "Cap": 55, "Car": 898, "Chair": 3758,
    "Earphone": 69, "Guitar": 787, "Knife": 392, "Lamp": 1547,
    "Laptop": 451, "Motorbike": 202, "Mug": 184, "Pistol": 283,
    "Rocket": 66, "Skateboard": 152, "Table": 5271,
}


def _make_shape(rng: np.random.Generator, kind: int, npts: int):
    if kind == 0:  # sphere with hemisphere part labels
        v = rng.normal(size=(npts, 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
        seg = (v[:, 1] > 0).astype(np.int64) + 1
    elif kind == 1:  # axis-aligned box shell, labels by dominant face axis
        face = rng.integers(0, 3, size=npts)
        signs = rng.choice([-1.0, 1.0], size=npts)
        v = rng.uniform(-1, 1, size=(npts, 3))
        v[np.arange(npts), face] = signs
        seg = face.astype(np.int64) + 1
    else:  # cylinder with cap/side labels
        theta = rng.uniform(0, 2 * np.pi, size=npts)
        y = rng.uniform(-1, 1, size=npts)
        v = np.stack([np.cos(theta), y, np.sin(theta)], axis=1)
        cap = rng.random(npts) < 0.2
        v[cap, 1] = np.sign(v[cap, 1])
        seg = cap.astype(np.int64) + 1
    # Random anisotropic scale and jitter so shapes differ.
    v = v * rng.uniform(0.5, 1.5, size=(1, 3))
    v = v + rng.normal(scale=0.02, size=v.shape)
    return v.astype(np.float32), seg


def write_fixture(root: str, shapes_per_category: int = 12,
                  points_per_shape: int = 128, seed: int = 0,
                  categories: List[str] | None = None,
                  variable_points: bool = False,
                  category_counts: Dict[str, int] | None = None) -> str:
    """Creates the fixture under ``root`` and returns ``root``.

    Each category (Chair, Table and Lamp unless ``categories`` or
    ``category_counts`` names others of the 16) gets
    ``shapes_per_category`` shapes, or its count in ``category_counts``,
    about 2/3 in the train split, 1/6 in val and 1/6 in test.
    ``variable_points`` draws each shape's point count uniformly from
    [points_per_shape/2, points_per_shape], like the real archive's ragged
    shapes."""
    rng = np.random.default_rng(seed)
    cats = list(categories if categories is not None
                else category_counts if category_counts is not None
                else _DEFAULT_CATEGORIES)
    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "synsetoffset2category.txt"), "w") as f:
        for c in cats:
            f.write(f"{c}\t{_SYNSETS[c]}\n")

    splits: Dict[str, List[str]] = {"train": [], "val": [], "test": []}
    for c in cats:
        synset = _SYNSETS[c]
        pts_dir = os.path.join(root, synset, "points")
        seg_dir = os.path.join(root, synset, "points_label")
        os.makedirs(pts_dir, exist_ok=True)
        os.makedirs(seg_dir, exist_ok=True)
        count = (category_counts[c] if category_counts is not None
                 else shapes_per_category)
        for i in range(count):
            token = f"{synset}_{i:04d}"
            npts = (int(rng.integers(points_per_shape // 2,
                                     points_per_shape + 1))
                    if variable_points else points_per_shape)
            pts, seg = _make_shape(rng, i % 3, npts)
            np.savetxt(os.path.join(pts_dir, token + ".pts"), pts, fmt="%.6f")
            np.savetxt(os.path.join(seg_dir, token + ".seg"), seg, fmt="%d")
            bucket = ("train", "val", "test")[
                0 if i % 6 < 4 else 1 if i % 6 == 4 else 2]
            splits[bucket].append(f"shape_data/{synset}/{token}")

    split_dir = os.path.join(root, "train_test_split")
    os.makedirs(split_dir, exist_ok=True)
    for name, entries in splits.items():
        with open(os.path.join(split_dir, f"shuffled_{name}_file_list.json"),
                  "w") as f:
            json.dump(entries, f)
    return root


def write_real_scale_fixture(root: str, points_per_shape: int = 3000,
                             seed: int = 0) -> str:
    """A fixture at the real archive's scale: all 16 categories with their
    published shape totals (``REAL_V0_COUNTS``, 16,881 shapes) and ragged
    point counts averaging about 2,250 (the real archive averages about
    2,600). The split-bucket cycle gives the v0 archive's proportions,
    about 5/6 trainval and 1/6 test.

    For wall-clock and memory calibration of full-dataset runs while the
    real archive is out of reach; the shapes are synthetic, so its losses
    do not compare with real data."""
    return write_fixture(
        root, points_per_shape=points_per_shape, seed=seed,
        variable_points=True, category_counts=REAL_V0_COUNTS,
    )
