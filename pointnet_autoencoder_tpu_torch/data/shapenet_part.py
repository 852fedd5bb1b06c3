"""ShapeNetPart v0 dataset, the port's copy of
``pointnet_autoencoder_tpu/data/shapenet_part.py``.

Same on-disk layout and observable behavior:

- category map from ``synsetoffset2category.txt``;
- official shuffled train/val/test splits from
  ``train_test_split/shuffled_*_file_list.json``;
- per-shape ``.pts`` xyz and ``.seg`` label files, parsed natively
  (``data/fastio.py``), which rejects a file with another column count;
- unit-sphere normalization (``normalize``, on by default);
- segmentation items, or classification items (``classification``);
- random resample *with replacement* to ``npoints`` on every access, fresh
  randomness even on cache hits, from an explicit seeded
  ``numpy.random.Generator``;
- an in-RAM cache of up to 18000 decoded shapes, and an optional on-disk
  ``.npz`` cache of decoded shapes (``cache_dir``);
- ``rotate_point_cloud``: a random rotation about the up (Y) axis per
  shape.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from pointnet_autoencoder_tpu_torch.data import fastio

_CACHE_SIZE = 18000


def pc_normalize(pc: np.ndarray) -> np.ndarray:
    """Center on the centroid and scale into the unit sphere."""
    pc = pc - pc.mean(axis=0)
    scale = np.max(np.sqrt((pc**2).sum(axis=1)))
    if scale > 0:
        pc = pc / scale
    return pc


def rotate_point_cloud(batch: np.ndarray,
                       rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Random per-shape rotation about the up (Y) axis. (B,N,3) -> (B,N,3):
    each shape gets an independent uniform angle and its points are
    right-multiplied by [[c,0,s],[0,1,0],[-s,0,c]]."""
    rng = rng or np.random.default_rng()
    b = batch.shape[0]
    angles = rng.uniform(0.0, 2.0 * np.pi, size=(b,))
    c, s = np.cos(angles), np.sin(angles)
    zeros = np.zeros_like(c)
    ones = np.ones_like(c)
    rot = np.stack(
        [c, zeros, s, zeros, ones, zeros, -s, zeros, c], axis=-1
    ).reshape(b, 3, 3)
    return np.einsum("bnc,bcd->bnd", batch, rot).astype(np.float32)


class PartDataset:
    """Indexable ShapeNetPart dataset.

    Args mirror the reference constructor (part_dataset.py:42): ``root``,
    ``npoints``, ``classification``, ``class_choice`` (an iterable of
    category names or None for all), ``split`` in {train, val, trainval,
    test}, ``normalize``; then ``seed`` and ``cache_dir``.

    ``dataset[i]`` returns (points (npoints,3) f32, seg (npoints,) i64) or,
    in classification mode, (points, cls (1,) i32). ``classes`` maps each
    chosen category to its index, ``num_seg_classes`` is the largest count
    of distinct part labels over a 2% sample of the shapes (0 in
    classification mode), as the reference's (part_dataset.py:94-98).
    """

    def __init__(self, root: str, npoints: int = 2500,
                 classification: bool = False,
                 class_choice: Optional[Sequence[str]] = None,
                 split: str = "train", normalize: bool = True,
                 seed: Optional[int] = None,
                 cache_dir: Optional[str] = None):
        self.root = root
        self.npoints = npoints
        self.classification = classification
        self.normalize = normalize
        self._rng = np.random.default_rng(seed)
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

        catfile = os.path.join(root, "synsetoffset2category.txt")
        if not os.path.exists(catfile):
            raise FileNotFoundError(
                f"no ShapeNetPart dataset at {root!r} (missing "
                f"synsetoffset2category.txt). Point --data_path at a "
                f"shapenetcore_partanno_segmentation_benchmark_v0 directory, "
                f"or generate a synthetic fixture: python -c \"from "
                f"pointnet_autoencoder_tpu_torch.data import synthetic; "
                f"synthetic.write_fixture('{root}', 60, 512)\"")
        self.cat: Dict[str, str] = {}
        with open(catfile) as f:
            for line in f:
                parts = line.strip().split()
                if len(parts) == 2:
                    self.cat[parts[0]] = parts[1]
        if class_choice is not None:
            chosen = set(class_choice)
            self.cat = {k: v for k, v in self.cat.items() if k in chosen}
            if not self.cat:
                raise ValueError(f"no categories match {class_choice!r}")

        split_ids = self._load_split_ids(split)
        self.datapath: List[Tuple[str, str, str]] = []
        for item, synset in self.cat.items():
            dir_point = os.path.join(root, synset, "points")
            dir_seg = os.path.join(root, synset, "points_label")
            for fn in sorted(os.listdir(dir_point)):
                token = os.path.splitext(fn)[0]
                if split_ids is not None and token not in split_ids:
                    continue
                self.datapath.append((
                    item,
                    os.path.join(dir_point, token + ".pts"),
                    os.path.join(dir_seg, token + ".seg"),
                ))

        self.classes = {cat: i for i, cat in enumerate(self.cat)}
        self.num_seg_classes = self._scan_seg_classes()
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    def drop_item_cache(self) -> None:
        """Release the in-RAM item cache. Items decode (and cache) again
        on their next access. Device input calls this once the whole
        dataset is on the card (``data/device_pipeline.py``)."""
        self._cache.clear()

    def _load_split_ids(self, split: str):
        def ids(name):
            path = os.path.join(self.root, "train_test_split",
                                f"shuffled_{name}_file_list.json")
            with open(path) as f:
                return {entry.split("/")[2] for entry in json.load(f)}

        if split == "trainval":
            return ids("train") | ids("val")
        if split in ("train", "val", "test"):
            return ids(split)
        raise ValueError(f"unknown split {split!r}")

    def _scan_seg_classes(self) -> int:
        if self.classification or not self.datapath:
            return 0
        return max(len(np.unique(fastio.load_seg(self.datapath[i][2])))
                   for i in range(max(1, len(self.datapath) // 50)))

    def _disk_cache_path(self, pts_path: str) -> Optional[str]:
        if not self.cache_dir:
            return None
        synset = os.path.basename(os.path.dirname(os.path.dirname(pts_path)))
        token = os.path.splitext(os.path.basename(pts_path))[0]
        # Keyed on the absolute source path too: two dataset roots sharing
        # a cache_dir reuse synset/token names.
        root_tag = hashlib.sha1(
            os.path.abspath(pts_path).encode()).hexdigest()[:8]
        return os.path.join(self.cache_dir,
                            f"{synset}_{token}_{root_tag}.npz")

    def _decode(self, pts_path: str, seg_path: str):
        """Raw (points f32, 1-based seg i64), through the on-disk cache when
        enabled. Cache writes are atomic (tmp + rename); a file the parser
        rejects raises before anything is cached."""
        cpath = self._disk_cache_path(pts_path)
        if cpath is not None:
            try:
                src_mtime = max(os.path.getmtime(pts_path),
                                os.path.getmtime(seg_path))
                if os.path.getmtime(cpath) >= src_mtime:
                    with np.load(cpath) as z:
                        return z["pts"], z["seg"]
            except (OSError, KeyError, ValueError):
                pass  # missing, stale or corrupt entry: decode and rewrite
        point_set = fastio.load_pts(pts_path)
        seg = fastio.load_seg(seg_path)
        if cpath is not None:
            tmp = f"{cpath}.tmp-{os.getpid()}.npz"
            try:
                np.savez(tmp, pts=point_set, seg=seg)
                os.replace(tmp, cpath)
            except OSError:
                pass  # a read-only or full cache dir only loses the cache
        return point_set, seg

    def _load(self, index: int):
        """(points f32, 0-based seg i64, cls (1,) i32) of shape ``index``,
        normalized unless ``normalize`` is off."""
        if index in self._cache:
            return self._cache[index]
        cat, pts_path, seg_path = self.datapath[index]
        cls = np.array([self.classes[cat]], dtype=np.int32)
        point_set, seg = self._decode(pts_path, seg_path)
        if self.normalize:
            point_set = pc_normalize(point_set)
        # Labels on disk are 1-based.
        item = (point_set.astype(np.float32), seg - 1, cls)
        if len(self._cache) < _CACHE_SIZE:
            self._cache[index] = item
        return item

    def __getitem__(self, index: int):
        point_set, seg, cls = self._load(index)
        # Resample with replacement: fresh randomness on every access.
        choice = self._rng.integers(0, len(seg), size=self.npoints)
        if self.classification:
            return point_set[choice, :], cls
        return point_set[choice, :], seg[choice]

    def __len__(self) -> int:
        return len(self.datapath)
