"""The port's data layer against the JAX package's (the twin of
tests/test_data.py): the loader's semantics, the native parser
(data/fastio.py over csrc/fastio.cpp, built with g++ here) and its plain
numpy version, the column checks on both paths, the host pipeline and the
on-disk cache, on the synthetic fixture.

Tolerances: the native parse against np.loadtxt at rtol 1e-6 (the JAX
test's; on the fixture's files it is bit-equal), labels exactly; the
port's items, classes and num_seg_classes equal to the JAX package's.
"""

import os
import threading
import time

import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.data import fastio as jfastio
from pointnet_autoencoder_tpu.data import shapenet_part as jshapenet
from pointnet_autoencoder_tpu_torch.cli import train as cli_train
from pointnet_autoencoder_tpu_torch.data import fastio, synthetic
from pointnet_autoencoder_tpu_torch.data.pipeline import BatchPipeline
from pointnet_autoencoder_tpu_torch.data.shapenet_part import (
    PartDataset,
    pc_normalize,
    rotate_point_cloud,
)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("shapenet_fixture")
    return synthetic.write_fixture(str(root), shapes_per_category=12,
                                   points_per_shape=96, seed=0)


def test_fixture_layout(fixture_root):
    assert os.path.exists(os.path.join(fixture_root,
                                       "synsetoffset2category.txt"))
    assert os.path.exists(os.path.join(
        fixture_root, "train_test_split", "shuffled_train_file_list.json"))


def test_splits_partition_dataset(fixture_root):
    sizes = {s: len(PartDataset(fixture_root, npoints=32, split=s))
             for s in ("train", "val", "test", "trainval")}
    assert sizes["trainval"] == sizes["train"] + sizes["val"]
    assert sizes["train"] + sizes["val"] + sizes["test"] == 36
    assert sizes["test"] > 0


def test_class_choice_filters(fixture_root):
    all_ds = PartDataset(fixture_root, npoints=32, split="trainval")
    chair = PartDataset(fixture_root, npoints=32, split="trainval",
                        class_choice=["Chair"])
    assert 0 < len(chair) < len(all_ds)
    with pytest.raises(ValueError):
        PartDataset(fixture_root, npoints=32, class_choice=["NotACategory"])


def test_getitem_contract(fixture_root):
    ds = PartDataset(fixture_root, npoints=48, split="train", seed=1)
    pts, seg = ds[0]
    assert pts.shape == (48, 3) and pts.dtype == np.float32
    assert seg.shape == (48,) and seg.dtype == np.int64
    assert seg.min() >= 0  # on-disk labels are 1-based; loader shifts to 0
    assert np.max(np.linalg.norm(pts - pts.mean(0), axis=1)) <= 1.5
    pts2, _ = ds[0]
    assert not np.array_equal(pts, pts2)


@pytest.mark.parametrize("mode", [
    dict(), dict(classification=True), dict(normalize=False)])
def test_items_equal_the_jax_package(fixture_root, mode):
    """Every item of each split, in each mode, equals the JAX package's
    for the same seed, and so do ``classes`` and ``num_seg_classes``."""
    for split in ("train", "test"):
        ours = PartDataset(fixture_root, npoints=40, split=split, seed=3,
                           **mode)
        theirs = jshapenet.PartDataset(fixture_root, npoints=40,
                                       split=split, seed=3, **mode)
        assert ours.classes == theirs.classes
        assert ours.num_seg_classes == theirs.num_seg_classes
        assert len(ours) == len(theirs) > 0
        for i in range(len(ours)):
            for a, b in zip(ours[i], theirs[i]):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)


def test_classes_and_seg_classes(fixture_root):
    ds = PartDataset(fixture_root, npoints=16, split="trainval")
    assert sorted(ds.classes.values()) == list(range(len(ds.cat)))
    assert ds.num_seg_classes > 0
    cls = PartDataset(fixture_root, npoints=16, split="trainval",
                      classification=True)
    assert cls.num_seg_classes == 0


def test_empty_split_is_usable(tmp_path):
    root = synthetic.write_fixture(str(tmp_path / "tiny"),
                                   shapes_per_category=2,
                                   points_per_shape=16, seed=0)
    ds = PartDataset(root, npoints=8, split="val")  # both shapes -> train
    assert len(ds) == 0
    assert ds.num_seg_classes == 0


def test_missing_dataset_root_helpful_error(tmp_path):
    with pytest.raises(FileNotFoundError, match="data_path|fixture"):
        PartDataset(str(tmp_path / "nope"), npoints=8)


def test_normalize_false_preserves_raw_coordinates(fixture_root):
    raw = PartDataset(fixture_root, npoints=32, split="train",
                      normalize=False, seed=0)
    pts, _, _ = raw._load(0)
    assert np.max(np.linalg.norm(pts - pts.mean(0), axis=1)) != \
        pytest.approx(1.0, rel=1e-3)
    _, pts_path, _ = raw.datapath[0]
    np.testing.assert_array_equal(pts, fastio.load_pts(pts_path))


def test_classification_mode(fixture_root):
    ds = PartDataset(fixture_root, npoints=16, split="train",
                     classification=True)
    pts, cls = ds[0]
    assert pts.shape == (16, 3)
    assert cls.shape == (1,) and cls.dtype == np.int32
    assert int(cls[0]) == ds.classes[ds.datapath[0][0]]


def test_pc_normalize():
    rng = np.random.RandomState(0)
    pc = rng.randn(100, 3) * 7 + 3
    out = pc_normalize(pc)
    np.testing.assert_allclose(out.mean(0), 0, atol=1e-6)
    np.testing.assert_allclose(np.max(np.linalg.norm(out, axis=1)), 1.0,
                               rtol=1e-6)


def test_rotation_preserves_norms_and_y():
    rng = np.random.RandomState(0)
    batch = rng.randn(4, 50, 3).astype(np.float32)
    rot = rotate_point_cloud(batch, np.random.default_rng(0))
    np.testing.assert_allclose(rot[..., 1], batch[..., 1], atol=1e-5)
    np.testing.assert_allclose(
        np.hypot(rot[..., 0], rot[..., 2]),
        np.hypot(batch[..., 0], batch[..., 2]), atol=1e-4)
    assert not np.allclose(rot[0] - batch[0], rot[1] - batch[1])


def test_native_fastio_matches_numpy(fixture_root, tmp_path):
    """The native parse against np.loadtxt (rtol 1e-6, as the JAX test;
    bit-equal on the fixture), and against the JAX package's parser,
    with blank lines, trailing whitespace and scientific notation."""
    assert fastio.native_available()
    ds = PartDataset(fixture_root, npoints=16, split="train")
    for _, pts_path, seg_path in ds.datapath:
        pts = fastio.load_pts(pts_path)
        np.testing.assert_allclose(
            pts, np.loadtxt(pts_path).astype(np.float32).reshape(-1, 3),
            rtol=1e-6)
        np.testing.assert_array_equal(pts, fastio.load_pts_numpy(pts_path))
        np.testing.assert_array_equal(pts, jfastio.load_pts(pts_path))
        seg = fastio.load_seg(seg_path)
        assert seg.dtype == np.int64
        np.testing.assert_array_equal(seg, np.loadtxt(seg_path)
                                      .astype(np.int64))
        np.testing.assert_array_equal(seg, fastio.load_seg_numpy(seg_path))
    p = tmp_path / "odd.pts"
    p.write_text("1.0 2.0 3e-1\n\n  4.5\t5.5 6.5  \n")
    want = np.array([[1.0, 2.0, 0.3], [4.5, 5.5, 6.5]], np.float32)
    np.testing.assert_allclose(fastio.load_pts(str(p)), want)
    np.testing.assert_allclose(fastio.load_pts_numpy(str(p)), want)


@pytest.mark.parametrize("load", ["load_pts", "load_pts_numpy"])
def test_load_pts_rejects_wrong_column_count(tmp_path, load):
    """A 6-column .pts (xyz and normals) raises the reference's message on
    the native and the numpy path, as the JAX package does; the port
    returned 4 interleaved fake points before (ROADMAP F1)."""
    p = tmp_path / "normals.pts"
    p.write_text("1 2 3 0.1 0.2 0.3\n4 5 6 0.4 0.5 0.6\n")
    with pytest.raises(ValueError, match="expected 3 columns, found 6"):
        jfastio.load_pts(str(p))
    with pytest.raises(ValueError, match="expected 3 columns, found 6"):
        getattr(fastio, load)(str(p))


@pytest.mark.parametrize("load", ["load_seg", "load_seg_numpy"])
def test_load_seg_rejects_wrong_column_count(tmp_path, load):
    """A label file with a confidence column raises on both paths; the
    port returned a 2-D int array before (ROADMAP F1)."""
    p = tmp_path / "twocol.seg"
    p.write_text("1 0.9\n2 0.8\n")
    with pytest.raises(ValueError, match="expected 1 columns, found 2"):
        jfastio.load_seg(str(p))
    with pytest.raises(ValueError, match="expected 1 columns, found 2"):
        getattr(fastio, load)(str(p))


@pytest.mark.parametrize("load", ["load_pts", "load_pts_numpy"])
def test_load_pts_rejects_a_ragged_value_count(tmp_path, load):
    """3 columns on the first line, 5 values in all: not points."""
    p = tmp_path / "ragged.pts"
    p.write_text("1 2 3\n4 5\n")
    with pytest.raises(ValueError):
        getattr(fastio, load)(str(p))


def test_dataset_rejects_a_bad_file_and_caches_nothing(fixture_root,
                                                       tmp_path):
    """A shape whose .pts has normals fails at its first access, and the
    on-disk cache stores nothing for it."""
    import shutil

    root = str(tmp_path / "fix")
    shutil.copytree(fixture_root, root)
    cache = str(tmp_path / "cache")
    ds = PartDataset(root, npoints=8, split="train", seed=0,
                     cache_dir=cache)
    _, pts_path, _ = ds.datapath[0]
    pts = np.loadtxt(pts_path)
    np.savetxt(pts_path, np.concatenate([pts, pts], axis=1))
    with pytest.raises(ValueError, match="expected 3 columns, found 6"):
        ds[0]
    assert os.listdir(cache) == []


def test_pipeline_batches(fixture_root):
    ds = PartDataset(fixture_root, npoints=32, split="trainval", seed=0)
    pipe = BatchPipeline(ds, batch_size=8, rotate=True, seed=0)
    batches = list(pipe.epoch())
    assert len(batches) == len(ds) // 8 == len(pipe)
    assert all(b.shape == (8, 32, 3) for b in batches)
    assert batches[0].dtype == torch.float32
    b2 = list(pipe.epoch())
    assert not torch.allclose(batches[0], b2[0])


def test_pipeline_eval_mode_deterministic_order(fixture_root):
    ds = PartDataset(fixture_root, npoints=32, split="test", seed=7)
    pipe = BatchPipeline(ds, batch_size=4, rotate=False, shuffle=False)
    assert len(list(pipe.epoch())) == len(ds) // 4


def test_pipeline_propagates_producer_errors(fixture_root):
    ds = PartDataset(fixture_root, npoints=32, split="trainval", seed=0)

    class Exploding:
        npoints = ds.npoints

        def __len__(self):
            return len(ds)

        def __getitem__(self, i):
            if i >= 8:
                raise IOError("corrupt shape")
            return ds[i]

    pipe = BatchPipeline(Exploding(), batch_size=8, shuffle=False,
                         rotate=False)
    it = pipe.epoch()
    next(it)
    with pytest.raises(IOError, match="corrupt shape"):
        for _ in it:
            pass


def test_disk_cache_round_trip(fixture_root, tmp_path):
    cache = str(tmp_path / "cache")
    cold = PartDataset(fixture_root, npoints=32, split="train", seed=0,
                       cache_dir=cache)
    ref = PartDataset(fixture_root, npoints=32, split="train", seed=0)
    pts_a, seg_a, _ = cold._load(0)
    entries = os.listdir(cache)
    assert len(entries) == 1 and entries[0].endswith(".npz")
    warm = PartDataset(fixture_root, npoints=32, split="train", seed=0,
                       cache_dir=cache)
    pts_b, seg_b, _ = warm._load(0)
    pts_r, seg_r, _ = ref._load(0)
    for a, b in ((pts_a, pts_b), (seg_a, seg_b), (pts_a, pts_r),
                 (seg_a, seg_r)):
        np.testing.assert_array_equal(a, b)


def test_disk_cache_invalidated_by_source_mtime(tmp_path):
    root = synthetic.write_fixture(str(tmp_path / "fix"),
                                   shapes_per_category=2,
                                   points_per_shape=16, seed=0)
    cache = str(tmp_path / "cache")
    ds = PartDataset(root, npoints=8, split="train", seed=0,
                     cache_dir=cache)
    _, pts_path, seg_path = ds.datapath[0]
    ds._load(0)
    cpath = ds._disk_cache_path(pts_path)
    assert os.path.exists(cpath)
    with open(pts_path, "w") as f:
        f.write("9 9 9\n8 8 8\n")
    future = os.path.getmtime(cpath) + 10
    os.utime(pts_path, (future, future))
    ds2 = PartDataset(root, npoints=8, split="train", seed=0,
                      cache_dir=cache)
    pts, _ = ds2._decode(pts_path, seg_path)
    assert pts.shape[0] == 2 and pts[0, 0] == 9.0


def test_disk_cache_keys_on_source_path(tmp_path):
    root_a = synthetic.write_fixture(str(tmp_path / "a"),
                                     shapes_per_category=2,
                                     points_per_shape=16, seed=1)
    root_b = synthetic.write_fixture(str(tmp_path / "b"),
                                     shapes_per_category=2,
                                     points_per_shape=16, seed=2)
    cache = str(tmp_path / "cache")
    ds_a = PartDataset(root_a, npoints=8, split="train", seed=0,
                       cache_dir=cache)
    ds_b = PartDataset(root_b, npoints=8, split="train", seed=0,
                       cache_dir=cache)
    _, pa, sa = ds_a.datapath[0]
    _, pb, sb = ds_b.datapath[0]
    assert os.path.basename(pa) == os.path.basename(pb)
    pts_a, _ = ds_a._decode(pa, sa)
    future = os.path.getmtime(pb) + 10
    os.utime(ds_a._disk_cache_path(pa), (future, future))
    pts_b, _ = ds_b._decode(pb, sb)
    pts_ref, _ = PartDataset(root_b, npoints=8, split="train",
                             seed=0)._decode(pb, sb)
    np.testing.assert_array_equal(pts_b, pts_ref)
    assert not np.array_equal(pts_a, pts_b)


def test_disk_cache_corrupt_entry_falls_through(fixture_root, tmp_path):
    cache = str(tmp_path / "cache")
    ds = PartDataset(fixture_root, npoints=32, split="train", seed=0,
                     cache_dir=cache)
    _, pts_path, seg_path = ds.datapath[0]
    pts_good, seg_good = ds._decode(pts_path, seg_path)
    cpath = ds._disk_cache_path(pts_path)
    with open(cpath, "wb") as f:
        f.write(b"not an npz")
    os.utime(cpath, None)
    pts, seg = ds._decode(pts_path, seg_path)
    np.testing.assert_array_equal(pts, pts_good)
    np.testing.assert_array_equal(seg, seg_good)


def test_cache_dir_cli_flag_reaches_config():
    args = cli_train.build_parser().parse_args(["--cache_dir", "/tmp/c"])
    assert cli_train.config_from_args(args).cache_dir == "/tmp/c"
    assert cli_train.config_from_args(
        cli_train.build_parser().parse_args([])).cache_dir is None


def test_pipeline_abandoned_epoch_stops_producer(fixture_root):
    ds = PartDataset(fixture_root, npoints=32, split="trainval", seed=0)
    pipe = BatchPipeline(ds, batch_size=1, seed=0)
    assert len(pipe) > 3
    it = pipe.epoch()
    next(it)
    it.close()
    deadline = time.monotonic() + 5.0
    while time.monotonic() < deadline:
        alive = [t for t in threading.enumerate()
                 if t.name == "pcae-torch-pipeline-producer"
                 and t.is_alive()]
        if not alive:
            break
        time.sleep(0.05)
    assert not alive
