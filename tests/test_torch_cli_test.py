"""The port's test entry point (cli/test.py) against the JAX package's
cli.test on one fixture, seed and set of weights, on the CPU.

Held: the same printed lines (dataset size, one line per shape, the
means, the render directory), the same shape order, per-shape Chamfer
within rtol 1e-5 of the JAX package's, the same render files, and
ground-truth and reconstruction images within the native-vs-numpy
tolerance of tests/test_viz.py (fewer than 1% of pixels off by more than
2). Weights: perturbed JAX variables, given to the JAX side as a bundle
that its cli.import_tf writes and to the port as the reference-named .npz
it came from.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from pointnet_autoencoder_tpu import inference as jinference
from pointnet_autoencoder_tpu import tf_import as jtf
from pointnet_autoencoder_tpu.cli import test as jcli
from pointnet_autoencoder_tpu.models.registry import get_model_spec as jspec
from pointnet_autoencoder_tpu_torch.cli import test as cli
from pointnet_autoencoder_tpu_torch.data import synthetic

torch.set_num_threads(2)

SHAPES = 4
# model: 64 points; model_hierachy: its 128 points in 4 groups of 32 (the
# --num_group use), model_cpu with groups that do not divide num_point.
CASES = {"model": (64, 4), "model_hierachy": (128, 4), "model_cpu": (64, 3)}


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data") / "fixture")
    return synthetic.write_fixture(root, 40, 128, categories=["Chair"])


def _weights(name, num_point, root):
    """(the JAX bundle, the reference-named .npz) of perturbed weights."""
    module = jspec(name).make(num_point)
    variables = jax.device_get(module.init(
        jax.random.PRNGKey(3), jnp.zeros((2, num_point, 3)), train=False,
        bn_momentum=0.9))
    rng = np.random.RandomState(4)
    variables = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) + 0.05 * rng.rand(*np.shape(a))).astype(
            np.float32) if np.ndim(a) == 1 else np.asarray(a), variables)
    npz = os.path.join(root, f"{name}.npz")
    np.savez(npz, **jtf.export_reference_arrays(variables))
    bundle = os.path.join(root, f"{name}_bundle")
    jtf.import_reference_checkpoint(name, npz, num_point, out_dir=bundle)
    return bundle, npz


def _run_both(name, fixture_root, tmp_path, capsys, monkeypatch):
    num_point, groups = CASES[name]
    bundle, npz = _weights(name, num_point, str(tmp_path))
    common = ["--model", name, "--category", "Chair", "--num_point",
              str(num_point), "--data_path", fixture_root, "--num_shapes",
              str(SHAPES), "--num_group", str(groups), "--fscore_threshold",
              "0.01", "--seed", "5"]
    jax_cd = []
    real = jinference.InferenceSession.chamfer

    def recording(self, pred, target):
        out = real(self, pred, target)
        jax_cd.extend(np.asarray(out).tolist())
        return out

    monkeypatch.setattr(jinference.InferenceSession, "chamfer", recording)
    capsys.readouterr()
    assert jcli.main(common + ["--model_path", bundle, "--out_dir",
                               str(tmp_path / "jax")]) == 0
    jax_out = capsys.readouterr().out
    ours = cli.main(common + ["--model_path", npz, "--out_dir",
                              str(tmp_path / "port"), "--device", "cpu"])
    port_out = capsys.readouterr().out
    return ours, port_out, jax_cd, jax_out


def _skeleton(text):
    """The printed lines with every number and path blanked."""
    lines = [re.sub(r"-?\d+\.\d+", "#", line) for line in text.splitlines()
             if line.strip()]
    return [re.sub(r"written to .*", "written to <dir>", line)
            for line in lines]


@pytest.mark.parametrize("name", sorted(CASES))
def test_port_and_jax_cli_test_agree(name, fixture_root, tmp_path, capsys,
                                     monkeypatch):
    ours, port_out, jax_cd, jax_out = _run_both(name, fixture_root, tmp_path,
                                                capsys, monkeypatch)
    assert _skeleton(port_out) == _skeleton(jax_out)
    assert port_out.splitlines()[0] == jax_out.splitlines()[0]
    assert len(ours["chamfer"]) == len(jax_cd) == SHAPES
    np.testing.assert_allclose(ours["chamfer"], jax_cd, rtol=1e-5)
    assert all(0.0 <= f <= 1.0 for f in ours["fscore"])
    files = sorted(os.listdir(tmp_path / "port"))
    assert files == sorted(os.listdir(tmp_path / "jax"))
    assert len(files) == 3 * SHAPES
    for f in files:
        a = np.asarray(Image.open(tmp_path / "port" / f)).astype(int)
        b = np.asarray(Image.open(tmp_path / "jax" / f)).astype(int)
        assert a.shape == b.shape == (800, 800, 3), f
        assert (np.abs(a - b) > 2).mean() < 0.01, f


def test_defaults_and_refusals(fixture_root, tmp_path, capsys):
    """Renders default to <model_path dir>/renders; num_group 1 writes no
    group image; --compilation_cache_dir is refused; --device defaults to
    the card."""
    _, npz = _weights("model", 64, str(tmp_path))
    argv = ["--model_path", npz, "--num_point", "64", "--category", "Chair",
            "--data_path", fixture_root, "--num_shapes", "2"]
    out = cli.main(argv + ["--device", "cpu"])
    assert out["out_dir"] == str(tmp_path / "renders")
    assert out["fscore"] is None and len(out["chamfer"]) == 2
    assert sorted(os.listdir(tmp_path / "renders")) == [
        "0000_gt.png", "0000_pred.png", "0001_gt.png", "0001_pred.png"]
    assert "shape 1: chamfer " in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="compilation_cache_dir"):
        cli.main(argv + ["--compilation_cache_dir", str(tmp_path / "c")])
    ours = {a.dest for a in cli.build_parser()._actions}
    assert ours == {a.dest for a in jcli.build_parser()._actions} | {
        "device"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            cli.main(argv)
