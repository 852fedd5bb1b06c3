"""The port's reference-checkpoint import, reference-named export and
serving bundles (tf_import.py, InferenceSession.export_bundle/from_bundle,
cli/export.py, cli/import_tf.py) against the JAX package, on the CPU.

Every family's weights start as perturbed JAX variables, moved to the
port by ``convert.from_flax_variables``. Held:
- the port's ``export_reference_arrays`` equals the JAX package's, key
  for key and bit for bit;
- round trips: the port's export (a serving bundle's ``variables.npz``)
  imported by the JAX package, and the JAX package's ``reference_npz``
  imported by the port, each served by the other side's eval forward
  within the eval-forward tolerance of tests/test_torch_families.py
  (rtol 1e-4, atol 1e-5);
- a port export imported by the port is the same state_dict, bit for
  bit, and a bundle reconstructs bit-equal to the weights it came from;
- a real TF Saver checkpoint with Adam slots imports (where tensorflow
  imports, as tests/test_tf_import.py).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu import tf_import as jtf
from pointnet_autoencoder_tpu.models.registry import get_model_spec as jspec
from pointnet_autoencoder_tpu_torch import tf_import
from pointnet_autoencoder_tpu_torch.cli import export as cli_export
from pointnet_autoencoder_tpu_torch.cli import import_tf as cli_import
from pointnet_autoencoder_tpu_torch.convert import from_flax_variables
from pointnet_autoencoder_tpu_torch.inference import InferenceSession
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec

torch.set_num_threads(2)

BATCH = 2
# family -> (num_point, input points per cloud); the upconv decoders
# always emit 2048 points.
SIZES = {
    "model": (64, 64),
    "model_emd": (64, 64),
    "model_cpu": (64, 64),
    "model_hierachy": (128, 128),
    "model_upconv": (2048, 128),
    "model_fc_upconv": (2048, 128),
}
FAMILIES = sorted(SIZES)
FWD_TOL = dict(rtol=1e-4, atol=1e-5)


def _perturbed(variables, seed=0):
    """BN parameters, statistics and biases moved off their init values
    (a quarter of the gammas negative)."""
    rng = np.random.RandomState(seed)

    def perturb(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "gamma":
            return (a * np.where(rng.rand(*a.shape) < 0.25, -1, 1)
                    * (1 + 0.2 * rng.rand(*a.shape))).astype(np.float32)
        if name == "var":
            return (a + 0.5 * rng.rand(*a.shape)).astype(np.float32)
        if a.ndim == 1:
            return (a + 0.1 * rng.randn(*a.shape)).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))


@pytest.fixture(scope="module")
def reference():
    """family -> (flax module, perturbed variables)."""
    out = {}
    for name in FAMILIES:
        module = jspec(name).make(SIZES[name][0])
        variables = jax.jit(lambda key, x: module.init(
            key, x, train=False, bn_momentum=0.9))(
                jax.random.PRNGKey(1), jnp.zeros((2, SIZES[name][0], 3)))
        out[name] = module, _perturbed(variables)
    return out


def _clouds(name, seed=0):
    return np.random.RandomState(seed).randn(
        BATCH, SIZES[name][1], 3).astype(np.float32)


def _port_forward(name, state_dict, pts):
    model = get_model_spec(name).make(SIZES[name][0])
    model.load_state_dict(state_dict)
    with torch.inference_mode():
        pred, _ = model(torch.from_numpy(pts))
    return pred.numpy()


def _jax_forward(module, variables, pts):
    pred, _ = module.apply(variables, jnp.asarray(pts), train=False,
                           bn_momentum=0.0)
    return np.asarray(pred)


@pytest.mark.parametrize("name", FAMILIES)
def test_export_equals_the_jax_export(reference, name):
    _, variables = reference[name]
    ours = tf_import.export_reference_arrays(from_flax_variables(variables))
    theirs = jtf.export_reference_arrays(variables)
    assert sorted(ours) == sorted(theirs)
    for key, want in theirs.items():
        assert ours[key].dtype == want.dtype == np.float32, key
        assert ours[key].shape == want.shape, key
        np.testing.assert_array_equal(ours[key], want, err_msg=key)


@pytest.mark.parametrize("name", FAMILIES)
def test_port_bundle_imports_into_jax_and_serves_alike(reference, name,
                                                       tmp_path):
    """Port export (a serving bundle's variables.npz) -> the JAX package's
    import_reference_checkpoint -> JAX eval forward, held to the port's
    forward on the same weights."""
    module, variables = reference[name]
    sd = from_flax_variables(variables)
    bundle = tf_import.write_bundle(str(tmp_path / "bundle"), name,
                                    SIZES[name][0], sd)
    tree, report = jtf.import_reference_checkpoint(
        name, os.path.join(bundle, tf_import.BUNDLE_VARIABLES),
        SIZES[name][0])
    assert report["unmapped"] == [] and report["mapped"] == len(sd)
    pts = _clouds(name, seed=1)
    np.testing.assert_allclose(_jax_forward(module, tree, pts),
                               _port_forward(name, sd, pts), **FWD_TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_jax_reference_npz_imports_into_the_port(reference, name, tmp_path):
    """The JAX package's reference_npz -> the port's import -> port eval
    forward, held to the JAX forward of the original variables."""
    module, variables = reference[name]
    path = str(tmp_path / "w.npz")
    np.savez(path, **jtf.export_reference_arrays(variables))
    sd, report = tf_import.import_reference_checkpoint(
        name, path, SIZES[name][0])
    assert report == {"model": name, "num_point": SIZES[name][0],
                      "mapped": len(sd), "skipped_optimizer_state": 0,
                      "unmapped": []}
    pts = _clouds(name, seed=2)
    np.testing.assert_allclose(_port_forward(name, sd, pts),
                               _jax_forward(module, variables, pts),
                               **FWD_TOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_export_then_import_is_the_same_state_dict(reference, name,
                                                   tmp_path):
    sd = from_flax_variables(reference[name][1])
    path = str(tmp_path / "w.npz")
    np.savez(path, **tf_import.export_reference_arrays(sd))
    back, _ = tf_import.import_reference_checkpoint(name, path,
                                                    SIZES[name][0])
    assert sorted(back) == sorted(sd)
    for k in sd:
        assert torch.equal(back[k], sd[k]), k


def test_bundle_and_npz_sessions_reconstruct_bit_equal(reference, tmp_path):
    sd = from_flax_variables(reference["model"][1])
    torch.save(sd, str(tmp_path / "w.pt"))
    plain = InferenceSession("model", str(tmp_path / "w.pt"), 64,
                             batch_size=BATCH, device="cpu")
    bundle = plain.export_bundle(str(tmp_path / "bundle"))
    with open(os.path.join(bundle, tf_import.BUNDLE_META)) as f:
        assert json.load(f) == {"format": "pcae-torch-bundle-v1",
                                "model": "model", "num_point": 64}
    served = InferenceSession.from_bundle(bundle, batch_size=BATCH,
                                          device="cpu")
    assert served.model_name == "model" and served.num_point == 64
    pts = np.random.RandomState(3).randn(3, 64, 3).astype(np.float32)
    np.testing.assert_array_equal(served.reconstruct(pts),
                                  plain.reconstruct(pts))
    # A bundle directory is a model_path too.
    again = InferenceSession("model", bundle, 64, batch_size=BATCH,
                             device="cpu")
    np.testing.assert_array_equal(again.reconstruct(pts),
                                  plain.reconstruct(pts))


def test_a_jax_orbax_bundle_names_the_route_that_works(reference, tmp_path):
    path = str(tmp_path / "w.npz")
    np.savez(path, **jtf.export_reference_arrays(reference["model"][1]))
    jtf.import_reference_checkpoint("model", path, 64,
                                    out_dir=str(tmp_path / "jax_bundle"))
    with pytest.raises(ValueError, match="cli.export --format reference_npz"):
        InferenceSession.from_bundle(str(tmp_path / "jax_bundle"),
                                     device="cpu")
    with pytest.raises(ValueError, match="orbax"):
        InferenceSession("model", str(tmp_path / "jax_bundle"), 64,
                         device="cpu")


def _reference_with_optimizer_state(sd, seed=6):
    """Reference-named arrays of ``sd`` plus Adam slots and bookkeeping, as
    in a reference training checkpoint (tests/test_tf_import.py)."""
    rng = np.random.RandomState(seed)
    v = tf_import.export_reference_arrays(sd)
    out = dict(v)
    for name, val in v.items():
        if "moving_" not in name:
            out[name + "/Adam"] = (rng.randn(*val.shape) * 0.01).astype(
                np.float32)
            out[name + "/Adam_1"] = np.abs(rng.randn(*val.shape) * 0.01
                                           ).astype(np.float32)
    out["batch"] = np.asarray(12345, np.int64)
    out["beta1_power"] = np.asarray(0.5, np.float32)
    out["beta2_power"] = np.asarray(0.9, np.float32)
    return v, out


def test_real_tf_saver_checkpoint_imports(reference, tmp_path):
    tf = pytest.importorskip("tensorflow")
    sd = from_flax_variables(reference["model"][1])
    v, full = _reference_with_optimizer_state(sd)
    with tf.Graph().as_default():
        tvars = {name: tf.compat.v1.get_variable(
            f"v{i}", initializer=tf.constant(val))
            for i, (name, val) in enumerate(full.items())}
        saver = tf.compat.v1.train.Saver(var_list=tvars)
        with tf.compat.v1.Session() as sess:
            sess.run(tf.compat.v1.global_variables_initializer())
            prefix = saver.save(sess, str(tmp_path / "model.ckpt"))
    got, report = tf_import.import_reference_checkpoint("model", prefix, 64)
    assert report["unmapped"] == [] and report["mapped"] == len(v)
    assert report["skipped_optimizer_state"] == len(full) - len(v)
    # The JAX package reads the same checkpoint the same way.
    _, jreport = jtf.import_reference_checkpoint("model", prefix, 64)
    assert {k: jreport[k] for k in report} == report
    for k in sd:
        assert torch.equal(got[k], sd[k]), k


def test_optimizer_state_is_skipped_and_classified_as_jax(reference,
                                                          tmp_path):
    sd = from_flax_variables(reference["model"][1])
    v, full = _reference_with_optimizer_state(sd)
    full["fc9/weights"] = np.zeros((2, 2), np.float32)
    names = sorted(set(full) - set(v))
    assert tf_import.classify_skipped(names) == jtf.classify_skipped(names)
    path = str(tmp_path / "ref.npz")
    # '__' encodes the scope separator as well as '/'.
    np.savez(path, **{k.replace("/", "__"): a for k, a in full.items()})
    get, got_names = tf_import.open_checkpoint(path)
    jget, jnames = jtf.open_checkpoint(path)
    assert got_names == jnames
    np.testing.assert_array_equal(get("fc1/bn/gamma"), jget("fc1/bn/gamma"))
    with pytest.raises(tf_import.TFImportError, match="fc9/weights"):
        tf_import.import_reference_checkpoint("model", path, 64)
    _, report = tf_import.import_reference_checkpoint("model", path, 64,
                                                      strict=False)
    assert report["unmapped"] == ["fc9/weights"]
    assert report["skipped_optimizer_state"] == len(full) - len(v) - 1


def test_missing_and_misshapen_variables_and_wrong_family(reference,
                                                         tmp_path):
    sd = from_flax_variables(reference["model"][1])
    v = tf_import.export_reference_arrays(sd)
    missing = dict(v)
    del missing["fc2/weights"]
    np.savez(str(tmp_path / "a.npz"), **missing)
    with pytest.raises(tf_import.TFImportError, match="fc2/weights"):
        tf_import.import_reference_checkpoint("model",
                                              str(tmp_path / "a.npz"), 64)
    # The same weights at another num_point: fc3 holds 64 * 3 outputs.
    np.savez(str(tmp_path / "b.npz"), **v)
    with pytest.raises(tf_import.TFImportError, match="fc3/.* != expected"):
        tf_import.import_reference_checkpoint("model",
                                              str(tmp_path / "b.npz"), 128)
    up = tf_import.export_reference_arrays(
        from_flax_variables(reference["model_upconv"][1]))
    np.savez(str(tmp_path / "c.npz"), **up)
    with pytest.raises(tf_import.TFImportError):
        tf_import.import_reference_checkpoint("model",
                                              str(tmp_path / "c.npz"), 64)


def test_export_and_import_clis(reference, tmp_path, capsys):
    """cli.export of a training-style .pt in both formats, cli.import_tf's
    dry run and --out: every route serves the same reconstruction."""
    sd = from_flax_variables(reference["model_hierachy"][1])
    pt = str(tmp_path / "w.pt")
    torch.save(sd, pt)
    base = ["--model", "model_hierachy", "--model_path", pt, "--num_point",
            "128", "--device", "cpu"]
    npz = cli_export.main(base + ["--out", str(tmp_path / "ref"),
                                  "--format", "reference_npz"])
    assert npz.endswith("ref.npz")
    bundle = cli_export.main(base + ["--out", str(tmp_path / "bundle")])
    imp = ["--model", "model_hierachy", "--tf_checkpoint", npz,
           "--num_point", "128"]
    dry = cli_import.main(imp)
    assert "bundle" not in dry and dry["unmapped"] == []
    assert not os.path.exists(tmp_path / "imported")
    report = cli_import.main(imp + ["--out", str(tmp_path / "imported")])
    assert report["bundle"] == str(tmp_path / "imported")
    out = capsys.readouterr().out
    assert "reference-named weights (" in out and '"unmapped": []' in out
    with open(tmp_path / "imported" / tf_import.BUNDLE_META) as f:
        meta = json.load(f)
    assert meta["imported_from"] == npz and meta["num_point"] == 128
    pts = np.random.RandomState(4).randn(2, 128, 3).astype(np.float32)
    want = InferenceSession("model_hierachy", pt, 128,
                            device="cpu").reconstruct(pts)
    for path in (npz, bundle, str(tmp_path / "imported")):
        got = (InferenceSession.from_bundle(path, device="cpu")
               if os.path.isdir(path) else
               InferenceSession("model_hierachy", path, 128, device="cpu"))
        np.testing.assert_array_equal(got.reconstruct(pts), want)


def test_cli_parsers_have_the_jax_flags():
    from pointnet_autoencoder_tpu.cli import export as jexport
    from pointnet_autoencoder_tpu.cli import import_tf as jimport

    ours = {a.dest for a in cli_export.build_parser()._actions}
    assert ours == {a.dest for a in jexport.build_parser()._actions} | {
        "device"}
    ours = {a.dest for a in cli_import.build_parser()._actions}
    assert ours == {a.dest for a in jimport.build_parser()._actions}
    args = cli_export.build_parser().parse_args(
        ["--model_path", "x", "--out", "y"])
    assert args.device == "cuda" and args.format == "bundle"
