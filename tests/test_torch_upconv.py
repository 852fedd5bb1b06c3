"""The port's UpConv (nn/layers.py) and its weight moves against the JAX
package's UpConv and against TF's conv2d_transpose, on the CPU in f32:

- the output geometry of every stage of both upconv decoders, (in-1)*s+k,
  equal to the JAX layer's in*s + max(k-s, 0) where k >= s, and refused
  where k < s;
- the eval forward and the train forward (output and new BN statistics)
  against JAX's UpConv, with the kernel moved by from_flax_variables (flip
  both spatial axes, then (cin, cout, kh, kw)) and by the reference-named
  archive of export_reference_arrays (permute only); a kernel moved
  without the flip must fail the same check;
- the archive route against a numpy scatter of TF's conv2d_transpose, whose
  kernel is (kh, kw, cout, cin).

Tolerances: rtol 1e-5, atol 1e-6 (one product and one BN affine per output
in f32; the two sides sum each output's kh*kw*cin products in different
orders); BN statistics rtol 1e-5, atol 1e-6, as tests/test_torch_train.py
holds training BN.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointnet_autoencoder_tpu.nn.decoders import (FCUpconvDecoder as
                                                  JFCUpconvDecoder)
from pointnet_autoencoder_tpu.nn.decoders import UpconvDecoder as JUpconv
from pointnet_autoencoder_tpu.nn.layers import UpConv as JUpConv
from pointnet_autoencoder_tpu.tf_import import export_reference_arrays
from pointnet_autoencoder_tpu_torch.convert import (from_flax_variables,
                                                    from_reference_arrays)
from pointnet_autoencoder_tpu_torch.nn.decoders import (FCUpconvDecoder,
                                                        UpconvDecoder)
from pointnet_autoencoder_tpu_torch.nn.layers import UpConv

torch.set_num_threads(2)

TOL = dict(rtol=1e-5, atol=1e-6)

# Every stage of both decoders: (input (h, w), cin, cout, kernel, stride),
# the maps growing (1,2)->(2,4)->(4,6)->(10,20)->(32,64) and
# (1,1)->(2,2)->(4,4)->(10,10)->(32,32), then the 1x1 xyz heads.
STAGES = []
for jdec, first, cin in ((JUpconv, (1, 2), 512), (JFCUpconvDecoder, (1, 1),
                                                  512)):
    hw = first
    for f, k, s in jdec._STAGES + ((3, (1, 1), (1, 1)),):
        STAGES.append((hw, cin, f, k, s))
        hw = tuple((n - 1) * st + kk for n, kk, st in zip(hw, k, s))
        cin = f


def _layer_tree(stage, seed):
    """A JAX UpConv at ``stage`` (channels cut to at most 8, so a stage
    runs in milliseconds), its perturbed variables and an input batch."""
    (h, w), cin, cout, k, s = stage
    cin, cout = min(cin, 8), min(cout, 8)
    rng = np.random.RandomState(seed)
    x = rng.randn(2, h, w, cin).astype(np.float32)
    jmod = JUpConv(cout, k, s)
    variables = jax.device_get(jmod.init(jax.random.PRNGKey(seed), x,
                                         train=False))
    params = dict(variables["params"])
    params["convt"] = {"kernel": np.asarray(params["convt"]["kernel"]),
                       "bias": rng.randn(cout).astype(np.float32) * 0.1}
    params["bn"] = {"gamma": (1 + 0.2 * rng.rand(cout)).astype(np.float32),
                    "beta": (0.1 * rng.randn(cout)).astype(np.float32)}
    stats = {"bn": {"mean": (0.1 * rng.randn(cout)).astype(np.float32),
                    "var": (1 + 0.5 * rng.rand(cout)).astype(np.float32)}}
    return jmod, {"params": params, "batch_stats": stats}, x


def _port_layer(variables, route, cin, cout, k, s, flip=True):
    """The port's UpConv with the JAX layer's weights, moved by ``route``
    as the layer ``decoder.upconv1`` of a model tree."""
    tree = {"params": {"decoder": {"upconv1": variables["params"]}},
            "batch_stats": {"decoder": {"upconv1": variables["batch_stats"]}}}
    if not flip:
        kernel = tree["params"]["decoder"]["upconv1"]["convt"]["kernel"]
        tree["params"]["decoder"]["upconv1"]["convt"]["kernel"] = \
            np.ascontiguousarray(kernel[::-1, ::-1])
    sd = (from_flax_variables(tree) if route == "flax"
          else from_reference_arrays(export_reference_arrays(tree)))
    layer = UpConv(cin, cout, k, s)
    layer.load_state_dict({key[len("decoder.upconv1."):]: v
                           for key, v in sd.items()})
    return layer


@pytest.mark.parametrize("stage", STAGES, ids=lambda st: f"{st[0]}-{st[3]}-"
                         f"{st[4]}")
def test_stage_geometry_matches_jax(stage):
    (h, w), cin, cout, k, s = stage
    want = tuple((n - 1) * st + kk for n, kk, st in zip((h, w), k, s))
    assert want == tuple(n * st + max(kk - st, 0)
                         for n, kk, st in zip((h, w), k, s))
    jmod, variables, x = _layer_tree(stage, seed=0)
    jy = jmod.apply(variables, x, train=False)
    cin, cout = x.shape[-1], jy.shape[-1]
    y = UpConv(cin, cout, k, s)(torch.from_numpy(x))
    assert tuple(y.shape) == tuple(jy.shape) == (2,) + want + (cout,)


@pytest.mark.parametrize("route", ["flax", "npz"])
@pytest.mark.parametrize("stage", STAGES[:4] + STAGES[5:9],
                         ids=lambda st: f"{st[0]}-{st[3]}-{st[4]}")
def test_forward_and_bn_match_jax(stage, route):
    """Eval and train forward of one stage with both weight routes; a
    kernel moved without the flip fails the eval check."""
    _, _, _, k, s = stage
    jmod, variables, x = _layer_tree(stage, seed=1)
    cin, cout = x.shape[-1], np.shape(variables["params"]["bn"]["beta"])[0]
    layer = _port_layer(variables, route, cin, cout, k, s)
    want = np.asarray(jmod.apply(variables, x, train=False))
    with torch.no_grad():
        got = layer(torch.from_numpy(x), train=False).numpy()
    np.testing.assert_allclose(got, want, **TOL)

    want_t, mutated = jmod.apply(variables, x, train=True, bn_momentum=0.5,
                                 mutable=["batch_stats"])
    got_t = layer(torch.from_numpy(x), train=True, bn_momentum=0.5)
    np.testing.assert_allclose(got_t.detach().numpy(), np.asarray(want_t),
                               **TOL)
    for name in ("mean", "var"):
        np.testing.assert_allclose(
            getattr(layer.bn, name).numpy(),
            np.asarray(mutated["batch_stats"]["bn"][name]), err_msg=name,
            **TOL)

    if k != (1, 1):
        unflipped = _port_layer(variables, route, cin, cout, k, s, flip=False)
        with torch.no_grad():
            wrong = unflipped(torch.from_numpy(x), train=False).numpy()
        assert np.abs(wrong - want).max() > 1e-2


def _tf_conv2d_transpose(x, kernel, strides):
    """numpy scatter form of tf.nn.conv2d_transpose with VALID padding:
    x (B, H, W, cin), kernel (kh, kw, cout, cin) -> (B, (H-1)*sh+kh,
    (W-1)*sw+kw, cout), each input pixel adding its kernel at (y*sh,
    x*sw)."""
    b, h, w, _ = x.shape
    kh, kw, cout, _ = kernel.shape
    sh, sw = strides
    out = np.zeros((b, (h - 1) * sh + kh, (w - 1) * sw + kw, cout))
    for i in range(h):
        for j in range(w):
            out[:, i * sh:i * sh + kh, j * sw:j * sw + kw, :] += np.einsum(
                "bc,yxoc->byxo", x[:, i, j].astype(np.float64), kernel)
    return out


@pytest.mark.parametrize("k,s", [((4, 5), (2, 3)), ((5, 7), (3, 3)),
                                 ((2, 2), (1, 1))])
def test_reference_kernel_is_tf_conv2d_transpose(k, s):
    """A reference-named conv2d_transpose kernel (kh, kw, cout, cin),
    moved by from_reference_arrays with no flip, gives TF's op."""
    rng = np.random.RandomState(2)
    cin, cout = 5, 4
    kernel = rng.randn(k[0], k[1], cout, cin).astype(np.float32)
    bias = rng.randn(cout).astype(np.float32)
    x = rng.randn(2, 3, 4, cin).astype(np.float32)
    sd = from_reference_arrays({"upconv2/weights": kernel,
                                "upconv2/biases": bias})
    layer = UpConv(cin, cout, k, s, bn=False, relu=False)
    layer.load_state_dict({key[len("decoder.upconv2."):]: v
                           for key, v in sd.items()})
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, _tf_conv2d_transpose(x, kernel, s) + bias,
                               **TOL)


def test_upconv_refuses_kernel_smaller_than_stride():
    with pytest.raises(ValueError, match="kernel >= stride"):
        UpConv(4, 4, (2, 2), (3, 1))


@pytest.mark.parametrize("decoder,feat,hw", [
    (UpconvDecoder, 1024, (32, 64)), (FCUpconvDecoder, 512, (32, 32))])
def test_decoder_maps_flatten_row_major(decoder, feat, hw):
    """The xyz map is channels-last and the points are its rows in (H, W)
    order; fc_upconv's FC points come first."""
    dec = decoder(2048, in_features=feat)
    with torch.no_grad():
        pts, extras = dec(torch.randn(2, feat))
    xyzmap = extras["xyzmap"]
    assert tuple(xyzmap.shape) == (2,) + hw + (3,)
    tail = pts[:, -hw[0] * hw[1]:]
    assert pts.shape == (2, 2048, 3)
    assert torch.equal(tail[:, hw[1] + 3], xyzmap[:, 1, 3])
    assert torch.equal(tail.reshape(2, *hw, 3), xyzmap)
