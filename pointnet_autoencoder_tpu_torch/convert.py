"""Weights carried into the port: a ``state_dict`` from the reference's
variable tree or from its reference-named array archive.

- ``from_flax_variables(tree)``: the ``{params, batch_stats}`` tree of
  numpy arrays that ``jax.device_get(variables)`` gives. Flax paths map
  onto module names (``encoder/conv1/dense/kernel`` ->
  ``encoder.conv1.dense.weight``); dense kernels go from (in, out) to the
  port's (out, in); ConvTranspose kernels (kh, kw, cin, cout) are flipped
  in both spatial axes and permuted to torch's (cin, cout, kh, kw), since
  flax correlates the un-flipped kernel over the dilated input where
  ``F.conv_transpose2d`` (like TF's conv2d_transpose) scatters it; N-D
  ``Conv`` kernels (*k, cin, cout) are permuted to (cout, cin, *k); BN
  ``gamma``/``beta`` come from params and ``mean``/``var`` from
  batch_stats. Leaves of a ``--bf16_params`` run (the ``ml_dtypes``
  bfloat16 arrays ``np.asarray`` gives) are upcast to f32 exactly, or
  kept in bf16 with ``keep_bf16`` (the port's ``--bf16_params`` storage,
  ``train/master.py``).
- ``from_reference_arrays(npz)``: the flat archive written by the JAX
  package's ``cli.export --format reference_npz``, keyed by the reference
  TF stack's variable names (``conv1/weights`` (1,3,1,64),
  ``conv2/weights`` (1,1,64,64), ``fc_conv1/weights`` (1,cin,cout),
  ``fc1/weights`` (in,out), ``upconv1/weights`` (kh,kw,cout,cin) of
  conv2d_transpose, ``*/biases``,
  ``*/bn/{beta,gamma,moving_mean,moving_variance}``), with ``/`` or ``__``
  as the separator. A conv2d_transpose kernel is only permuted, not
  flipped: TF's op is torch's. The encoder's scopes are ``conv1``-``conv5``,
  the neck's ``fc00``/``fc01`` (top level), every other scope the
  decoder's. Optimizer slots and the global step are skipped.

This is how a model trained by the JAX package (or by the reference)
reaches the port without JAX. Orbax bundles and training checkpoints are
not readable here.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Mapping, Tuple, Union

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]

# Optimizer and bookkeeping variables a reference training checkpoint holds
# besides the model (Adam/Momentum slots, beta powers, the global step).
_SKIP_EXACT = {"batch", "beta1_power", "beta2_power", "global_step"}
_SKIP_SLOT = re.compile(r"/(Adam|Adam_1|Momentum)(/|$)")
# BN variables under the explicit 'bn' scope or contrib's default
# 'BatchNorm' sub-scope.
_BN = re.compile(r"^(?P<scope>.+?)/(?:bn/(?:BatchNorm/)?|BatchNorm/)"
                 r"(?P<var>beta|gamma|moving_mean|moving_variance)$")
_BN_NAMES = {"beta": "beta", "gamma": "gamma", "moving_mean": "mean",
             "moving_variance": "var"}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _is_bf16(arr: np.ndarray) -> bool:
    """An ``ml_dtypes`` bfloat16 array (what ``np.asarray`` gives of a JAX
    bf16 leaf)."""
    return arr.dtype.name == "bfloat16"


def _bf16_tensor(a: np.ndarray) -> torch.Tensor:
    """A bfloat16 numpy array as a torch bf16 tensor, bit for bit."""
    bits = np.ascontiguousarray(a).view(np.int16)
    return torch.from_numpy(bits.copy()).view(torch.bfloat16)


def from_flax_variables(tree: Mapping, keep_bf16: bool = False
                        ) -> StateDict:
    """``{params, batch_stats}`` tree of arrays -> the port's state_dict.
    bf16 leaves are upcast to f32 (exact), or stay bf16 with
    ``keep_bf16``; every other leaf becomes f32."""
    out: StateDict = {}

    def walk(node, path, collection):
        if isinstance(node, Mapping):
            for k, v in node.items():
                walk(v, path + (str(k),), collection)
            return
        raw = np.asarray(node)
        if keep_bf16 and _is_bf16(raw):
            put = _bf16_tensor
            arr = raw
        else:
            put = _tensor
            arr = np.asarray(raw, dtype=np.float32)
        *mods, leaf = path
        if collection == "params" and leaf == "kernel" and mods[-1] == "dense":
            if arr.ndim != 2:
                raise ValueError(f"{'/'.join(path)}: expected a 2-D dense "
                                 f"kernel, got {arr.shape}")
            out[".".join(mods + ["weight"])] = put(arr.T)
        elif collection == "params" and leaf == "kernel" and mods[-1] == "convt":
            if arr.ndim != 4:
                raise ValueError(f"{'/'.join(path)}: expected a 4-D "
                                 f"ConvTranspose kernel, got {arr.shape}")
            out[".".join(mods + ["weight"])] = put(
                arr[::-1, ::-1].transpose(2, 3, 0, 1))
        elif collection == "params" and leaf == "kernel" and mods[-1] == "conv":
            if not 3 <= arr.ndim <= 5:
                raise ValueError(f"{'/'.join(path)}: expected a 1-3-D conv "
                                 f"kernel (*k, cin, cout), got {arr.shape}")
            # (*k, cin, cout) -> (cout, cin, *k): both correlate.
            out[".".join(mods + ["weight"])] = put(arr.transpose(
                (arr.ndim - 1, arr.ndim - 2) + tuple(range(arr.ndim - 2))))
        elif leaf in ("bias", "gamma", "beta", "mean", "var"):
            out[".".join(path)] = put(arr)
        else:
            raise ValueError(f"no port counterpart for {collection}/"
                             f"{'/'.join(path)}")

    walk(tree["params"], (), "params")
    walk(tree.get("batch_stats", {}), (), "batch_stats")
    return out


def _module(scope: str) -> str:
    # tf_import._ref_scope, reversed: the encoder's scopes are
    # conv1..conv5, the neck's fc00/fc01 stay at the top level, and every
    # other scope is the decoder's.
    if re.fullmatch(r"conv\d+", scope):
        return f"encoder.{scope}"
    if re.fullmatch(r"fc0\d", scope):
        return scope
    return f"decoder.{scope}"


def reference_scope(module: str) -> str:
    """The reference scope of a port module path (``_module`` reversed):
    ``encoder.conv1`` -> ``conv1``, ``fc00`` -> ``fc00``,
    ``decoder.fc1`` -> ``fc1``."""
    scope = module.split(".", 1)[-1]
    if _module(scope) != module:
        raise ValueError(f"no reference scope for port module {module!r}")
    return scope


def is_optimizer_state(name: str) -> bool:
    """Whether a reference variable name is optimizer state or the global
    step (skipped on import)."""
    return name in _SKIP_EXACT or _SKIP_SLOT.search(name) is not None


def port_name(name: str, value: np.ndarray) -> Tuple[str, torch.Tensor]:
    """(the port's state_dict key, the tensor in its layout) of one
    reference variable (``/`` or ``__`` separated) that is not optimizer
    state. Raises ValueError for a name with no counterpart."""
    name = name.replace("__", "/")
    arr = np.asarray(value, dtype=np.float32)
    bn = _BN.match(name)
    if bn:
        return (f"{_module(bn['scope'])}.bn.{_BN_NAMES[bn['var']]}",
                _tensor(arr))
    scope, _, var = name.rpartition("/")
    if not scope:
        raise ValueError(f"no port counterpart for reference variable "
                         f"{name!r}")
    # The decoders' upconv* scopes are transposed convolutions.
    convt = re.fullmatch(r"upconv\d+", scope) is not None
    layer = f"{_module(scope)}.{'convt' if convt else 'dense'}"
    if var == "weights" and convt:
        if arr.ndim != 4:
            raise ValueError(f"{name}: expected a 4-D conv2d_transpose "
                             f"kernel, got {arr.shape}")
        # (kh, kw, cout, cin) -> (cin, cout, kh, kw), no flip.
        return f"{layer}.weight", _tensor(arr.transpose(3, 2, 0, 1))
    if var == "weights":
        # conv2d (kh,kw,cin,cout) / conv1d (k,cin,cout) / fc (in,out):
        # flattening keeps the contraction order (tf_import._dense_kernel).
        return f"{layer}.weight", _tensor(arr.reshape(-1, arr.shape[-1]).T)
    if var == "biases":
        return f"{layer}.bias", _tensor(arr)
    raise ValueError(f"no port counterpart for reference variable {name!r}")


def from_reference_arrays(
        npz: Union[str, os.PathLike, Mapping[str, np.ndarray]]) -> StateDict:
    """Reference-named arrays (an ``.npz`` path or a mapping) -> the port's
    state_dict. Raises on a name that is neither a model variable nor
    optimizer state."""
    if isinstance(npz, (str, os.PathLike)):
        with np.load(npz) as data:
            arrays = {k: data[k] for k in data.files}
    else:
        arrays = dict(npz)
    return dict(port_name(k, v) for k, v in arrays.items()
                if not is_optimizer_state(k.replace("__", "/")))
