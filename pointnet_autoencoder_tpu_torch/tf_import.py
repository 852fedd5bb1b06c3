"""Reference-named weights in and out of the port: the counterpart of
``pointnet_autoencoder_tpu/tf_import.py``.

The reference trains with ``tf.train.Saver``; its checkpoints hold flat
variable-scope names (``conv1/weights``, ``fc1/bn/moving_mean``, ...).
``import_reference_checkpoint`` maps such a checkpoint onto a model's
state_dict (optionally writing a serving bundle), and
``export_reference_arrays`` writes a state_dict back under those names,
in the reference's layouts:

    encoder conv1 weights        (1, 3, 1, 64)       conv2d over (B,N,3,1)
    other encoder conv weights   (1, 1, cin, cout)   pointwise conv2d
    fc_conv* weights             (1, cin, cout)      conv1d
    fully connected weights      (in, out)
    upconv* weights              (kh, kw, cout, cin) conv2d_transpose
    biases                       <scope>/biases
    BN                           <scope>/bn/{beta,gamma,moving_mean,
                                 moving_variance}

The name and layout rules are ``convert.py``'s (``port_name`` and
``reference_scope``); an export imports back bit for bit, and the JAX
package's ``cli.import_tf`` reads it too.

Readers: a ``.npz`` archive keyed by variable name (``/`` or ``__`` as the
separator) needs nothing; a TF Saver checkpoint needs ``tensorflow``,
which the port does not require otherwise. Optimizer slots (``*/Adam``,
``*/Adam_1``, ``*/Momentum``), the beta powers and the global step are
recognized and skipped.

A serving bundle is a directory with ``bundle_meta.json`` (``format``,
``model``, ``num_point`` and, for an import, ``imported_from``) and
``variables.npz`` (the model's reference-named f32 arrays).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from pointnet_autoencoder_tpu_torch import convert

BUNDLE_META = "bundle_meta.json"
BUNDLE_VARIABLES = "variables.npz"
BUNDLE_FORMAT = "pcae-torch-bundle-v1"

# The reference's BN variable names by the port's buffer/parameter name.
_BN_REFERENCE = {v: k for k, v in convert._BN_NAMES.items()}


class TFImportError(ValueError):
    pass


# -- readers ----------------------------------------------------------------


def _npz_reader(path: str) -> Tuple[Callable[[str], np.ndarray], List[str]]:
    data = np.load(path)
    table = {k.replace("__", "/"): k for k in data.files}
    return (lambda name: np.asarray(data[table[name]])), sorted(table)


def _tf_reader(path: str) -> Tuple[Callable[[str], np.ndarray], List[str]]:
    try:
        import tensorflow as tf
    except ImportError as e:
        raise TFImportError(
            "reading a TF checkpoint requires tensorflow; either install it "
            "or convert the checkpoint to .npz (numpy archive keyed by "
            "variable name) and pass that instead") from e
    reader = tf.train.load_checkpoint(path)
    names = sorted(reader.get_variable_to_shape_map())
    return (lambda name: np.asarray(reader.get_tensor(name))), names


def open_checkpoint(path: str):
    """(get_tensor(name) -> np.ndarray, [variable names]) of an ``.npz``
    archive or, where tensorflow imports, a TF Saver checkpoint prefix."""
    if path.endswith(".npz"):
        return _npz_reader(path)
    return _tf_reader(path)


def classify_skipped(skipped: List[str]) -> Tuple[List[str], List[str]]:
    """Split skipped checkpoint names into (optimizer state and
    bookkeeping, unrecognized)."""
    expected, unknown = [], []
    for name in skipped:
        if convert.is_optimizer_state(name):
            expected.append(name)
        else:
            unknown.append(name)
    return expected, unknown


# -- the port's state_dict -> reference-named arrays -------------------------


def reference_array(key: str, value: torch.Tensor) -> Tuple[str, np.ndarray]:
    """(the reference variable name, the f32 array in the reference's
    layout) of one state_dict entry; ``convert.port_name`` reversed."""
    module, layer, param = key.rsplit(".", 2)
    scope = convert.reference_scope(module)
    arr = value.detach().float().cpu().numpy()
    if layer == "dense" and param == "weight":
        w = arr.T  # (in, out)
        cin, cout = w.shape
        if module == "encoder.conv1":
            w = w.reshape(1, cin, 1, cout)
        elif module.startswith("encoder."):
            w = w.reshape(1, 1, cin, cout)
        elif scope.startswith("fc_conv"):
            w = w.reshape(1, cin, cout)
        return f"{scope}/weights", np.ascontiguousarray(w)
    if layer == "convt" and param == "weight":
        # (cin, cout, kh, kw) -> (kh, kw, cout, cin), no flip.
        return f"{scope}/weights", np.ascontiguousarray(
            arr.transpose(2, 3, 1, 0))
    if param == "bias":
        return f"{scope}/biases", arr
    if layer == "bn" and param in _BN_REFERENCE:
        return f"{scope}/bn/{_BN_REFERENCE[param]}", arr
    raise TFImportError(f"no reference name for state_dict entry {key!r}")


def export_reference_arrays(state_dict: Mapping[str, torch.Tensor]
                            ) -> Dict[str, np.ndarray]:
    """A state_dict as reference-named f32 arrays (``np.savez(path,
    **arrays)`` writes what ``cli.import_tf`` and ``InferenceSession``
    read)."""
    return dict(reference_array(k, v) for k, v in state_dict.items())


def write_bundle(out_dir: str, model: str, num_point: int,
                 state_dict: Mapping[str, torch.Tensor],
                 imported_from: Optional[str] = None) -> str:
    """Write a serving bundle; returns its absolute path."""
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    np.savez(os.path.join(out_dir, BUNDLE_VARIABLES),
             **export_reference_arrays(state_dict))
    meta = {"format": BUNDLE_FORMAT, "model": model, "num_point": num_point}
    if imported_from is not None:
        meta["imported_from"] = imported_from
    with open(os.path.join(out_dir, BUNDLE_META), "w") as f:
        json.dump(meta, f)
    return out_dir


# -- entry point ------------------------------------------------------------


def import_reference_checkpoint(model: str, path: str, num_point: int,
                                out_dir: Optional[str] = None,
                                strict: bool = True):
    """Map a reference checkpoint (TF Saver prefix or ``.npz``) onto
    ``model``'s state_dict; with ``out_dir``, also write a serving bundle
    there. Returns (state_dict, report).

    Raises TFImportError for a model variable the checkpoint lacks or
    holds at another shape, and, with ``strict``, for a checkpoint
    variable that is neither a model variable nor optimizer state (the
    wrong ``--model`` family, or a fork with extra layers)."""
    from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec

    spec = get_model_spec(model)
    spec.check_num_point(num_point)
    template = spec.make(num_point).state_dict()
    get, names = open_checkpoint(path)
    state: Dict[str, torch.Tensor] = {}
    used, skipped = [], []
    for name in names:
        if convert.is_optimizer_state(name):
            skipped.append(name)
            continue
        try:
            key, value = convert.port_name(name, get(name))
        except ValueError:
            skipped.append(name)
            continue
        if key not in template:
            skipped.append(name)
            continue
        if key in state:
            raise TFImportError(f"{name}: a second variable for {key}")
        if value.shape != template[key].shape:
            raise TFImportError(
                f"{name}: shape {tuple(value.shape)} != expected "
                f"{tuple(template[key].shape)} ({key})")
        state[key] = value
        used.append(name)
    missing = [reference_array(k, template[k])[0]
               for k in template if k not in state]
    if missing:
        raise TFImportError(f"checkpoint has no variable for "
                            f"{', '.join(missing[:20])}")
    expected, unknown = classify_skipped(skipped)
    if unknown and strict:
        raise TFImportError(
            "checkpoint variables with no mapping (wrong --model family, "
            "or a fork with extra layers?): " + ", ".join(unknown[:20]))
    report = {"model": model, "num_point": num_point, "mapped": len(used),
              "skipped_optimizer_state": len(expected), "unmapped": unknown}
    if out_dir is not None:
        report["bundle"] = write_bundle(out_dir, model, num_point, state,
                                        imported_from=os.path.abspath(path))
    return state, report
