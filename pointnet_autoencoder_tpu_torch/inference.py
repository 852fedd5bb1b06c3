"""Inference sessions: weights -> reconstruction, embedding, decoding and
per-shape metrics on one device.

Counterpart of ``pointnet_autoencoder_tpu/inference.py``. One object owns
the model, its weights on the device and the encoder chain folded for the
fused kernel; callers feed numpy arrays of shape (B, num_point, 3) (or one
(num_point, 3) cloud) and get numpy back.

Inputs are cut into chunks of ``batch_size``; a ragged tail is
zero-padded to the batch size and the padding sliced off (eval-mode
shapes are independent, so the padding changes no real result). Every
chunk is launched before any result is fetched, and results come to the
host in one copy at the end.

Numerics: f32 mode is full f32. Matmuls and cuDNN's convolutions run
with TF32 off, which the session sets
(``torch.backends.cuda.matmul.allow_tf32 = False``,
``torch.backends.cudnn.allow_tf32 = False``; the second defaults to True),
as the reference threads HIGHEST precision through every f32 product.
``bf16=True``
stores every parameter in bfloat16 and runs the matmuls on bf16 inputs;
BN moving statistics stay f32.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from pointnet_autoencoder_tpu_torch import checkpoint_file, tf_import
from pointnet_autoencoder_tpu_torch.convert import from_reference_arrays
from pointnet_autoencoder_tpu_torch.device import resolve_device
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.ops.chamfer import fscore as _fscore_op
from pointnet_autoencoder_tpu_torch.ops.chamfer import nn_distance


def chunked_dispatch(run: Callable, arr: np.ndarray, chunk_size: int,
                     device: torch.device):
    """Stream ``arr`` (leading axis) through ``run`` in chunks of
    ``chunk_size`` rows on ``device``: the ragged tail is zero-padded, every
    chunk is launched before any result is fetched, and each output comes
    to the host in one copy with the padding sliced off.

    ``run(chunk)`` returns one tensor or a tuple of them (``None`` entries
    stay ``None``: the caller did not want that output). Returns a numpy
    array, or a tuple of them when ``run`` returns a tuple."""
    total = arr.shape[0]
    outs = []
    for s in range(0, total, chunk_size):
        chunk = arr[s:s + chunk_size]
        pad = chunk_size - chunk.shape[0]
        if pad:
            chunk = np.concatenate(
                [chunk, np.zeros((pad,) + chunk.shape[1:], arr.dtype)])
        res = run(torch.from_numpy(chunk).to(device))
        outs.append(res if isinstance(res, tuple) else (res,))
    cols = [None if outs[0][j] is None else
            torch.cat([o[j] for o in outs])[:total].float().cpu().numpy()
            for j in range(len(outs[0]))]
    return tuple(cols) if len(cols) > 1 else cols[0]


def read_bundle_meta(bundle_dir: str) -> dict:
    """The metadata of a serving bundle of the port; raises ValueError,
    naming the route that works, for a bundle of the JAX package (orbax,
    which the port cannot read)."""
    with open(os.path.join(bundle_dir, tf_import.BUNDLE_META)) as f:
        meta = json.load(f)
    if meta.get("format") != tf_import.BUNDLE_FORMAT:
        raise ValueError(
            f"{bundle_dir} is a serving bundle of format "
            f"{meta.get('format')!r}, not the port's "
            f"{tf_import.BUNDLE_FORMAT!r}; the port cannot read the JAX "
            f"package's orbax bundles. Export its weights with the JAX "
            f"package's cli.export --format reference_npz and pass the "
            f".npz (or import that with the port's cli.import_tf --out)")
    return meta


def load_state_dict(model_path: str):
    """A reference-named ``.npz`` archive, a serving bundle of the port
    (``export_bundle``, ``cli.import_tf --out``), a ``.pt`` state_dict
    that the port saved (``torch.save(model.state_dict(), path)``), or a
    training checkpoint of the port (``best_model_epoch_NNN.ckpt``,
    ``model.ckpt``), whose model state_dict is taken."""
    if model_path.endswith(".npz"):
        return from_reference_arrays(model_path)
    if model_path.endswith(".pt"):
        return torch.load(model_path, map_location="cpu", weights_only=True)
    if os.path.isfile(os.path.join(model_path, tf_import.BUNDLE_META)):
        read_bundle_meta(model_path)
        return from_reference_arrays(
            os.path.join(model_path, tf_import.BUNDLE_VARIABLES))
    if checkpoint_file.is_checkpoint(model_path):
        return checkpoint_file.load(model_path)["model"]
    raise ValueError(f"model_path must be a reference-named .npz (cli.export "
                     f"--format reference_npz), a serving bundle, a .pt "
                     f"state_dict or a training checkpoint of the port, got "
                     f"{model_path!r}")


class InferenceSession:
    """A model with its weights, served on one device.

    Args:
      model: registry name (``available_models()``); raises ValueError
        if its decoder cannot emit ``num_point`` points.
      model_path: reference-named ``.npz``, a serving bundle of the port,
        a ``.pt`` state_dict or a training checkpoint of the port.
      num_point: points per shape the model was trained with.
      batch_size: rows per launch; inputs are padded and split to it.
      bf16: bfloat16 parameters and matmul inputs (BN statistics f32).
      device: ``"cuda"`` (default; raises without a card) or ``"cpu"``,
        which runs the kernels' plain PyTorch versions.
    """

    def __init__(self, model: str, model_path: str, num_point: int,
                 batch_size: int = 32, bf16: bool = False,
                 device: str = "cuda"):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if not os.path.exists(model_path):
            raise FileNotFoundError(model_path)
        self.device = resolve_device(device)
        self.model_name = model
        self.num_point = num_point
        self.batch_size = batch_size
        self.bf16 = bf16
        if self.device.type == "cuda":
            # Full f32 products: TF32 off for matmuls (off by default, but a
            # caller may have turned it on) and for cuDNN's convolutions
            # (on by default).
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        dtype = torch.bfloat16 if bf16 else torch.float32
        self._model = get_model_spec(model).make(num_point, dtype=dtype)
        try:
            self._model.load_state_dict(load_state_dict(model_path))
        except RuntimeError as e:
            raise ValueError(
                f"{model_path} does not fit model {model!r} at num_point="
                f"{num_point} (a different --model or --num_point?): "
                f"{e}") from None
        if bf16:
            # Parameters pre-cast (the bf16 forward casts them at every use
            # anyway); BN moving statistics are buffers and stay f32.
            for p in self._model.parameters():
                p.data = p.data.to(torch.bfloat16)
        self._model.to(self.device).eval().requires_grad_(False)
        with torch.inference_mode():
            self._folded = self._model.encoder.fold()

    @property
    def model(self):
        return self._model

    # -- serving bundles ------------------------------------------------------

    def export_bundle(self, out_dir: str) -> str:
        """Write a params-only serving bundle (the model's reference-named
        f32 arrays and a metadata file; no optimizer state); returns its
        path. ``from_bundle`` opens it, and its ``variables.npz`` is also
        an input of the JAX package's ``cli.import_tf``."""
        return tf_import.write_bundle(out_dir, self.model_name,
                                      self.num_point, self._model.state_dict())

    @classmethod
    def from_bundle(cls, bundle_dir: str, batch_size: int = 32,
                    bf16: bool = False,
                    device: str = "cuda") -> "InferenceSession":
        """Open a serving bundle; the model name and num_point come from
        its metadata."""
        meta = read_bundle_meta(bundle_dir)
        return cls(meta["model"], bundle_dir, int(meta["num_point"]),
                   batch_size=batch_size, bf16=bf16, device=device)

    # -- helpers --------------------------------------------------------------

    def _batched(self, points) -> Tuple[np.ndarray, bool]:
        pts = np.asarray(points, np.float32)
        single = pts.ndim == 2
        if single:
            pts = pts[None]
        if pts.shape[1:] != (self.num_point, 3):
            raise ValueError(
                f"expected (*, {self.num_point}, 3), got {pts.shape}")
        if pts.shape[0] == 0:
            raise ValueError("got 0 input shapes")
        return pts, single

    @torch.inference_mode()
    def _run(self, pts: np.ndarray, fetch_pred: bool = True,
             fetch_emb: bool = True):
        def run(chunk):
            pred, end_points = self._model(chunk, folded=self._folded)
            return (pred if fetch_pred else None,
                    end_points["embedding"] if fetch_emb else None)

        return chunked_dispatch(run, pts, self.batch_size, self.device)

    def _put(self, arr) -> torch.Tensor:
        return torch.from_numpy(np.asarray(arr, np.float32)).to(self.device)

    # -- public API -----------------------------------------------------------

    def reconstruct(self, points) -> np.ndarray:
        """(B, N, 3) or (N, 3) -> reconstructed cloud(s), same leading
        shape, f32."""
        pts, single = self._batched(points)
        pred, _ = self._run(pts, fetch_emb=False)
        return pred[0] if single else pred

    def embed(self, points) -> np.ndarray:
        """(B, N, 3) or (N, 3) -> embedding(s) (B, D) / (D,), f32; D is
        the last neck width, else 1024."""
        pts, single = self._batched(points)
        _, emb = self._run(pts, fetch_pred=False)
        return emb[0] if single else emb

    @torch.inference_mode()
    def decode(self, embeddings) -> np.ndarray:
        """(B, D) or (D,) latent(s) of the embedding's width -> decoded
        cloud(s) (B, num_point, 3). ``decode(embed(x))`` equals
        ``reconstruct(x)``."""
        emb = np.asarray(embeddings, np.float32)
        single = emb.ndim == 1
        if single:
            emb = emb[None]
        if emb.ndim != 2:
            raise ValueError(f"expected (B, D) or (D,), got {emb.shape}")
        if emb.shape[0] == 0:
            raise ValueError("got 0 embeddings")
        pred = chunked_dispatch(lambda chunk: self._model.decoder(chunk)[0],
                                emb, self.batch_size, self.device)
        return pred[0] if single else pred

    @torch.inference_mode()
    def chamfer(self, pred, target) -> np.ndarray:
        """Per-shape raw Chamfer (the reference's pcloss),
        mean(d1) + mean(d2), between two (B, N, 3) clouds."""
        d1, _, d2, _ = nn_distance(self._put(pred), self._put(target))
        return (d1.mean(dim=1) + d2.mean(dim=1)).cpu().numpy()

    @torch.inference_mode()
    def fscore(self, pred, target, threshold: float = 0.01) -> np.ndarray:
        """Per-shape F-score@threshold between (B, N, 3) clouds."""
        return _fscore_op(self._put(pred), self._put(target),
                          threshold).cpu().numpy()

    def evaluate(self, dataset, num_shapes: Optional[int] = None,
                 seed: int = 0):
        """Reconstruct a dataset's shapes (``dataset[i][0]`` is a cloud) in
        a shuffled order; returns (mean_chamfer, per_shape)."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(dataset))
        if num_shapes is not None:
            order = order[:num_shapes]
        if len(order) == 0:
            raise ValueError(f"dataset yielded no shapes (len={len(dataset)}, "
                             f"num_shapes={num_shapes})")
        clouds = np.stack([dataset[int(i)][0] for i in order])
        preds, _ = self._run(clouds, fetch_emb=False)
        cds = []
        bs = self.batch_size
        for s in range(0, len(clouds), bs):
            pc, cc = preds[s:s + bs], clouds[s:s + bs]
            # The ragged final chunk is zero-padded to the batch size, as
            # the reference does; the padded rows are dropped.
            pad = bs - pc.shape[0]
            if pad:
                zeros = np.zeros((pad,) + pc.shape[1:], np.float32)
                pc = np.concatenate([pc, zeros])
                cc = np.concatenate([cc, zeros])
            cds.append(self.chamfer(pc, cc)[:bs - pad])
        per_shape = np.concatenate(cds)
        return float(per_shape.mean()), per_shape
