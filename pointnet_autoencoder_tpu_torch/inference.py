"""Inference sessions: weights -> reconstruction, embedding, decoding and
per-shape metrics on one device, or data-parallel over several.

Counterpart of ``pointnet_autoencoder_tpu/inference.py``. One object owns
the model, its weights on the device and the encoder chain folded for the
fused kernel; callers feed numpy arrays of shape (B, num_point, 3) (or one
(num_point, 3) cloud) and get numpy back.

Inputs are cut into chunks of ``batch_size``; a ragged tail is
zero-padded to the batch size and the padding sliced off (eval-mode
shapes are independent, so the padding changes no real result). Every
chunk is launched before any result is fetched, and results come to the
host in one copy at the end.

Data parallelism (``data_parallel=k``, ``devices``): one process keeps a
replica of the eval model on each device of ``parallel.mesh.make_mesh``
and splits every padded chunk k ways, a part per replica. CUDA launches
are asynchronous, so one thread launches every part of every chunk
before it fetches any result; results are gathered in order.

Tensor parallelism (``model_parallel=m``): each replica spans m devices
(``make_mesh`` rank order, replica d on entries d*m..d*m+m-1; one device
may repeat). Its decoder's fc1 and fc3 column slices and fc2 row slices
sit on those devices (``parallel/tp.py``: ``InProcessFC``), and the
partial sums and slices are combined in this process on the replica's
first device, where the encoder, the neck and the rest of the decoder
run. It composes with ``data_parallel``.

Compiled forwards: on cards (``compiled``, the default) every op's
forward of a padded chunk replays a CUDA graph (``utils/graphs.py``),
the JAX package's jitted forward: ``reconstruct``/``embed`` share one,
``decode``, ``chamfer`` and ``fscore`` (its threshold a device scalar)
have their own; the metrics run in padded chunks as the forwards do. A
TP-split replica whose m devices are one card is captured whole; one
that spans cards runs eager (``plan_programs``).

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

import contextlib
import copy
import json
import os
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from pointnet_autoencoder_tpu_torch import checkpoint_file, tf_import
from pointnet_autoencoder_tpu_torch.convert import from_reference_arrays
from pointnet_autoencoder_tpu_torch.device import resolve_device
from pointnet_autoencoder_tpu_torch.models.registry import get_model_spec
from pointnet_autoencoder_tpu_torch.ops.chamfer import fscore as _fscore_op
from pointnet_autoencoder_tpu_torch.ops.chamfer import nn_distance
from pointnet_autoencoder_tpu_torch.parallel import tp
from pointnet_autoencoder_tpu_torch.parallel.mesh import (
    check_batch_divisible,
    make_mesh,
)
from pointnet_autoencoder_tpu_torch.utils.graphs import ProgramCache


def _on(device: torch.device):
    """The context that makes ``device`` current for kernel launches."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


def chunked_dispatch(run: Callable, arr, chunk_size: int,
                     devices: Sequence[torch.device]):
    """Stream ``arr`` (leading axis; or a tuple of arrays of one leading
    length, cut alike) through ``run`` in chunks of ``chunk_size`` rows,
    each chunk split into equal parts, one per entry of ``devices``: the
    ragged tail is zero-padded, every part is launched before any result
    is fetched, and each output comes to the host with the padding sliced
    off, in order (one copy where one device holds every part).

    ``run(part, i)`` (``run(*parts, i)`` for a tuple) runs on
    ``devices[i]`` and returns one tensor or a tuple of them (``None``
    entries stay ``None``: the caller did not want that output). Returns
    a numpy array, or a tuple of them when ``run`` returns a tuple."""
    arrs = arr if isinstance(arr, tuple) else (arr,)
    total = arrs[0].shape[0]
    rows = chunk_size // len(devices)
    outs = []
    for s in range(0, total, chunk_size):
        chunks = []
        for a in arrs:
            chunk = a[s:s + chunk_size]
            pad = chunk_size - chunk.shape[0]
            if pad:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], a.dtype)])
            chunks.append(chunk)
        for i, dev in enumerate(devices):
            with _on(dev):
                res = run(*(torch.from_numpy(c[i * rows:(i + 1) * rows])
                            .to(dev) for c in chunks), i)
            outs.append(res if isinstance(res, tuple) else (res,))
    one_device = len(set(devices)) == 1
    cols = [None if outs[0][j] is None else
            (torch.cat([o[j] for o in outs]) if one_device else
             torch.cat([o[j].cpu() for o in outs]))[:total].float().cpu()
            .numpy()
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


def plan_programs(grid: Sequence[torch.device], m: int, compiled: bool,
                  cache: Callable = ProgramCache) -> List[Tuple[Any, str]]:
    """For each replica of ``grid`` (its m devices in turn): a program
    cache, ``cache(device)``, where its forwards are captured, else None,
    and its forward path (``captured ...`` or ``eager (reason)``). A
    replica is captured when ``compiled`` and its devices are one card."""
    plans = []
    for i in range(0, len(grid), m):
        devs = list(grid[i:i + m])
        if devs[0].type != "cuda":
            reason = "the CPU runs eager"
        elif not compiled:
            reason = "compiled=False: the eager reference"
        elif len(set(devs)) > 1:
            reason = (f"a replica over {', '.join(map(str, devs))}: one "
                      f"card cannot check a capture across cards")
        else:
            plans.append((cache(devs[0]), f"captured CUDA graphs on "
                                          f"{devs[0]}"))
            continue
        plans.append((None, f"eager ({reason})"))
    return plans


class InferenceSession:
    """A model with its weights, served on one device or on a replica per
    device.

    Args:
      model: registry name (``available_models()``); raises ValueError
        if its decoder cannot emit ``num_point`` points, or for a family
        that is not served (``pcn_emd``).
      model_path: reference-named ``.npz``, a serving bundle of the port,
        a ``.pt`` state_dict or a training checkpoint of the port. A
        ``--bf16_params`` checkpoint's bf16 weights load into the
        session's own type (into f32 exactly, as the JAX package's
        session upcasts them).
      num_point: points per shape the model was trained with.
      batch_size: rows per launch; inputs are padded and split to it.
      bf16: bfloat16 parameters and matmul inputs (BN statistics f32).
      device: ``"cuda"`` (default; raises without a card) or ``"cpu"``,
        which runs the kernels' plain PyTorch versions.
      data_parallel: replicas, each serving batch_size/k rows of every
        chunk (batch_size must divide); on cards 0..k-1 unless ``devices``
        names them. None or 1 with no ``devices``: ``device`` alone.
      devices: the replicas' devices, in order (``make_mesh``; one device
        may repeat); under ``model_parallel`` m, m per replica. ``device``
        is then ignored.
      model_parallel: devices per replica over which its decoder's FC
        layers split (``parallel/tp.py``); 1: whole replicas. With no
        ``devices``, cards 0..k*m-1.
      compiled: on cards, each op's forward runs as a captured program
        (``utils/graphs.py``), one per (op, replica, shapes) at the padded
        chunk size, the first call of each in each thread eager as its
        warm-up; False runs eager, the reference. A TP-split replica is
        captured when its m devices are one card (every hop between its
        shards is then a no-op); one that spans cards runs eager, since
        one card cannot check a capture across cards. The CPU runs eager.
        Callers in several threads take turns on each replica's programs,
        which share their static inputs and outputs.

    ``devices`` is the list of the replicas' first devices; ``model``
    holds the whole weights (on the CPU under ``model_parallel``);
    ``forward_paths`` says, per replica, whether its forwards replay
    captured programs or run eager, and why.
    """

    def __init__(self, model: str, model_path: str, num_point: int,
                 batch_size: int = 32, bf16: bool = False,
                 device: str = "cuda", data_parallel: Optional[int] = None,
                 devices: Optional[Sequence] = None,
                 model_parallel: int = 1, compiled: bool = True):
        get_model_spec(model).require("serving")
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if not os.path.exists(model_path):
            raise FileNotFoundError(model_path)
        m = model_parallel
        if devices is None and (data_parallel or 1) == 1:
            # One replica: on ``device``, or on m of them.
            first = resolve_device(device)
            grid = ([first] * m if m == 1 or first.type == "cpu"
                    else make_mesh(None, 1, m))
        else:
            grid = make_mesh(devices, data_parallel, m)
        self.devices = grid[::m]
        if len(self.devices) > 1:
            check_batch_divisible(batch_size, len(self.devices))
        self.device = self.devices[0]
        self.model_name = model
        self.num_point = num_point
        self.batch_size = batch_size
        self.bf16 = bf16
        if any(d.type == "cuda" for d in self.devices):
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
        # One replica per device, copied on the host; replica 0 is
        # ``self.model`` unless the replicas split their decoders.
        self._replicas = [self._model if m == 1 else
                          copy.deepcopy(self._model)] + [
            copy.deepcopy(self._model) for _ in self.devices[1:]]
        self._folded = []
        for i, (rep, dev) in enumerate(zip(self._replicas, self.devices)):
            rep.to(dev).eval().requires_grad_(False)
            if m > 1:
                tp.parallelize_in_process_(rep.decoder,
                                           grid[i * m:(i + 1) * m])
            with torch.inference_mode(), _on(dev):
                self._folded.append(rep.encoder.fold())
        # A cache of captured programs per replica, None where it runs
        # eager.
        self._programs, self.forward_paths = map(list, zip(
            *plan_programs(grid, m, compiled)))
        # A program's static inputs and outputs are shared: one caller at
        # a time on each replica, from the copy-in to the clone.
        self._locks = [threading.Lock() for _ in self.devices]
        self._warmed: set = set()

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
                    bf16: bool = False, device: str = "cuda",
                    data_parallel: Optional[int] = None,
                    devices: Optional[Sequence] = None
                    ) -> "InferenceSession":
        """Open a serving bundle; the model name and num_point come from
        its metadata."""
        meta = read_bundle_meta(bundle_dir)
        return cls(meta["model"], bundle_dir, int(meta["num_point"]),
                   batch_size=batch_size, bf16=bf16, device=device,
                   data_parallel=data_parallel, devices=devices)

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

    def close(self) -> None:
        """Release the captured programs (their memory on the cards); the
        session stays usable and captures again on its next calls."""
        for programs in self._programs:
            if programs is not None:
                programs.close()
        self._warmed.clear()

    def _call(self, i: int, op: str, fn: Callable, *inputs: torch.Tensor):
        """``fn(*inputs)`` on replica ``i``: eager, or (``compiled``) the
        replay of its program of ``op`` at these input shapes, captured
        after a first eager call; the outputs are the caller's own."""
        programs = self._programs[i]
        if programs is None:
            return fn(*inputs)
        key = (op, i) + tuple((tuple(t.shape), t.dtype) for t in inputs)
        # The warm-up is per thread too: a thread's first cuBLAS or cuDNN
        # call makes its handle, which cannot happen under capture (a
        # server's batching thread is not the thread that warmed it up).
        warm = (threading.get_ident(),) + key
        with self._locks[i]:
            if warm not in self._warmed:
                out = programs.warm_up(lambda: fn(*inputs))
                self._warmed.add(warm)
                return out
            outputs = programs.program(key, fn, inputs).replay(*inputs)
            return (tuple(o.clone() for o in outputs)
                    if isinstance(outputs, tuple) else outputs.clone())

    @torch.inference_mode()
    def _run(self, pts: np.ndarray, fetch_pred: bool = True,
             fetch_emb: bool = True):
        def run(part, i):
            def forward(x):
                pred, end_points = self._replicas[i](x,
                                                     folded=self._folded[i])
                return pred, end_points["embedding"]

            pred, emb = self._call(i, "forward", forward, part)
            return (pred if fetch_pred else None,
                    emb if fetch_emb else None)

        return chunked_dispatch(run, pts, self.batch_size, self.devices)

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
        pred = chunked_dispatch(
            lambda part, i: self._call(
                i, "decode", lambda x: self._replicas[i].decoder(x)[0], part),
            emb, self.batch_size, self.devices)
        return pred[0] if single else pred

    def _pairs(self, op: str, fn: Callable, pred, target,
               *scalars: float) -> np.ndarray:
        """``fn(pred, target, *scalars)`` per shape of two (B, N, 3)
        clouds, in padded chunks of ``batch_size`` split among the
        replicas (each shape's value depends on its own row only); each
        scalar a 0-dim f32 input on the device."""
        def run(p, t, i):
            dev = self.devices[i]
            extra = tuple(torch.full((), v, dtype=torch.float32, device=dev)
                          for v in scalars)
            return self._call(i, op, fn, p, t, *extra)

        return chunked_dispatch(
            run, (np.asarray(pred, np.float32),
                  np.asarray(target, np.float32)),
            self.batch_size, self.devices)

    @torch.inference_mode()
    def chamfer(self, pred, target) -> np.ndarray:
        """Per-shape raw Chamfer (the reference's pcloss),
        mean(d1) + mean(d2), between two (B, N, 3) clouds."""
        def chamfer(p, t):
            d1, _, d2, _ = nn_distance(p, t)
            return d1.mean(dim=1) + d2.mean(dim=1)

        return self._pairs("chamfer", chamfer, pred, target)

    @torch.inference_mode()
    def fscore(self, pred, target, threshold: float = 0.01) -> np.ndarray:
        """Per-shape F-score@threshold between (B, N, 3) clouds; the
        threshold a device scalar of the program."""
        return self._pairs("fscore", _fscore_op, pred, target, threshold)

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
