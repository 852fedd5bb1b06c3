"""The port stands alone: importing every module of
pointnet_autoencoder_tpu_torch loads neither JAX nor any module of the
JAX package, its sources name neither, and its entry points default to
the card and raise where there is none."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest
import torch

import pointnet_autoencoder_tpu_torch as port
from pointnet_autoencoder_tpu_torch.device import resolve_device
from pointnet_autoencoder_tpu_torch.inference import InferenceSession

torch.set_num_threads(2)

PKG_DIR = os.path.dirname(port.__file__)
REPO = os.path.dirname(PKG_DIR)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [PKG_DIR], prefix="pointnet_autoencoder_tpu_torch."))


def test_every_module_is_listed():
    mods = _modules()
    for name in ("ops.chamfer", "ops.fused_encoder", "ops.fused_head",
                 "nn.layers", "nn.encoder", "nn.decoders",
                 "models.autoencoder", "models.registry", "convert",
                 "checkpoint_file",
                 "inference", "serve", "cli.serve", "cli.train",
                 "csrc.build", "device", "config", "data.shapenet_part",
                 "data.synthetic", "data.pipeline", "train.schedules",
                 "train.state", "train.checkpoint", "train.logging",
                 "train.loop"):
        assert f"pointnet_autoencoder_tpu_torch.{name}" in mods


def test_importing_the_port_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'jaxlib', 'flax', "
        "'optax', 'orbax') or m.split('.')[0] in ('jax', 'jaxlib', 'flax', "
        "'optax', 'orbax') or m == 'pointnet_autoencoder_tpu' or "
        "m.startswith('pointnet_autoencoder_tpu.')]\n"
        "print(json.dumps(bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_sources_name_neither_jax_nor_the_jax_package():
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|jaxlib|flax|optax|orbax)\b"
        r"|pointnet_autoencoder_tpu\.", re.M)
    offenders = []
    for root, _, files in os.walk(PKG_DIR):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                path = os.path.join(root, f)
                with open(path) as fh:
                    if pattern.search(fh.read()):
                        offenders.append(os.path.relpath(path, REPO))
    assert not offenders


@pytest.mark.parametrize("entry", ["resolve_device", "session"])
def test_device_defaults_to_cuda_and_raises_without_a_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default would run on it")
    with pytest.raises(RuntimeError, match="cuda"):
        if entry == "resolve_device":
            resolve_device()
        else:
            path = tmp_path / "w.pt"
            path.write_bytes(b"")
            InferenceSession("model", str(path), 64)
    assert resolve_device("cpu") == torch.device("cpu")
