"""Importing the harness, its drivers and readers, and the program modules
the drivers load, leaves JAX and the JAX package out (top-level names
compared whole: the port's name begins with the JAX package's); the
reference imports nothing of the program."""

import subprocess
import sys

from benchmark import harness

CHECK = """
import sys
{imports}
bad = sorted({{m.split(".")[0] for m in sys.modules}} & set({forbidden!r}))
print(",".join(bad))
"""


def _loaded(imports: str, forbidden) -> str:
    code = CHECK.format(imports=imports, forbidden=tuple(forbidden))
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip()


def test_harness_and_program_leave_jax_out():
    imports = "\n".join([
        "import benchmark.run, benchmark.calibrate",
        "from benchmark import harness",
        "for p in sorted((harness.ROOT / 'drivers').glob('*.py')):",
        "    harness.load_module(p)",
        "for p in sorted((harness.ROOT / 'metrics').glob('*.py')):",
        "    harness.load_module(p)",
        "import pointnet_autoencoder_tpu_torch.inference",
        "import pointnet_autoencoder_tpu_torch.train.loop",
        "import pointnet_autoencoder_tpu_torch.csrc.build",
    ])
    assert _loaded(imports, harness.FORBIDDEN) == ""


def test_reference_imports_nothing_of_the_program():
    imports = ("import benchmark.reference.model, "
               "benchmark.reference.losses")
    assert _loaded(imports, harness.FORBIDDEN
                   + ("pointnet_autoencoder_tpu_torch",)) == ""
