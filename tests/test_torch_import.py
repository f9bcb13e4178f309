"""The PyTorch port imports no JAX: every arp_tpu_torch module loads with jax/flax blocked."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "flax", "arp_tpu"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import arp_tpu_torch
    names = [m.name for m in pkgutil.walk_packages(arp_tpu_torch.__path__, "arp_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "arp_tpu"))
    assert not bad, bad
    print("IMPORTED", len(names))
    """
)


def test_port_imports_without_jax_or_flax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr + out.stdout
    n = int(out.stdout.split("IMPORTED")[1])
    assert n >= 15, out.stdout  # every module of the package, not an empty walk


def test_chip_smoke_imports_without_jax_or_the_jax_package():
    script = _SCRIPT.replace(
        "import arp_tpu_torch\n", "import chip_smoke, arp_tpu_torch\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, env=env, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr + out.stdout
