"""The PyTorch port stands alone: it imports neither JAX nor ``xgnn_tpu``."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "xgnn_tpu_torch")


def _submodules():
    import xgnn_tpu_torch

    return sorted(
        m.name for m in pkgutil.walk_packages(xgnn_tpu_torch.__path__,
                                              "xgnn_tpu_torch.")
    )


def test_port_imports_no_jax_and_no_reference_package():
    code = (
        "import importlib, sys\n"
        "for name in sys.argv[1:]:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'xgnn_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok', len(sys.argv) - 1)\n"
    )
    mods = ["xgnn_tpu_torch"] + _submodules()
    assert len(mods) > 15
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code, *mods], cwd=REPO,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ok", str(len(mods))]


# imports of JAX and its libraries, and any reach into the JAX package
# ("xgnn_tpu." does not match "xgnn_tpu_torch."; a path such as
# "xgnn_tpu/ops/pallas_gather.py" naming a counterpart is allowed)
_FORBIDDEN = re.compile(
    r"\bimport\s+(jax|jaxlib|flax|optax)\b|\bfrom\s+(jax|jaxlib|flax|optax)\b"
    r"|\bxgnn_tpu\."
)


def _sources():
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith((".py", ".cu")):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


@pytest.mark.parametrize("path", sorted(_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_sources_never_import_jax_or_the_reference(path):
    with open(path) as f:
        text = f.read()
    hits = [m.group(0) for m in _FORBIDDEN.finditer(text)]
    assert not hits, hits
