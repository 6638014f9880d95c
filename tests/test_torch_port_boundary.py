"""The boundary between the JAX package and its PyTorch port.

The port carries its own copies of the JAX package's modules that contain
no JAX code (importing ``cirkit_tpu`` loads JAX, which the machines with a
CUDA card do not have). The copies must not drift from their originals:
each equals its ``cirkit_tpu`` original once the ``cirkit_tpu.`` import
prefix is rewritten to ``cirkit_tpu_torch.``. And importing the port must
not load JAX.
"""

import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
COPIED = [
    *(f"symbolic/{p.name}" for p in sorted((ROOT / "cirkit_tpu" / "symbolic").glob("*.py"))),
    "models/region_graph/__init__.py",
    "models/region_graph/algorithms.py",
    "models/region_graph/graph.py",
    "models/region_graph/io.py",
    "models/utils.py",
    "models/data_modalities.py",
    "models/pgms.py",
    "models/tensor_factorizations.py",
    "models/structure_learning.py",
    "models/logic/__init__.py",
    "models/logic/graph.py",
    "models/logic/psdd.py",
    "models/logic/sdd.py",
    "utils/__init__.py",
    "utils/algorithms.py",
    "utils/lazy.py",
    "utils/scope.py",
    "backend/base.py",
    "models/interop.py",
]
_IMPORT = re.compile(r"^(\s*(?:from|import) )cirkit_tpu\.", re.MULTILINE)
# copies that import the backend: the JAX backend module rewritten to the port's
EXTRA_REWRITES = {
    "models/interop.py": [("cirkit_tpu_torch.backend.jax.pruning",
                           "cirkit_tpu_torch.backend.torch.pruning")],
}


@pytest.mark.parametrize("rel", COPIED)
def test_copied_module_matches_original(rel):
    original = (ROOT / "cirkit_tpu" / rel).read_text()
    copy = (ROOT / "cirkit_tpu_torch" / rel).read_text()
    want = _IMPORT.sub(r"\1cirkit_tpu_torch.", original)
    for old, new in EXTRA_REWRITES.get(rel, []):
        assert old in want
        want = want.replace(old, new)
    assert copy == want


def test_port_imports_no_jax():
    code = (
        "import sys, cirkit_tpu_torch, cirkit_tpu_torch.pipeline, cirkit_tpu_torch.ops; "
        "assert 'jax' not in sys.modules, 'jax imported'; "
        "assert 'cirkit_tpu' not in sys.modules, 'cirkit_tpu imported'"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


@pytest.mark.parametrize("module", ["ops.clse_einsum", "ops.slse_einsum", "ops.routing",
                                    "backend.torch.semiring", "backend.torch.parameters",
                                    "utils.checkpoint", "backend.torch.entropy",
                                    "backend.torch.topk", "models.logic", "backend.torch.cross",
                                    "backend.torch.pruning", "backend.torch.distill",
                                    "backend.torch.pic", "models.ensembles",
                                    "models.interop"])
def test_port_module_alone_imports_no_jax(module):
    """Each module that launches kernels or carries stores across imports on
    its own without JAX and without the JAX package."""
    code = (
        f"import sys, cirkit_tpu_torch.{module}; "
        "assert 'jax' not in sys.modules and 'cirkit_tpu' not in sys.modules"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr


def test_port_sources_name_no_jax_import():
    pattern = re.compile(r"^\s*(import jax|from jax|import cirkit_tpu\b|from cirkit_tpu[ .])",
                         re.MULTILINE)
    offenders = [
        str(p.relative_to(ROOT))
        for p in (ROOT / "cirkit_tpu_torch").rglob("*.py")
        if pattern.search(p.read_text())
    ]
    assert offenders == []
