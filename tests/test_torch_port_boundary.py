"""The boundary between the JAX package and its PyTorch port.

The port carries its own copies of the JAX package's modules that contain
no JAX code (importing ``cirkit_tpu`` loads JAX, which the machines with a
CUDA card do not have). The copies must not drift from their originals:
each equals its ``cirkit_tpu`` original once the ``cirkit_tpu.`` import
prefix is rewritten to ``cirkit_tpu_torch.``. And importing the port must
not load JAX. The port's public surface (exported names and the
signatures of its functions and classes) matches the JAX package's, with
``Jax`` read as ``Torch``, but for the differences kept on purpose in
``API_DIFFERENCES``.
"""

import importlib
import inspect
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

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
                                    "models.interop", "backend.torch.serving",
                                    "backend.torch.warmstart"])
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


# --------------------------------------------------------------------------- #
# The public surface against the JAX package's
# --------------------------------------------------------------------------- #

API_MODULES = [
    ("cirkit_tpu", "cirkit_tpu_torch"),
    ("cirkit_tpu.backend", "cirkit_tpu_torch.backend"),
    ("cirkit_tpu.backend.jax", "cirkit_tpu_torch.backend.torch"),
    ("cirkit_tpu.pipeline", "cirkit_tpu_torch.pipeline"),
    ("cirkit_tpu.parallel", "cirkit_tpu_torch.parallel"),
]
# (port module, name, what differs) -> why the difference is kept
API_DIFFERENCES = {
    ("cirkit_tpu_torch", "PipelineContext", "signature"):
        "the compiler's keywords are named, and device= places the store on the card or the CPU",
    ("cirkit_tpu_torch.pipeline", "PipelineContext", "signature"):
        "the same class as the package's own export",
    ("cirkit_tpu_torch.backend.torch", "TorchCircuit", "signature"):
        "device= says where the circuit's constants live",
    ("cirkit_tpu_torch.backend.torch", "TorchCompiler", "signature"):
        "device= says where the compiled circuits' constants live",
    ("cirkit_tpu_torch.backend.torch", "WarmBundle", "signature"):
        "a bundle holds the compiled circuit and its device in place of XLA executables",
    ("cirkit_tpu_torch.backend.torch", "expected_loglikelihood_mc", "signature"):
        "a torch.Generator draws the samples where JAX takes a PRNG key",
    ("cirkit_tpu_torch.backend.torch", "kl_monte_carlo", "signature"):
        "a torch.Generator draws the samples where JAX takes a PRNG key",
    ("cirkit_tpu_torch.backend.torch", "masked_evaluate", "extra"):
        "the masked forward that export_circuit traces, public for exported queries",
    ("cirkit_tpu_torch.parallel", "fit", "signature"):
        "an integer seed orders the batches where JAX takes a PRNG key",
    ("cirkit_tpu_torch.parallel", "fit_em", "signature"):
        "an integer seed orders the batches where JAX takes a PRNG key",
    ("cirkit_tpu_torch.parallel", "AdamLowMem", "extra"):
        "the torch.optim.Optimizer that adam_lowmem builds",
    ("cirkit_tpu_torch.parallel", "split_trainable", "extra"):
        "JAX keeps it in parallel.training; the port's callers take it from the package",
    ("cirkit_tpu_torch.parallel", "tp_routing_descriptor", "extra"):
        "the tensor-parallel routing of MAP and sampling, which JAX runs on one device",
}


def _public(mod) -> dict[str, object]:
    """A module's public names, with ``Jax`` read as ``Torch``: ``__all__``;
    else a package's names that are neither private nor modules, and a
    module's functions and classes defined in it."""
    names = getattr(mod, "__all__", None)
    if names is None:
        package = hasattr(mod, "__path__")
        names = [n for n, v in vars(mod).items()
                 if not n.startswith("_") and not inspect.ismodule(v)
                 and (package or getattr(v, "__module__", None) == mod.__name__)]
    return {n.replace("Jax", "Torch"): getattr(mod, n) for n in names}


def _signature(obj):
    if inspect.ismodule(obj) or not callable(obj):
        return None
    try:
        sig = inspect.signature(obj.__init__ if inspect.isclass(obj) else obj)
    except (TypeError, ValueError):
        return None
    return [(p.name, p.kind) for p in sig.parameters.values()]


@pytest.mark.parametrize("jax_name,port_name", API_MODULES, ids=[p for _, p in API_MODULES])
def test_public_names_and_signatures_match_jax(jax_name, port_name):
    """Every exported name of the JAX module has its counterpart in the port
    (``Jax`` read as ``Torch``) with the same parameter names and kinds, and
    the port exports nothing more, but for ``API_DIFFERENCES``."""
    ref, port = (_public(importlib.import_module(n)) for n in (jax_name, port_name))
    found = {(port_name, n, "missing") for n in ref.keys() - port.keys()}
    found |= {(port_name, n, "extra") for n in port.keys() - ref.keys()}
    found |= {(port_name, n, "signature") for n in ref.keys() & port.keys()
              if _signature(ref[n]) != _signature(port[n])}
    allowed = {k for k in API_DIFFERENCES if k[0] == port_name}
    assert found == allowed


def test_pipeline_context_takes_the_backend_name():
    """``PipelineContext(backend="jax", ...)`` compiles as the keywords alone
    do, positionally too; another backend name raises as JAX raises."""
    from cirkit_tpu_torch.models import image_data
    from cirkit_tpu_torch.pipeline import PipelineContext

    x = torch.as_tensor(np.random.default_rng(0).integers(0, 256, (6, 16)))
    outs = []
    for ctx in (PipelineContext(backend="jax", semiring="lse-sum", fold=True, optimize=True,
                                device="cpu", seed=3),
                PipelineContext("jax", semiring="lse-sum", fold=True, optimize=True,
                                device="cpu", seed=3),
                PipelineContext(semiring="lse-sum", fold=True, optimize=True, device="cpu",
                                seed=3)):
        sc = image_data((1, 4, 4), "quad-graph", input_layer="categorical",
                        num_input_units=4, sum_product_layer="tucker", num_sum_units=4)
        with torch.no_grad():
            outs.append(ctx.compile(sc)(x))
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    with pytest.raises(NotImplementedError, match="Backend 'torch' is not implemented"):
        PipelineContext(backend="torch", device="cpu")
    assert PipelineContext.from_default_backend.__func__  # the classmethod stays


def test_retrieve_compiler_maps_the_reference_name():
    from cirkit_tpu_torch.backend.torch.compiler import TorchCompiler
    from cirkit_tpu_torch.pipeline import retrieve_compiler

    cc = retrieve_compiler("jax", semiring="lse-sum", fold=True, optimize=True, device="cpu")
    assert isinstance(cc, TorchCompiler)
    with pytest.raises(NotImplementedError, match="Backend 'foo' is not implemented"):
        retrieve_compiler("foo")


def test_data_parallel_step_ignores_cache_token():
    """A step built with ``cache_token`` takes the same step, to the bit."""
    from cirkit_tpu_torch.models import image_data
    from cirkit_tpu_torch.parallel import data_parallel_step, split_trainable
    from cirkit_tpu_torch.pipeline import PipelineContext

    x = torch.as_tensor(np.random.default_rng(1).integers(0, 256, (8, 16)))
    results = []
    for token in (None, "x"):
        ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device="cpu", seed=5)
        cc = ctx.compile(image_data((1, 4, 4), "quad-graph", input_layer="categorical",
                                    num_input_units=4, sum_product_layer="cp", num_sum_units=4))
        tr, fr = split_trainable(cc, ctx.parameters)
        tr = {k: v.detach().clone().requires_grad_() for k, v in tr.items()}
        opt = torch.optim.SGD(list(tr.values()), lr=0.1)
        step = (data_parallel_step(cc, opt) if token is None
                else data_parallel_step(cc, opt, cache_token=token))
        loss = step(tr, fr, x)
        results.append((loss.detach(), {k: v.detach() for k, v in tr.items()}))
    (l0, s0), (l1, s1) = results
    assert torch.equal(l0, l1) and all(torch.equal(s0[k], s1[k]) for k in s0)
