"""The port's npz checkpoints (``cirkit_tpu_torch.utils.checkpoint``)
against the JAX package's (``cirkit_tpu.utils.checkpoint``), on the CPU:
a store saved by either loads in the other by slot name, the data
fingerprints agree, and bfloat16 leaves round-trip. The port's
``save_circuit``/``load_circuit`` round-trip learned, pruned and
operator-derived circuits, and read a circuit file the JAX package wrote
without importing JAX."""

import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.utils import checkpoint as J
from cirkit_tpu_torch.utils import checkpoint as T


def _store(seed=0):
    rng = np.random.default_rng(seed)
    return {f"p{i}": rng.normal(size=(3, 2, 4)) for i in (12, 3, 40)}


def test_jax_store_loads_in_the_port(tmp_path):
    arrays = _store()
    J.save_store(tmp_path / "s.npz", {k: jnp.asarray(v) for k, v in arrays.items()})
    plain = T.load_store(tmp_path / "s.npz")
    assert set(plain) == set(arrays)
    like = {k: torch.zeros(v.shape, dtype=torch.float64) for k, v in arrays.items()}
    loaded = T.load_store(tmp_path / "s.npz", like=like)
    for k, v in arrays.items():
        np.testing.assert_array_equal(plain[k], v)
        assert isinstance(loaded[k], torch.Tensor) and loaded[k].dtype == torch.float64
        np.testing.assert_array_equal(loaded[k].numpy(), v)


def test_port_store_loads_in_jax(tmp_path):
    arrays = _store(1)
    tree = {"store": {k: torch.as_tensor(v) for k, v in arrays.items()},
            "steps": [np.int64(3), torch.tensor(2.5)]}
    T.save_store(tmp_path / "s.npz", tree)
    back = J.load_store(tmp_path / "s.npz")
    for k, v in arrays.items():
        np.testing.assert_array_equal(back["store"][k], v)
    assert int(back["steps"][0]) == 3 and float(back["steps"][1]) == 2.5
    with np.load(tmp_path / "s.npz") as data:
        assert '[["d", "store"], ["d", "p12"]]' in data.files


@pytest.mark.parametrize("shape,dtype", [((7, 5), np.int64), ((3 << 18,), np.float32),
                                         ((0, 4), np.uint8)])
def test_data_fingerprint_equals_jax(shape, dtype):
    data = np.random.default_rng(2).integers(0, 255, shape).astype(dtype)
    fp = T.data_fingerprint(data)
    assert isinstance(fp, np.uint64) and fp == J.data_fingerprint(data)
    assert T.data_fingerprint(data[::-1].copy()) != fp or data.size <= 1 or shape[0] == 0


def test_bf16_leaves_round_trip(tmp_path):
    mu = torch.randn(4, 8).to(torch.bfloat16)
    T.save_store(tmp_path / "m.npz", {"mu": mu})
    with np.load(tmp_path / "m.npz") as data:
        assert data['[["d", "mu"]]'].dtype == np.float32  # widened: npz has no bf16
    back = T.load_store(tmp_path / "m.npz", like={"mu": torch.zeros(4, 8, dtype=torch.bfloat16)})
    assert back["mu"].dtype == torch.bfloat16 and torch.equal(back["mu"], mu)


def test_load_with_like_rebuilds_structure_and_checks_paths(tmp_path):
    tree = {"a": [torch.ones(2), (np.zeros(3), np.float64(1.5))], "b": torch.arange(3)}
    T.save_store(tmp_path / "t.npz", tree)
    like = {"a": [torch.zeros(2), (np.zeros(3, np.float32), np.float64(0))], "b": torch.zeros(3)}
    back = T.load_store(tmp_path / "t.npz", like=like)
    assert isinstance(back["a"][1], tuple) and back["a"][1][0].dtype == np.float32
    assert back["b"].dtype == torch.float32 and torch.equal(back["b"], torch.arange(3.0))
    with pytest.raises(KeyError, match="no entry"):
        T.load_store(tmp_path / "t.npz", like={"c": torch.zeros(1)})


def test_training_state_is_atomic_and_optional(tmp_path):
    path = tmp_path / "ck"
    assert T.training_state_path(path) == str(path) + ".npz"
    assert T.load_training_state(path) is None
    T.save_training_state(path, {"step": np.int64(4), "w": torch.ones(2)})
    assert not (tmp_path / "ck.npz.tmp.npz").exists()
    state = T.load_training_state(path)
    assert int(state["step"]) == 4 and np.array_equal(state["w"], np.ones(2))
    assert J.load_training_state(path, like={"step": np.int64(0), "w": jnp.zeros(2)}) is not None


# --------------------------------------------------------------------------- #
# save_circuit / load_circuit (tests/test_serialization_io.py:155-234)
# --------------------------------------------------------------------------- #


@pytest.fixture
def float64_default():
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _forward(sc, x, **flags):
    from cirkit_tpu_torch.pipeline import PipelineContext

    ctx = PipelineContext(semiring="lse-sum", fold=True, device="cpu", **flags)
    with torch.no_grad():
        return ctx.compile(sc)(torch.as_tensor(x)).numpy()


def test_circuit_roundtrip_learned_structures(tmp_path, float64_default):
    """A LearnSPN circuit and a pruned one reload in the port and compile to
    the same distribution; a file that is not a circuit raises JAX's error."""
    import itertools

    from cirkit_tpu_torch.backend.torch import prune_circuit
    from cirkit_tpu_torch.models import learn_spn
    from cirkit_tpu_torch.pipeline import PipelineContext

    data = np.random.default_rng(5).integers(0, 3, size=(300, 4))
    sc = learn_spn(data, input_type="categorical", min_instances=50, seed=0)
    T.save_circuit(tmp_path / "spn.ckt", sc)
    worlds = np.array(list(itertools.product(range(3), repeat=4)))
    np.testing.assert_allclose(_forward(T.load_circuit(tmp_path / "spn.ckt"), worlds),
                               _forward(sc, worlds), rtol=1e-12)

    ctx = PipelineContext(semiring="lse-sum", fold=True, device="cpu")
    ctx.compile(sc)
    pruned, _ = prune_circuit(sc, ctx=ctx, threshold=1e-4)
    T.save_circuit(tmp_path / "pruned.ckt", pruned)
    np.testing.assert_allclose(_forward(T.load_circuit(tmp_path / "pruned.ckt"), worlds),
                               _forward(pruned, worlds), rtol=1e-12)

    T.save_store(tmp_path / "x.npz", {"a": np.zeros(2)})
    for load in (T.load_circuit, J.load_circuit):
        with pytest.raises(ValueError, match="not a cirkit-tpu circuit"):
            load(tmp_path / "x.npz")
    with open(tmp_path / "d.pkl", "wb") as fh:
        pickle.dump({"format": "other"}, fh)
    with pytest.raises(ValueError, match="not a cirkit-tpu circuit"):
        T.load_circuit(tmp_path / "d.pkl")


def test_circuit_roundtrip_partial_overlap_product(tmp_path, float64_default):
    """An operator-derived partial-overlap product reloads and compiles, in
    the port, to the JAX reference evaluator's distribution."""
    import itertools

    import cirkit_tpu.symbolic.functional as JSF
    import cirkit_tpu_torch.symbolic.functional as TSF
    from tests.reference_eval import eval_circuit
    from tests.test_fuzz_circuits import _restrict_tree, _tree_pc

    tree = ((0, 1), (2, (3, 4)))
    jsc1 = _tree_pc(_restrict_tree(tree, {0, 1, 2, 3}), 2, 31, 41)
    jsc2 = _tree_pc(_restrict_tree(tree, {2, 3, 4}), 3, 51, 61)
    worlds = np.array(list(itertools.product(range(2), repeat=5)), dtype=np.int64)
    want = eval_circuit(JSF.multiply(jsc1, jsc2), worlds)[:, 0, 0]
    # the operands cross by a JAX-written file, the product is the port's
    J.save_circuit(tmp_path / "ops.ckt", (jsc1, jsc2))
    psc = TSF.multiply(*T.load_circuit(tmp_path / "ops.ckt"))
    T.save_circuit(tmp_path / "prod.ckt", psc)
    got = np.exp(_forward(T.load_circuit(tmp_path / "prod.ckt"), worlds, optimize=True))
    np.testing.assert_allclose(got[:, 0, 0], want, rtol=1e-9)


def test_full_persistence_flow_template_circuit(tmp_path):
    """A template circuit and its store saved by the port reload in a fresh
    context (slot names allocate in a fixed order) with the same forward."""
    from cirkit_tpu_torch.models import image_data
    from cirkit_tpu_torch.pipeline import PipelineContext

    sc = image_data((1, 4, 4), "quad-tree-2", input_layer="categorical", num_input_units=3,
                    sum_product_layer="cp", num_sum_units=3)
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device="cpu")
    cc = ctx.compile(sc)
    x = torch.as_tensor(np.random.default_rng(1).integers(0, 256, size=(5, 16)))
    with torch.no_grad():
        before = cc(x)
    T.save_circuit(tmp_path / "c.ckt", sc)
    T.save_store(tmp_path / "s.npz", dict(ctx.parameters))
    ctx2 = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device="cpu")
    cc2 = ctx2.compile(T.load_circuit(tmp_path / "c.ckt"))
    store = T.store_from_numpy(T.load_store(tmp_path / "s.npz"), device="cpu")
    with torch.no_grad():
        after = cc2(cc2.restrict_store(store), x)
    assert torch.equal(before, after)


def test_jax_written_circuit_loads_without_jax(tmp_path):
    """A circuit file the JAX package wrote (it names ``cirkit_tpu.symbolic``
    and ``cirkit_tpu.utils.scope`` classes) loads in the port in a process
    where neither ``jax`` nor ``cirkit_tpu`` is ever imported, and compiles
    to JAX's forward."""
    import subprocess
    import sys
    from pathlib import Path

    from cirkit_tpu.models import image_data
    from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext

    sc = image_data((1, 4, 4), "quad-tree-2", input_layer="categorical", num_input_units=3,
                    sum_product_layer="tucker", num_sum_units=3)
    jctx = JaxPipelineContext(semiring="lse-sum", fold=True, optimize=True, seed=4)
    jcc = jctx.compile(sc)
    x = np.random.default_rng(2).integers(0, 256, size=(6, 16))
    want = np.asarray(jcc(jctx.parameters, jnp.asarray(x)))
    J.save_circuit(tmp_path / "c.ckt", sc)
    J.save_store(tmp_path / "s.npz", dict(jctx.parameters))
    np.save(tmp_path / "x.npy", x)
    assert b"cirkit_tpu.symbolic" in (tmp_path / "c.ckt").read_bytes()
    code = f"""
import sys, numpy as np, torch
torch.set_default_dtype(torch.float64)
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.utils.checkpoint import load_circuit, load_store
d = {str(tmp_path)!r}
sc = load_circuit(d + "/c.ckt")
assert type(sc).__module__ == "cirkit_tpu_torch.symbolic.circuit", type(sc)
ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, device="cpu")
cc = ctx.compile(sc)
ctx.load_parameters({{k: np.asarray(v, np.float64) for k, v in load_store(d + "/s.npz").items()}})
with torch.no_grad():
    np.save(d + "/got.npy", cc(torch.as_tensor(np.load(d + "/x.npy"))).numpy())
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "cirkit_tpu.")))
assert not bad, bad
"""
    root = Path(__file__).resolve().parents[1]
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_allclose(np.load(tmp_path / "got.npy"), want, rtol=1e-9)
