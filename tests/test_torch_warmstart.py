"""The port's warm-start bundles, the cases of
``tests/backend/test_warmstart.py`` on the CPU: the save/load round trip,
the integrate and extra programs, ``init`` against a cold compile's store to
the bit, a training step built on the bundled circuit against the cold one
to the bit, and the refusals (a missing bundle, an operator-derived circuit,
a corrupt program or bundle file, a torch or package version that differs). The bundle's
forward is also held against the JAX package's on the same store, carried
by slot name.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu_torch.backend.torch.queries import masked_evaluate
from cirkit_tpu_torch.backend.torch.warmstart import WarmStartError, load_bundle, save_bundle
from cirkit_tpu_torch.models import image_data
from cirkit_tpu_torch.ops import lse_einsum as T
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.utils.checkpoint import store_from_numpy

_KW = dict(input_layer="categorical", num_input_units=4, sum_product_layer="cp",
           num_sum_units=4)


def _circuit(seed=7):
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=True, seed=seed, device="cpu")
    return ctx, ctx.compile(image_data((1, 4, 4), "quad-tree-4", **_KW))


def _batch(seed, n=8):
    return torch.as_tensor(np.random.default_rng(seed).integers(0, 256, (n, 16)))


@pytest.fixture(autouse=True)
def _no_launches():
    for op in T.LAUNCHES:
        T.LAUNCHES[op] = 0
    yield
    assert all(n == 0 for n in T.LAUNCHES.values()), "a CPU test launched a kernel"


@pytest.fixture(scope="module")
def bundle_dir(tmp_path_factory):
    """One saved bundle shared across the module (every test below only
    reads it)."""
    ctx, cc = _circuit()
    path = tmp_path_factory.mktemp("warm") / "bundle"
    manifest = save_bundle(
        path, cc, store=dict(ctx.parameters), batch=8, with_integrate=True,
        extra_programs={"double": (lambda a: a * 2.0, (torch.zeros(3),))},
    )
    return path, ctx, cc, manifest


def _clone(path: Path, dest: Path) -> Path:
    dest.mkdir()
    for f in path.iterdir():
        (dest / f.name).write_bytes(f.read_bytes())
    return dest


def test_roundtrip_evaluate_matches_direct_and_jax(bundle_dir):
    path, ctx, cc, _ = bundle_dir
    b = load_bundle(path)
    store = {k: v.detach() for k, v in cc.restrict_store(ctx.parameters).items()}
    x = _batch(0)
    with torch.no_grad():
        got = b.evaluate(store, x)
        assert torch.equal(got, cc.evaluate(store, x))
    # the JAX package's circuit on the same store, carried by slot name
    jctx = JaxPipelineContext(semiring="lse-sum", fold=True, optimize=True, seed=7)
    jcc = jctx.compile(jax_image_data((1, 4, 4), "quad-tree-4", **_KW))
    want = jcc.evaluate({k: jnp.asarray(v.numpy()) for k, v in store.items()},
                        jnp.asarray(x.numpy(), jnp.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


def test_bundled_integrate_matches_masked_evaluate(bundle_dir):
    path, ctx, cc, _ = bundle_dir
    b = load_bundle(path)
    store = cc.restrict_store(ctx.parameters)
    x = _batch(1)
    mask = torch.zeros((8, 16), dtype=torch.bool)
    mask[:, ::2] = True
    with torch.no_grad():
        assert torch.equal(b.integrate(store, x, mask), masked_evaluate(cc, store, x, mask))


def test_init_equals_the_cold_store_and_spec_complete(bundle_dir):
    """``init(seed)`` equals a cold ``PipelineContext(seed=seed)`` compile's
    store to the bit, repeats, and differs across seeds; a bundle-drawn
    store is a working store for the real circuit."""
    path, ctx, cc, manifest = bundle_dir
    b = load_bundle(path)
    s1, s2, s3 = b.init(7), b.init(7), b.init(1)
    spec = manifest["store_spec"]
    assert set(s1) == set(spec)
    for k, v in s1.items():
        assert list(v.shape) == spec[k]["shape"]
        assert str(v.dtype).removeprefix("torch.") == spec[k]["dtype"]
        assert torch.equal(v, s2[k])
        assert torch.equal(v, ctx.parameters[k].detach())
    cold, _ = _circuit(seed=1)
    assert all(torch.equal(s3[k], cold.parameters[k].detach()) for k in s3)
    assert any(not torch.equal(s1[k], s3[k]) for k in s1), "seeds must draw different stores"
    with torch.no_grad():
        assert torch.equal(b.evaluate(s1, _batch(2)), cc.evaluate(s1, _batch(2)))


def test_extra_programs_exposed(bundle_dir):
    path, *_ = bundle_dir
    b = load_bundle(path)
    assert torch.equal(b.double(torch.tensor([1.0, 2.0, 3.0])), torch.tensor([2.0, 4.0, 6.0]))


def test_bundled_train_step_matches_direct(tmp_path):
    """A warm training start: the bundle carries the compiled circuit, and a
    ``data_parallel_step`` built on it (no compile) takes the cold step's
    loss and updated parameters to the bit."""
    from cirkit_tpu_torch.parallel.training import data_parallel_step, split_trainable

    ctx, cc = _circuit(seed=21)
    path = tmp_path / "train_bundle"
    save_bundle(path, cc, store=dict(ctx.parameters), batch=8)
    b = load_bundle(path)
    x = _batch(5)

    def run(circuit, store):
        trainable, frozen = split_trainable(circuit, store)
        trainable = {k: v.detach().clone().requires_grad_() for k, v in trainable.items()}
        frozen = {k: v.detach() for k, v in frozen.items()}
        opt = torch.optim.Adam(list(trainable.values()), lr=0.05)
        loss = data_parallel_step(circuit, opt)(trainable, frozen, x)
        return loss, trainable

    loss_b, tr_b = run(b.circuit, b.init(21))
    loss_d, tr_d = run(cc, dict(ctx.parameters))
    assert torch.equal(loss_b, loss_d)
    assert set(tr_b) == set(tr_d) and all(torch.equal(tr_b[k], tr_d[k]) for k in tr_d)


def test_missing_bundle_raises(tmp_path):
    with pytest.raises(WarmStartError, match="No warm-start bundle"):
        load_bundle(tmp_path / "nope")


def test_operator_derived_circuit_rejected_at_save(tmp_path):
    """multiply(cc, cc) evaluates through pointer slots owned by the source
    circuit; a bundle's init() could never redraw its store, so save fails."""
    ctx = PipelineContext(semiring="lse-sum", fold=True, seed=1, device="cpu")
    kw = {**_KW, "num_input_units": 2, "num_sum_units": 2}
    cc = ctx.compile(image_data((1, 4, 4), "quad-tree-4", **kw))
    cc_sq = ctx.multiply(cc, cc)
    assert set(cc_sq.used_slots) - set(cc_sq.slots), "the product must point at cc's slots"
    with pytest.raises(WarmStartError, match="operator-derived"):
        save_bundle(tmp_path / "sq", cc_sq, store=dict(ctx.parameters), batch=4)


def test_corrupt_program_raises(bundle_dir, tmp_path):
    path, *_ = bundle_dir
    clone = _clone(path, tmp_path / "corrupt")
    prog = clone / "evaluate.pt2"
    prog.write_bytes(prog.read_bytes()[:-100])
    with pytest.raises(WarmStartError, match="corrupt"):
        load_bundle(clone)


@pytest.mark.parametrize("name", ["circuit.pkl", "consts.npz"])
def test_corrupt_bundle_file_raises(bundle_dir, tmp_path, name):
    """The pickled circuit and the constants are checked against the
    manifest's sha256 too: a modified file is refused before it is read."""
    path, *_ = bundle_dir
    clone = _clone(path, tmp_path / "corrupt")
    f = clone / name
    blob = bytearray(f.read_bytes())
    blob[len(blob) // 2] ^= 1
    f.write_bytes(bytes(blob))
    with pytest.raises(WarmStartError, match=f"{name}.*corrupt"):
        load_bundle(clone)


def test_fingerprint_mismatch_raises(bundle_dir, tmp_path):
    path, *_ = bundle_dir
    for field, stale in (("torch", "0.0.0"), ("device_kind", "TPU v5 lite"),
                         ("capability", "8.0")):
        clone = _clone(path, tmp_path / f"stale-{field}")
        m = json.loads((clone / "manifest.json").read_text())
        m[field] = stale
        (clone / "manifest.json").write_text(json.dumps(m))
        with pytest.raises(WarmStartError, match=f"{field} mismatch"):
            load_bundle(clone)


def test_package_version_mismatch_raises(bundle_dir, tmp_path):
    """A bundle saved by another package version, or by one without the
    version field, is refused."""
    path, *_ = bundle_dir
    for stale in ("0.0.9", None):
        clone = _clone(path, tmp_path / f"pkg-{stale}")
        m = json.loads((clone / "manifest.json").read_text())
        assert "cirkit_tpu_torch" in m
        if stale is None:
            del m["cirkit_tpu_torch"]
        else:
            m["cirkit_tpu_torch"] = stale
        (clone / "manifest.json").write_text(json.dumps(m))
        with pytest.raises(WarmStartError, match="cirkit_tpu_torch mismatch"):
            load_bundle(clone)


def test_const_slots_ship_in_npz(tmp_path):
    """Constant-initialized slots ride the npz and reload bit-exact. A logic
    WMC circuit's indicator weights are all constant, so its whole store is
    constant slots."""
    from cirkit_tpu_torch.models.logic import (
        ConjunctionNode,
        DisjunctionNode,
        LiteralNode,
        LogicalCircuit,
    )

    x0, x1 = LiteralNode(0), LiteralNode(1)
    c = ConjunctionNode()
    root = DisjunctionNode()
    lc = LogicalCircuit([x0, x1, c, root], {c: [x0, x1], root: [c]}, [root])
    ctx = PipelineContext(semiring="lse-sum", fold=True, seed=3, device="cpu")
    cc = ctx.compile(lc.build_circuit())
    manifest = save_bundle(tmp_path / "bundle", cc, store=dict(ctx.parameters), batch=4)
    assert manifest["const_slots"] and not manifest["random_slots"]
    b = load_bundle(tmp_path / "bundle")
    store = b.init(0)
    ref = cc.restrict_store(ctx.parameters)
    for s in manifest["const_slots"]:
        assert torch.equal(store[s], ref[s].detach())
    x = torch.as_tensor(np.random.default_rng(3).integers(0, 2, (4, 2)))
    with torch.no_grad():
        assert torch.equal(b.evaluate(store, x), cc.evaluate(ref, x))
    # the npz carries the port's store by name, as checkpoints do
    carried = store_from_numpy({k: v.numpy() for k, v in store.items()}, device="cpu")
    assert all(torch.equal(carried[k], store[k]) for k in store)
