"""The port's serving utilities against the JAX package's, on the CPU:
``weight_slots``, ``bf16_weight_store``, the queries on a bf16 store, and
``export_circuit`` / ``load_exported`` (``tests/backend/test_serving.py``'s
cases).

Each circuit is compiled in both packages from the same template at
``image_data((1, 4, 4), ...)`` with K=4; slot names agree, so the JAX store
carries into the port by name (``store_from_numpy``), a JAX bf16 store
widened to float32 on the way, exactly.
"""

import io
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.backend.jax import bf16_weight_store as jax_bf16_weight_store
from cirkit_tpu.backend.jax import weight_slots as jax_weight_slots
from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu_torch.backend.torch import (
    IntegrateQuery,
    MAPQuery,
    bf16_weight_store,
    export_circuit,
    load_exported,
    weight_slots,
)
from cirkit_tpu_torch.models import image_data
from cirkit_tpu_torch.ops import lse_einsum as T
from cirkit_tpu_torch.pipeline import PipelineContext
from cirkit_tpu_torch.utils.checkpoint import store_from_numpy


def _kw(sp):
    return dict(input_layer="categorical", num_input_units=4, sum_product_layer=sp,
                num_sum_units=4)


def _both(sp, optimize=True, seed=4):
    jctx = JaxPipelineContext(semiring="lse-sum", fold=True, optimize=optimize, seed=seed)
    jcc = jctx.compile(jax_image_data((1, 4, 4), "quad-graph", **_kw(sp)))
    ctx, cc = _port(sp, optimize)
    return jctx, jcc, ctx, cc


def _port(sp, optimize=True):
    ctx = PipelineContext(semiring="lse-sum", fold=True, optimize=optimize, seed=0, device="cpu")
    return ctx, ctx.compile(image_data((1, 4, 4), "quad-graph", **_kw(sp)))


def _jax_store(jcc, jctx):
    return {k: jnp.asarray(v, jnp.float32) for k, v in jcc.restrict_store(jctx.parameters).items()}


def _carried(store) -> dict[str, torch.Tensor]:
    """A JAX store as the port's float32 tensors, by slot name (a bf16 slot
    widened exactly)."""
    return store_from_numpy({k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in store.items()},
                            device="cpu")


def _batch(n=16, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=(n, 16))


@pytest.fixture(autouse=True)
def _no_launches(monkeypatch):
    monkeypatch.delenv("CIRKIT_TPU_FAST", raising=False)
    monkeypatch.delenv("CIRKIT_TPU_FORCE_PALLAS", raising=False)
    for op in T.LAUNCHES:
        T.LAUNCHES[op] = 0
    yield
    assert all(n == 0 for n in T.LAUNCHES.values()), "a CPU test launched a kernel"


@pytest.mark.parametrize("optimize", [True, False])
@pytest.mark.parametrize("sp", ["cp", "tucker"])
def test_weight_slots_match_jax(sp, optimize):
    jctx, jcc, ctx, cc = _both(sp, optimize)
    slots = weight_slots(cc)
    assert slots and slots == jax_weight_slots(jcc)


@pytest.mark.parametrize("sp", ["cp", "tucker"])
def test_bf16_weight_store_matches_jax_to_the_bit(sp):
    jctx, jcc, ctx, cc = _both(sp)
    jstore = _jax_store(jcc, jctx)
    store = _carried(jstore)
    jbf = jax_bf16_weight_store(jcc, jstore)
    bf = bf16_weight_store(cc, store)
    slots = weight_slots(cc)
    assert set(bf) == set(store)
    for k, v in bf.items():
        if k in slots:
            assert v.dtype == torch.bfloat16 and jbf[k].dtype == jnp.bfloat16
            want = np.asarray(jbf[k]).view(np.uint16)
            np.testing.assert_array_equal(v.view(torch.int16).numpy().view(np.uint16), want)
        else:
            assert v.dtype == store[k].dtype and torch.equal(v, store[k])


@pytest.mark.parametrize("sp", ["cp", "tucker"])
def test_bf16_store_forward_matches_jax(sp):
    """The bf16-store forward in the f32-grade mode against JAX's (its XLA
    fallback) to rtol 1e-5, and both within the round-to-nearest bf16
    weight grade (``atol`` 2e-2) of the float32-store forward."""
    jctx, jcc, ctx, cc = _both(sp)
    jstore = _jax_store(jcc, jctx)
    jbf = jax_bf16_weight_store(jcc, jstore)
    x = _batch()
    want = np.asarray(jcc.evaluate(jbf, jnp.asarray(x, jnp.int32)))
    want32 = np.asarray(jcc.evaluate(jstore, jnp.asarray(x, jnp.int32)))
    bf = bf16_weight_store(cc, _carried(jstore))
    with torch.no_grad():
        got = cc.evaluate(bf, torch.as_tensor(x)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(got, want32, atol=2e-2)
    np.testing.assert_allclose(want, want32, atol=2e-2)


def test_bf16_store_queries_run():
    """``IntegrateQuery`` and ``MAPQuery`` on a bf16 CP store (their
    kernels without a bf16 instance widen the weights)."""
    ctx, cc = _port("cp")
    store = bf16_weight_store(cc, cc.restrict_store(ctx.parameters))
    x = torch.as_tensor(_batch(4, seed=1))
    mask = torch.zeros((4, 16), dtype=torch.bool)
    mask[:, :8] = True
    marg = IntegrateQuery(cc)(x, integrate_vars=mask, store=store)
    assert torch.isfinite(marg).all()
    _, val = MAPQuery(cc)(x, evidence_mask=~mask, store=store)
    assert torch.isfinite(val).all()


def test_export_roundtrip_store_swap_and_integrate(tmp_path):
    """The artifact reproduces ``evaluate`` bitwise, replays on a new store
    of the same shapes, and the integrate variant carries runtime evidence
    masks into serving."""
    ctx, cc = _port("tucker")
    rng = np.random.default_rng(8)
    x = torch.as_tensor(rng.integers(0, 256, size=(4, 16)))
    store = {k: v.detach() for k, v in cc.restrict_store(ctx.parameters).items()}
    blob = export_circuit(cc, x, store=ctx.parameters)
    assert isinstance(blob, bytes) and len(blob) < 5_000_000
    # the store is an argument: the artifact carries no parameter and no
    # float constant (the context binds its store to the circuit as a module)
    program = torch.export.load(io.BytesIO(blob))
    assert not program.state_dict and cc.default_store is ctx.parameters
    assert not any(t.is_floating_point() for t in program.constants.values())
    fn = load_exported(blob)
    with torch.no_grad():
        assert torch.equal(fn(store, x), cc.evaluate(store, x))
        # replay on a different parameterization without re-exporting
        store2 = {k: torch.randn_like(v) if v.is_floating_point() else v
                  for k, v in store.items()}
        assert torch.equal(fn(store2, x), cc.evaluate(store2, x))
    fn_m = load_exported(export_circuit(cc, x, store=ctx.parameters, query="integrate"))
    mask = torch.as_tensor(rng.random((4, 16)) < 0.5)
    want = IntegrateQuery(cc)(x, integrate_vars=mask, store=store)
    np.testing.assert_allclose(fn_m(store, x, mask).numpy(), want.detach().numpy(),
                               rtol=1e-6, atol=1e-12)
    with pytest.raises(ValueError, match="Unknown query"):
        export_circuit(cc, x, store=ctx.parameters, query="sample")


def test_export_platforms_name_the_tracing_device():
    ctx, cc = _port("cp")
    x = torch.as_tensor(_batch(2))
    export_circuit(cc, x, store=ctx.parameters, platforms=("cpu",))
    for bad in (("cpu", "cuda"), ("tpu",)):
        with pytest.raises(ValueError, match="platforms"):
            export_circuit(cc, x, store=ctx.parameters, platforms=bad)
    with pytest.raises(ValueError, match="traced where they are"):
        export_circuit(cc, x, store=ctx.parameters, platforms="cuda")


def test_cpu_export_loads_without_the_port_or_jax(tmp_path):
    """A CPU-traced artifact of a bf16 store's forward loads and runs in a
    process that never imports ``cirkit_tpu_torch`` or JAX, to the bit."""
    ctx, cc = _port("tucker")
    x = torch.as_tensor(_batch(4, seed=3))
    store = bf16_weight_store(cc, {k: v.detach() for k, v in
                                   cc.restrict_store(ctx.parameters).items()})
    (tmp_path / "prog.pt2").write_bytes(export_circuit(cc, x, store=store))
    torch.save({"store": store, "x": x}, tmp_path / "ins.pt")
    code = (
        "import sys, torch\n"
        "fn = torch.export.load('prog.pt2').module()\n"
        "ins = torch.load('ins.pt')\n"
        "torch.save(fn(ins['store'], ins['x']), 'out.pt')\n"
        "assert not any(m.split('.')[0] in ('cirkit_tpu_torch', 'jax', 'cirkit_tpu') "
        "for m in sys.modules), 'the port or jax imported'\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    with torch.no_grad():
        want = cc.evaluate(store, x)
    assert torch.equal(torch.load(tmp_path / "out.pt"), want)


@pytest.mark.parametrize("op", ["lse_matmul", "lse_tucker2_softmax"])
def test_launches_go_through_the_operator_only_under_a_tracer(op):
    """An eager tensor calls its kernel's launcher directly (the operator's
    dispatch would cost every launch host time); ``torch.export``'s tensors
    reach the launch operator, which it records as one node. Meta tensors
    stand for the card's: the trace never launches."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    assert not T._traced(torch.zeros(2))
    assert not T._traced(torch.nn.Parameter(torch.zeros(2)))
    with FakeTensorMode():
        assert T._traced(torch.zeros(2))
    if op == "lse_matmul":
        ins = (torch.empty(3, 5, 4, device="meta"), torch.empty(3, 6, 4, device="meta"))
    else:
        ins = (torch.empty(3, 5, 2, device="meta"), torch.empty(3, 5, 3, device="meta"),
               torch.empty(3, 6, 6, device="meta"))

    class Fwd(torch.nn.Module):
        def forward(self, *ins):
            return getattr(T, op)(*ins)

    ep = torch.export.export(Fwd(), ins)
    calls = [n.target for n in ep.graph.nodes if n.op == "call_function"]
    assert calls == [torch.ops.cirkit_tpu_torch.lse_fwd.default]
    assert ep.module()(*ins).shape == (3, 5, 6)
