"""The port's tensor parallelism (``cirkit_tpu_torch.parallel.tensor`` and the
``mesh=`` routing of ``MAPQuery``/``SamplingQuery``) on gloo CPU ranks,
against the JAX package's single-device runs in float64.

The circuits are the TP gradient grid of ``tests/parallel/test_tensor.py``
(Tucker, CP and CP-T over quad graphs and trees, an unoptimized plan, and
``units=6``, which divides two model ranks and not four) and the Gaussian
tabular circuit (mean and stddev shard together). The JAX side runs on one
device with no mesh; the ranks run once per mesh, (data, model) = (2, 2) and
(1, 4) (``tests/torch_ranks.py``, module-scoped fixtures). Each check is its
own test:

- ``tp_slot_specs`` and ``_plan_flags`` equal JAX's, for 2 and 4 shards;
- ``tp_forward`` of every rank's rows equal to JAX's ``cc.evaluate``
  (rtol 1e-9);
- the per-slot gradients of one ``tp_train_step`` with SGD(lr=1)
  (``old - new``) equal to ``jax.grad`` (rtol 1e-9, and 1e-9 of the slot's
  largest entry);
- ``MAPQuery(mesh=)`` at a 50% evidence mask: the assignment equal to
  JAX's, the values at 1e-9;
- ``SamplingQuery(mesh=)``'s conditional and unconditional samples equal to
  the port's single-device draws from the same seeds, to the bit (the
  conditional's log-evidence at 1e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.backend.jax import queries as JQ
from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.models import tabular_data as jax_tabular_data
from cirkit_tpu.parallel import tensor as jtensor
from cirkit_tpu.parallel.training import split_trainable as jax_split_trainable
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu_torch.backend.torch.queries import MAPQuery, SamplingQuery
from cirkit_tpu_torch.parallel import tensor as ttensor
from cirkit_tpu_torch.parallel.launch import run_ranks
from tests import torch_ranks

RTOL = 1e-9
CASES = {
    "tucker": ("image", "quad-graph", "tucker", 8, True, False),
    "cp": ("image", "quad-graph", "cp", 8, True, False),
    "cp-t": ("image", "quad-tree-2", "cp-t", 8, True, False),
    "cp-unoptimized": ("image", "quad-tree-4", "cp", 8, False, False),
    "units6": ("image", "random-binary-tree", "cp", 6, True, False),
    "gaussian": ("gaussian",),
}
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}


@pytest.fixture(autouse=True)
def _float64():
    # the port's constants take the default type
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _inputs(spec):
    rng = np.random.default_rng(len(spec[1]) if len(spec) > 1 else 9)
    if spec[0] == "gaussian":
        x = rng.normal(size=(8, 6))
    else:
        x = rng.integers(0, 256, (8, 16))
    return x, rng.random(x.shape) < 0.5


@pytest.fixture(scope="module")
def jax_side():
    """Per case: the JAX circuit, its float64 store as arrays and as JAX
    arrays, the inputs and the evidence mask."""
    out = {}
    for name, spec in CASES.items():
        sc, optimize = torch_ranks.circuit(spec, jax_image_data, jax_tabular_data)
        jctx = JaxPipelineContext(semiring="lse-sum", fold=True, optimize=optimize)
        jcc = jctx.compile(sc)
        arrays = {s: np.asarray(v, np.float64) for s, v in jctx.parameters.items()}
        out[name] = (jcc, arrays, {s: jnp.asarray(a) for s, a in arrays.items()},
                     *_inputs(spec))
    return out


@pytest.fixture(scope="module")
def ranks(jax_side):
    """Per mesh, per case: every rank's results."""
    cases = [(CASES[n], arrays, x, mask) for n, (_, arrays, _, x, mask) in jax_side.items()]
    out = {}
    for mesh_name, shape in MESHES.items():
        per_rank = run_ranks(torch_ranks.tp_checks, shape[0] * shape[1], shape, cases)
        out[mesh_name] = {n: [r[i] for r in per_rank] for i, n in enumerate(CASES)}
    return out


def _port(jax_side, name):
    return torch_ranks.port(CASES[name], jax_side[name][1])


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("name", list(CASES))
def test_slot_specs_and_plan_flags_equal_jax(jax_side, name, shards):
    jcc = jax_side[name][0]
    _, cc = _port(jax_side, name)
    specs = ttensor.tp_slot_specs(cc, shards)
    assert specs == jtensor.tp_slot_specs(jcc, shards)
    assert ttensor._plan_flags(cc, specs) == jtensor._plan_flags(jcc, specs)
    assert [ttensor._layer_sharded(e.layer, specs) for e in cc._entries] == \
        [jtensor._layer_sharded(e.layer, specs) for e in jcc._entries]
    if name == "units6" and shards == 4:
        assert not specs  # 6 units do not divide over 4 shards
    elif name != "units6":
        assert specs


def _by_coords(results):
    return {r["coords"]: r for r in results}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(CASES))
def test_forward_equals_jax(jax_side, ranks, name, mesh):
    jcc, _, jstore, x, _ = jax_side[name]
    want = np.asarray(jax.jit(jcc.evaluate)(jstore, jnp.asarray(x)))
    d, m = MESHES[mesh]
    res = _by_coords(ranks[mesh][name])
    for j in range(m):  # every model rank computes its data block's whole output
        got = torch.cat([res[(i, j)]["forward"] for i in range(d)]).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(CASES))
def test_train_step_gradients_equal_jax(jax_side, ranks, name, mesh):
    jcc, _, jstore, x, _ = jax_side[name]
    tr, fr = jax_split_trainable(jcc, jstore)
    jl, jgrads = jax.jit(jax.value_and_grad(
        lambda t: -jnp.mean(jcc.evaluate({**t, **fr}, jnp.asarray(x)))))(tr)
    res = _by_coords(ranks[mesh][name])
    m = MESHES[mesh][1]
    first = res[(0, 0)]
    np.testing.assert_allclose(first["loss"], float(jl), rtol=RTOL)
    assert set(first["grads"]) == set(jgrads)
    for k, want in jgrads.items():
        want = np.asarray(want)
        if first["specs"][k] == 1:
            got = torch.cat([res[(0, j)]["grads"][k] for j in range(m)], dim=1)
        else:
            got = first["grads"][k]
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                                   atol=RTOL * np.abs(want).max(), err_msg=k)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(CASES))
def test_map_equals_jax(jax_side, ranks, name, mesh):
    jcc, _, jstore, x, mask = jax_side[name]
    ja, jv = JQ.MAPQuery(jcc)(jnp.asarray(x), evidence_mask=mask, store=jstore)
    for r in ranks[mesh][name]:
        asg, val = r["map"]
        np.testing.assert_array_equal(asg.numpy(), np.asarray(ja))
        np.testing.assert_allclose(val.numpy(), np.asarray(jv), rtol=RTOL)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("name", list(CASES))
def test_sampling_equals_the_single_device_draws(jax_side, ranks, name, mesh):
    _, _, _, x, mask = jax_side[name]
    _, cc = _port(jax_side, name)
    q = SamplingQuery(cc)
    cond = q.conditional(torch.as_tensor(x), evidence_mask=torch.as_tensor(mask),
                         generator=torch.Generator().manual_seed(5))
    unc = q(4, generator=torch.Generator().manual_seed(6))[0]
    for r in ranks[mesh][name]:
        assert torch.equal(r["conditional"][0], cond[0])
        assert torch.equal(r["unconditional"], unc)
        # log p(x_obs): the local contractions may round otherwise
        np.testing.assert_allclose(r["conditional"][1].numpy(), cond[1].numpy(), rtol=RTOL,
                                   atol=RTOL)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_top_k_raises_on_a_mesh(ranks, mesh):
    for r in ranks[mesh]["tucker"]:
        assert r["top_k"] == "top_k is not supported on a tensor-parallel mesh"
