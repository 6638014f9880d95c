"""The port's data parallelism, ZeRO-1, distributed fit, EM and checkpoints
(``cirkit_tpu_torch.parallel`` with ``mesh=``) on gloo CPU ranks, against
the JAX package's single-device runs in float64.

The ranks run once per topology (``tests/torch_ranks.py`` through
``parallel.launch.run_ranks``, module-scoped fixtures): two ranks for the
steps, the trainers and the checkpoint writes, four for reading the
checkpoint back. Each check is its own test:

- the data-parallel and ZeRO-1 steps (Adam, and ``adam_lowmem`` with float32
  state) against JAX's ``data_parallel_step`` with ``optax.adam`` over 3
  steps (rtol 1e-8; ``adam_lowmem``'s float32 update within 2e-8 absolute),
  and the ZeRO-1 steps equal to the data-parallel ones to the bit; ZeRO-1 ``adam_lowmem`` with bfloat16 state equal to the
  bit to the port's single-device optimizer run on the gradient the two
  ranks average; the ZeRO-1 state of a slot whose fold axis divides the
  mesh is 1/N per rank;
- a weighted step whose zero-weight padding sits on one rank only, a
  ``marginalize_missing`` step and ``evaluate_ll`` against JAX (1e-8);
- ``fit(mesh=)`` against the port's single-device ``fit`` (1e-9) and JAX's
  ``fit`` on one unshuffled batch (1e-8); a run killed and resumed from its
  checkpoint equal to the uninterrupted one to the bit, with Adam and with
  ``adam_lowmem``;
- ``em_programs(mesh=)``'s flows and ``fit_em(mesh=)`` against JAX (1e-9);
- the ZeRO-1 state written by ``save_checkpoint`` at two ranks read back by
  ``load_checkpoint`` at one (no process group) and at four ranks, to the
  bit, the four ranks' placement that of ``zero1_state_shardings`` and
  ``shard_opt_state_zero1``;
- the errors of JAX's divisibility checks and of ``zero1`` without a mesh.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.models import tabular_data as jax_tabular_data
from cirkit_tpu.parallel import data_parallel_step as jax_step
from cirkit_tpu.parallel import em as jem
from cirkit_tpu.parallel import evaluate_ll as jax_evaluate_ll
from cirkit_tpu.parallel import fit as jax_fit
from cirkit_tpu.parallel.training import split_trainable as jax_split_trainable
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu_torch.parallel import data_parallel_step, fit, split_trainable
from cirkit_tpu_torch.parallel.launch import run_ranks
from cirkit_tpu_torch.utils.checkpoint import load_checkpoint
from tests import torch_ranks

RTOL = 1e-8


@pytest.fixture(autouse=True)
def _float64():
    # the port's constants take the default type
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(torch.float32)


def _jax(spec):
    sc, optimize = torch_ranks.circuit(spec, jax_image_data, jax_tabular_data)
    jctx = JaxPipelineContext(semiring="lse-sum", fold=True, optimize=optimize)
    jcc = jctx.compile(sc)
    arrays = {s: np.asarray(v) for s, v in jctx.parameters.items()}
    arrays = {s: a.astype(np.float64) if a.dtype.kind == "f" else a for s, a in arrays.items()}
    return jcc, arrays, {s: jnp.asarray(a) for s, a in arrays.items()}


def _data():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (8, 16))
    return {
        "x": x,
        # the zero-weight padding of a partial batch sits on the second rank only
        "weights": np.asarray([1.0, 2.0, 1.0, 0.5, 1.0, 1.0, 0.0, 0.0]),
        "missing": rng.random((8, 16)) < 0.3,
        "eval": rng.integers(0, 256, (7, 16)),
        "fit": rng.integers(0, 256, (12, 16)),
        "em": rng.integers(0, 256, (16, 16)),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two-rank run of every check, the four-rank checkpoint read, and
    the JAX stores they started from."""
    ckdir = str(tmp_path_factory.mktemp("dist"))
    jcc, arrays, jstore = _jax(torch_ranks.DP_SPEC)
    em_jcc, em_arrays, em_jstore = _jax(torch_ranks.EM_SPEC)
    data = _data()
    two = run_ranks(torch_ranks.dp_checks, 2, arrays, em_arrays, data, ckdir)
    written = _whole(two)
    four = run_ranks(torch_ranks.dcp_load, 4, written, ckdir)
    return dict(two=two, four=four, written=written, jcc=jcc, jstore=jstore, arrays=arrays,
                em_jcc=em_jcc, em_jstore=em_jstore, em_arrays=em_arrays, data=data,
                ckdir=ckdir)


def _whole(two):
    """The ZeRO-1 state the two ranks wrote, as whole tensors: a sharded
    slot's state is rank 0's rows then rank 1's."""
    tr = two[0]["written"]["trainable"]
    state = {
        k: {key: torch.cat([r["written"]["opt_state"][k][key] for r in two])
            if v.dim() >= 1 and tr[k].shape[0] % 2 == 0 else v for key, v in st.items()}
        for k, st in two[0]["written"]["opt_state"].items()
    }
    return {"trainable": tr, "opt_state": state}


def _close(got, want, rtol=RTOL, err=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=0,
                               err_msg=err)


def _equal_stores(a, b):
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k


def _jax_steps(runs, opt, steps=3, weights=None, missing=None):
    jcc, jstore = runs["jcc"], runs["jstore"]
    tr, fr = jax_split_trainable(jcc, jstore)
    tr = {k: jnp.array(v) for k, v in tr.items()}  # the step donates its buffers
    step = jax_step(jcc, opt, weighted=weights is not None,
                    marginalize_missing=missing is not None)
    st = opt.init(tr)
    x = jnp.asarray(runs["data"]["x"])
    extra = [jnp.asarray(a) for a in (weights, missing) if a is not None]
    losses = []
    for _ in range(steps):
        tr, st, loss = step(tr, fr, st, x, *extra)
        losses.append(float(loss))
    return losses, tr


def _check_steps(got, want, atol=0.0):
    losses, store = got
    jlosses, jstore = want
    _close(losses, jlosses)
    assert set(store) == set(jstore)
    for k in store:
        np.testing.assert_allclose(np.asarray(store[k]), np.asarray(jstore[k]), rtol=RTOL,
                                   atol=atol, err_msg=k)


# adam_lowmem computes its moments and update in float32: its float64
# parameters move by float32-rounded steps of lr = 1e-2 (about 1e-9 each)
LOWMEM_ATOL = 2e-8


@pytest.mark.parametrize("zero1", [False, True], ids=["dp", "zero1"])
@pytest.mark.parametrize("opt", ["adam", "lowmem_f32"])
def test_steps_match_jax(runs, opt, zero1):
    want = _jax_steps(runs, optax.adam(1e-2))
    for r in runs["two"]:
        _check_steps(r[f"steps:{opt}:{zero1}"], want, 0.0 if opt == "adam" else LOWMEM_ATOL)


def test_zero1_steps_equal_the_data_parallel_steps(runs):
    # two ranks: a reduce-scatter and an all-reduce add the same two terms
    for r in runs["two"]:
        for opt in ("adam", "lowmem_f32"):
            dp, zero = r[f"steps:{opt}:False"], r[f"steps:{opt}:True"]
            assert dp[0] == zero[0]
            _equal_stores(dp[1], zero[1])


def test_ranks_hold_the_same_store(runs):
    a, b = runs["two"]
    for key in ("steps:adam:True", "steps:lowmem_f32:True", "fit", "fit_em"):
        _equal_stores(a[key][1], b[key][1])
    _equal_stores(a["zero1_bf16"], b["zero1_bf16"])


def test_zero1_lowmem_bf16_equals_single_device_to_the_bit(runs):
    r0 = runs["two"][0]
    _equal_stores(r0["zero1_bf16"], r0["zero1_bf16_reference"])


def test_zero1_state_is_sharded_where_the_fold_axis_divides(runs):
    r0 = runs["two"][0]
    tr = runs["written"]["trainable"]
    sharded = 0
    for k, rows in r0["zero1_local_rows"].items():
        folds = tr[k].shape[0]
        want = folds // 2 if folds % 2 == 0 else folds
        assert rows and all(n == want for n in rows), k
        sharded += folds % 2 == 0
    assert sharded > 0
    for rank in runs["four"]:
        for k, st in rank["opt_state"].items():
            folds = tr[k].shape[0]
            for v in st.values():
                if torch.is_tensor(v) and v.dim() >= 1:
                    assert v.shape[0] == (folds // 4 if folds % 4 == 0 else folds), k


def test_weighted_step_with_padding_on_one_rank(runs):
    w = runs["data"]["weights"]
    want = _jax_steps(runs, optax.adam(1e-2), steps=1, weights=w)
    for r in runs["two"]:
        _check_steps(r["weighted"], want)


def test_weighted_step_matches_the_single_device_port(runs):
    from tests.torch_ranks import port

    ctx, cc = port(torch_ranks.DP_SPEC, runs["arrays"])
    tr, fr = split_trainable(cc, ctx.parameters)
    tr = {k: v.detach().clone().requires_grad_() for k, v in tr.items()}
    step = data_parallel_step(cc, torch.optim.Adam(list(tr.values()), lr=1e-2), weighted=True)
    loss = step(tr, fr, torch.as_tensor(runs["data"]["x"]),
                torch.as_tensor(runs["data"]["weights"]))
    losses, store = runs["two"][1]["weighted"]
    _close(losses, [float(loss)], rtol=1e-12)
    for k in store:
        _close(store[k], tr[k].detach(), rtol=1e-10, err=k)


def test_marginalize_missing_step(runs):
    want = _jax_steps(runs, optax.adam(1e-2), steps=1, missing=runs["data"]["missing"])
    for r in runs["two"]:
        _check_steps(r["missing"], want)


def test_evaluate_ll(runs):
    want = jax_evaluate_ll(runs["jcc"], runs["data"]["eval"], store=runs["jstore"], batch_size=4)
    for r in runs["two"]:
        _close(r["evaluate_ll"], want)


def test_fit_matches_the_single_device_port(runs):
    from tests.torch_ranks import _adam, port

    ctx, cc = port(torch_ranks.DP_SPEC, runs["arrays"])
    store, losses = fit(cc, runs["data"]["fit"], store=dict(ctx.parameters), num_epochs=2,
                        batch_size=4, seed=3, optimizer=_adam)
    got_losses, got_store = runs["two"][0]["fit"]
    assert len(got_losses) == len(losses) == 6
    _close(got_losses, losses, rtol=1e-9)
    for k in got_store:
        _close(got_store[k], store[k].detach(), rtol=1e-9, err=k)


def test_fit_matches_jax_on_one_unshuffled_batch(runs):
    x = runs["data"]["x"]
    jnew, jlosses = jax_fit(runs["jcc"], x, store=runs["jstore"], batch_size=len(x),
                            shuffle=False, optimizer=optax.adam(1e-2))
    losses, store = runs["two"][0]["fit_one_batch"]
    _close(losses, jlosses)
    for k in store:
        _close(store[k], jnew[k], err=k)


@pytest.mark.parametrize("opt", ["adam", "lowmem_bf16"])
def test_resume_under_a_mesh_to_the_bit(runs, opt):
    for r in runs["two"]:
        (full_store, full_losses), (store, losses) = r[f"resume:{opt}"]
        assert losses == full_losses and len(losses) == 6
        _equal_stores(store, full_store)


def test_em_flows_match_jax(runs):
    jcc, jstore = runs["em_jcc"], runs["em_jstore"]
    fs, _, st = jem.em_programs(jcc, jstore)
    x = runs["data"]["em"][:8]
    (jflows, jacc_g, jacc_o), jll = fs(st["em_params"], st["gauss_params"], st["zero_acc"](),
                                       jnp.zeros(()), jnp.asarray(x), jnp.ones(8))
    for r in runs["two"]:
        (flows, acc_g, acc_o), ll = r["em_flows"]
        _close(ll, jll, rtol=1e-9)
        assert set(flows) == set(jflows) and flows
        for k in flows:
            _close(flows[k], jflows[k], rtol=1e-9, err=k)


def test_fit_em_matches_jax(runs):
    jnew, jlosses = jem.fit_em(runs["em_jcc"], runs["data"]["em"], store=runs["em_jstore"],
                               num_epochs=2, batch_size=8, update_every="batch", step_size=0.5)
    for r in runs["two"]:
        losses, store = r["fit_em"]
        _close(losses, jlosses, rtol=1e-9)
        for k in jnew:
            _close(store[k], jnew[k], rtol=1e-9, err=k)


def test_checkpoint_written_at_two_ranks_reads_at_one(runs):
    want = runs["written"]
    got = load_checkpoint(runs["ckdir"] + "/dcp", {**want, "step": 0})
    assert got["step"] == 3
    _equal_stores(got["trainable"], want["trainable"])
    for k, st in want["opt_state"].items():
        _equal_stores(got["opt_state"][k], st)
    tree = load_checkpoint(runs["ckdir"] + "/dcp")  # no like: the structure from the keys
    assert int(tree["step"]) == 3
    _equal_stores(tree["trainable"], want["trainable"])


def test_checkpoint_written_at_two_ranks_reads_at_four(runs):
    want = runs["written"]
    for r in runs["four"]:
        assert r["step"] == 3
        _equal_stores(r["trainable"], want["trainable"])
        for k, st in want["opt_state"].items():
            for key, v in st.items():
                got = r["opt_state"][k][key]
                if torch.is_tensor(v) and v.dim() >= 1 and v.shape[0] % 4 == 0:
                    n = v.shape[0] // 4
                    v = v[r["rank"] * n : (r["rank"] + 1) * n]
                assert torch.equal(torch.as_tensor(got), torch.as_tensor(v)), (k, key)
                # shard_opt_state_zero1 of the whole state places it alike
                assert torch.equal(torch.as_tensor(r["sharded"][k][key]),
                                   torch.as_tensor(v)), (k, key)


@pytest.mark.parametrize("call", ["fit", "evaluate_ll", "fit_em"])
def test_batch_size_must_divide_over_the_mesh(runs, call):
    assert runs["two"][0]["errors"][call] == (
        "The batch size must divide evenly across the mesh devices")


def test_zero1_requires_a_mesh():
    from tests.torch_ranks import port

    _, arrays, _ = _jax(torch_ranks.DP_SPEC)
    ctx, cc = port(torch_ranks.DP_SPEC, arrays)
    with pytest.raises(ValueError, match="zero1=True requires a device mesh"):
        data_parallel_step(cc, torch_ranks._adam, zero1=True)


def test_no_stale_distribution_guard_is_left():
    """Every ``mesh=`` path is ported: no module of the port still raises,
    or says, that distribution waits for its ROADMAP item."""
    import pathlib

    import cirkit_tpu_torch

    root = pathlib.Path(cirkit_tpu_torch.__file__).parent
    stale = [str(p.relative_to(root)) for p in root.rglob("*.py")
             if "item 12" in p.read_text() or "_single_device" in p.read_text()]
    assert stale == []


def test_default_mesh_never_falls_back_to_the_cpu():
    from cirkit_tpu_torch.parallel import default_mesh

    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        default_mesh()
