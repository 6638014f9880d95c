"""The port's max-product and routing ops (``cirkit_tpu_torch.ops.routing``)
against the JAX package's Pallas kernels, on the CPU.

The plain versions ``tropical_tucker2_ref`` and ``route_tucker2_ref`` (what
the ops run on CPU tensors) take the same float32 inputs, made with numpy,
as ``cirkit_tpu.ops.lse_einsum.tropical_tucker2`` and ``route_tucker2`` in
interpret mode (``CIRKIT_TPU_FORCE_PALLAS=1``), at F=3, K=O=16 (the
smallest shape the JAX kernels take: M % 128 == 0) and B in {8, 13}, the
tropical one also taken in 3 ranges of m as the kernel's split path:

- tropical values to rtol = atol = 1e-5 (the two add the three terms in
  different orders, and JAX splits them into bf16 thirds);
- route indices by the score of the choice: the float64 scores at either
  index lie within ``1e-5 |max| + 1e-5`` of the maximum, since f32
  rounding may flip an argmax between two nearly equal scores.

The edge cases of ``tests/ops/test_lse_einsum.py:697-745`` (-inf children,
zero linear weights, -inf logits) are held against JAX or the exact
answer, and the ``"sample"`` kind, which the JAX kernel cannot run off the
TPU, against the exact distribution ``softmax(scores)`` by frequencies.
"""

import numpy as np
import pytest
import torch

from cirkit_tpu.ops import lse_einsum as L
from cirkit_tpu_torch.ops import routing as R

F, K, O = 3, 16, 16


@pytest.fixture(autouse=True)
def _pallas_interpret(monkeypatch):
    monkeypatch.setenv("CIRKIT_TPU_FORCE_PALLAS", "1")
    for op in R.LAUNCHES:
        R.LAUNCHES[op] = 0
    yield
    assert all(n == 0 for n in R.LAUNCHES.values()), "a CPU tensor launched a kernel"


def _rand(rng, shape, scale=1.0, shift=0.0):
    return (rng.standard_normal(shape) * scale + shift).astype(np.float32)


def _weights(rng, shape):
    return rng.uniform(0.01, 1.0, shape).astype(np.float32)


def _inputs(seed, b, log_weights, k1=K, k2=K, o=O, f=F):
    rng = np.random.default_rng(seed)
    x1 = _rand(rng, (f, b, k1), scale=4.0, shift=-10.0)
    x2 = _rand(rng, (f, b, k2), scale=4.0, shift=-10.0)
    th = _rand(rng, (f, o, k1 * k2), scale=1.5) if log_weights else _weights(rng, (f, o, k1 * k2))
    sel = rng.integers(0, o, (f, b))
    return x1, x2, th, sel


def _t(*arrays):
    return [torch.as_tensor(a) for a in arrays]


def _check_choice(idx, x1, x2, th, sel, log_weights):
    """The float64 scores at ``idx`` are within 1e-5 |max| + 1e-5 of the max;
    returns the scores."""
    scores = R.route_scores(*_t(x1.astype(np.float64), x2.astype(np.float64),
                                th.astype(np.float64), sel), log_weights=log_weights).numpy()
    best = scores.max(axis=-1)
    got = np.take_along_axis(scores, np.asarray(idx)[..., None].astype(np.int64), -1)[..., 0]
    assert (got >= best - (1e-5 * np.abs(best) + 1e-5)).all()
    return scores


@pytest.mark.parametrize("splits", [None, 3], ids=["whole", "split3"])
@pytest.mark.parametrize("b", [8, 13])
@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
def test_tropical_ref_matches_jax_kernel(b, log_weights, splits):
    """The plain max-plus, whole and taken in 3 ranges of m combined by max
    (the kernel's split path, ``tropical_tucker2_split_ref``), against the
    Pallas kernel."""
    x1, x2, th, _ = _inputs(72, b, log_weights)
    want = L.tropical_tucker2(*map(np.asarray, (x1, x2, th)), log_weights=log_weights)
    assert want is not None  # the Pallas kernel ran (interpret mode)
    got = R.tropical_tucker2(*_t(x1, x2, th), log_weights=log_weights, splits=splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, R.tropical_tucker2_ref(*_t(x1, x2, th),
                                                           log_weights=log_weights))


@pytest.mark.parametrize("b", [8, 13])
@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
def test_route_max_ref_matches_jax_kernel(b, log_weights):
    x1, x2, th, sel = _inputs(70, b, log_weights)
    want = L.route_tucker2(x1, x2, th, sel.astype(np.int32), kind="max",
                           log_weights=log_weights)
    assert want is not None
    got = R.route_tucker2(*_t(x1, x2, th, sel), kind="max", log_weights=log_weights)
    assert got.dtype == torch.int64 and got.shape == (F, b)
    _check_choice(got, x1, x2, th, sel, log_weights)
    _check_choice(np.asarray(want), x1, x2, th, sel, log_weights)
    # on random scores no two are within the bound: the indices agree
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_route_max_with_neg_inf_children_matches_jax():
    rng = np.random.default_rng(73)
    x1, x2 = _rand(rng, (2, 8, K), 2.0, -5.0), _rand(rng, (2, 8, K), 2.0, -5.0)
    x1[0, 3, 5] = -np.inf
    x1[1, 0, :8] = -np.inf
    th = _rand(rng, (2, O, K * K))
    sel = rng.integers(0, O, (2, 8))
    want = np.asarray(L.route_tucker2(x1, x2, th, sel.astype(np.int32), kind="max",
                                      log_weights=True))
    got = R.route_tucker2(*_t(x1, x2, th, sel), kind="max", log_weights=True).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[1, 0] // K >= 8)  # a -inf child never wins


def test_tropical_with_neg_inf_children_matches_jax():
    rng = np.random.default_rng(76)
    x1, x2 = _rand(rng, (2, 8, K), 2.0, -5.0), _rand(rng, (2, 8, K), 2.0, -5.0)
    x1[0, 3, 5] = -np.inf
    x2[1, 0, :8] = -np.inf
    th = _rand(rng, (2, O, K * K))
    want = np.asarray(L.tropical_tucker2(x1, x2, th, log_weights=True))
    got = R.tropical_tucker2(*_t(x1, x2, th), log_weights=True).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.isfinite(got).all()


def test_route_zero_linear_weights_are_never_chosen():
    """Weight mass only on composite (1, 1), whose composite is -400; (0, 0)
    has composite 0 but zero weight and must never win (log 0 = -inf)."""
    f, b, k, o = 1, 8, 16, 8
    x1 = np.full((f, b, k), -200.0, np.float32)
    x1[:, :, 0] = 0.0
    x2 = x1.copy()
    th = np.zeros((f, o, k * k), np.float32)
    th[:, :, k + 1] = 1.0
    sel = np.zeros((f, b), np.int64)
    want = np.asarray(L.route_tucker2(x1, x2, th, sel.astype(np.int32), kind="max",
                                      log_weights=False))
    got = R.route_tucker2(*_t(x1, x2, th, sel), kind="max", log_weights=False).numpy()
    np.testing.assert_array_equal(got, np.full((f, b), k + 1))
    np.testing.assert_array_equal(got, want)
    # and the tropical value is that composite's, not log(0) + 0
    val = R.tropical_tucker2(*_t(x1, x2, th), log_weights=False).numpy()
    np.testing.assert_allclose(val, -400.0)


def test_route_max_with_neg_inf_logits_matches_jax():
    rng = np.random.default_rng(74)
    x1, x2 = _rand(rng, (2, 8, K), 2.0, -5.0), _rand(rng, (2, 8, K), 2.0, -5.0)
    th = _rand(rng, (2, O, K * K))
    th[0, 5, 7] = -np.inf
    th[1, :, 100] = -np.inf
    sel = rng.integers(0, O, (2, 8))
    want = np.asarray(L.route_tucker2(x1, x2, th, sel.astype(np.int32), kind="max",
                                      log_weights=True))
    got = R.route_tucker2(*_t(x1, x2, th, sel), kind="max", log_weights=True).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[1] != 100).all()


@pytest.mark.parametrize("log_weights", [True, False], ids=["logits", "linear"])
def test_route_sample_frequencies_match_softmax(log_weights):
    """The plain Gumbel draws over N identical rows against the exact
    distribution ``softmax(scores)``, each frequency within 5 standard
    errors plus 1e-3."""
    n, k1, k2, o = 20000, 4, 4, 8
    x1, x2, th, _ = _inputs(80, 1, log_weights, k1=k1, k2=k2, o=o, f=2)
    sel = np.array([[3], [6]])
    scores = R.route_scores(*_t(x1.astype(np.float64), x2.astype(np.float64),
                                th.astype(np.float64), sel), log_weights=log_weights)
    p = torch.softmax(scores[:, 0], dim=-1).numpy()  # (2, M)
    rows = [torch.as_tensor(a).expand(-1, n, -1).contiguous() for a in (x1, x2)]
    idx = R.route_tucker2(rows[0], rows[1], torch.as_tensor(th),
                          torch.as_tensor(sel).expand(-1, n).contiguous(), kind="sample",
                          log_weights=log_weights, seed=123)
    for ff in range(2):
        freq = np.bincount(idx[ff].numpy(), minlength=k1 * k2) / n
        tol = 5 * np.sqrt(p[ff] * (1 - p[ff]) / n) + 1e-3
        assert (np.abs(freq - p[ff]) <= tol).all(), (freq, p[ff])


def test_route_sample_is_reproducible_by_seed():
    x1, x2, th, sel = _inputs(81, 64, True)
    args = _t(x1, x2, th, sel)
    a = R.route_tucker2(*args, kind="sample", log_weights=True, seed=7)
    b = R.route_tucker2(*args, kind="sample", log_weights=True, seed=7)
    c = R.route_tucker2(*args, kind="sample", log_weights=True, seed=8)
    assert torch.equal(a, b) and not torch.equal(a, c)
    gen = torch.Generator().manual_seed(7)
    ref = R.route_tucker2_ref(*args, kind="sample", log_weights=True, generator=gen)
    assert torch.equal(a, ref)


def test_route_clamps_the_selected_unit():
    x1, x2, th, sel = _inputs(82, 8, True)
    sel[0, :4] = -1
    sel[1, :4] = O + 5
    got = R.route_tucker2(*_t(x1, x2, th, sel), kind="max", log_weights=True)
    want = R.route_tucker2(*_t(x1, x2, th, np.clip(sel, 0, O - 1)), kind="max",
                           log_weights=True)
    assert torch.equal(got, want)


def test_ops_validate_their_arguments():
    x1, x2, th, sel = _t(*_inputs(83, 8, True))
    with pytest.raises(ValueError, match="kind"):
        R.route_tucker2(x1, x2, th, sel, kind="argmax", log_weights=True)
    with pytest.raises(ValueError, match="seed"):
        R.route_tucker2(x1, x2, th, sel, kind="sample", log_weights=True)
    with pytest.raises(ValueError, match="integer"):
        R.route_tucker2(x1, x2, th, sel.double(), kind="max", log_weights=True)
    with pytest.raises(ValueError, match="integer"):
        R.route_tucker2(x1, x2, th, sel[:, :4], kind="max", log_weights=True)
    with pytest.raises(ValueError, match="Expected"):
        R.tropical_tucker2(x1, x2, th[:, :, :100], log_weights=True)


def test_max_plus_chunks_over_output_units(monkeypatch):
    """The plain max-plus version gives the same values whatever its chunk
    of output units (one unit per chunk here, as at the flagship)."""
    x1, x2, th, _ = _t(*_inputs(84, 5, True))
    whole = R.tropical_tucker2_ref(x1, x2, th, log_weights=True)
    monkeypatch.setattr(R, "_CHUNK", 1)
    torch.testing.assert_close(R.tropical_tucker2_ref(x1, x2, th, log_weights=True), whole,
                               rtol=0, atol=0)
