"""The model templates the port carries as copies (``models.pgms``,
``models.tensor_factorizations``, ``models.structure_learning``,
``models.logic``) compile in the port and evaluate as the JAX package's
circuits do, on the CPU in float64.

Each template is built by each package's own copy with the same arguments,
compiled (folded; optimized where stated), the JAX store is carried into
the port by slot name, and every world of a small domain (or a data batch)
goes through both at rtol 1e-9: ``hmm`` and ``fully_factorized``
(categorical, lse-sum), ``cp``, ``tucker`` and ``tensor_train``
(Embedding factors, sum-product), the probabilistic CP (softmax factors,
lse-sum), ``learn_spn`` on categorical and on Gaussian data, an SDD and a
PSDD compiled by ``models.logic``, and ``tensor_train`` with complex
parameters under ``complex-lse-sum`` (the quantum-MPS use: the amplitudes
and the squared circuit's probabilities).
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cirkit_tpu.models as JM
import cirkit_tpu_torch.models as TM
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu_torch.pipeline import PipelineContext


def _worlds(shape):
    return np.array(list(itertools.product(*(range(n) for n in shape))), dtype=np.int64)


def _compile_both(make, flags, square=False):
    """``make(models)`` compiled by both packages (and, with ``square``,
    each one's ``multiply(conjugate(cc), cc)``), the JAX store carried."""
    out = []
    for Ctx, models, kw in ((JaxPipelineContext, JM, {}),
                            (PipelineContext, TM, dict(device="cpu", seed=0))):
        ctx = Ctx(**flags, **kw)
        cc = ctx.compile(make(models))
        sq = ctx.multiply(ctx.conjugate(cc), cc) if square else None
        out.append((ctx, cc, sq))
    (jctx, jcc, jsq), (ctx, cc, sq) = out
    arrays = {s: np.asarray(v) for s, v in jctx.parameters.items()}
    ctx.load_parameters(arrays)
    return (jctx, jcc, jsq), (ctx, cc, sq)


def _assert_same(jcc, jctx, cc, x):
    want = np.asarray(jcc.evaluate(jctx.parameters, jnp.asarray(x)))
    with torch.no_grad():
        got = cc(torch.as_tensor(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-12)


def _data(seed, n=200, d=5, c=3):
    rng = np.random.default_rng(seed)
    z = rng.integers(0, 2, n)
    p = np.where(z[:, None] == 1, 0.8, 0.2)
    return np.minimum((rng.random((n, d)) < p).astype(np.int64) + rng.integers(0, 2, (n, d)),
                      c - 1)


def _param(models, **kw):
    return models.Parameterization(**kw)


# name -> (template call, compile flags, evaluation points)
CASES = {
    "hmm": (lambda M: M.hmm(list(range(4)), num_latent_states=3,
                            input_layer_kwargs={"num_categories": 2}),
            dict(semiring="lse-sum", fold=True), _worlds((2,) * 4)),
    "hmm-optimized": (lambda M: M.hmm([2, 0, 3, 1], num_latent_states=2,
                                      input_layer_kwargs={"num_categories": 3}),
                      dict(semiring="lse-sum", fold=True, optimize=True), _worlds((3,) * 4)),
    "fully-factorized": (
        lambda M: M.fully_factorized(3, input_layer_kwargs={"num_categories": 4}),
        dict(semiring="lse-sum", fold=True), _worlds((4,) * 3)),
    "cp": (lambda M: M.cp((3, 4, 5), 6), dict(semiring="sum-product", fold=True),
           _worlds((3, 4, 5))),
    "cp-probabilistic": (lambda M: M.cp((3, 4), 5, input_layer="categorical",
                                        input_params={"probs": _param(M, activation="softmax")},
                                        weight_param=_param(M, activation="softmax")),
                         dict(semiring="lse-sum", fold=True, optimize=True), _worlds((3, 4))),
    "tucker": (lambda M: M.tucker((3, 4), 3), dict(semiring="sum-product", fold=True),
               _worlds((3, 4))),
    "tucker-3": (lambda M: M.tucker((2, 3, 2), 2), dict(semiring="sum-product", fold=True,
                                                        optimize=True), _worlds((2, 3, 2))),
    "tensor-train": (lambda M: M.tensor_train((3, 4, 5), 2),
                     dict(semiring="sum-product", fold=True), _worlds((3, 4, 5))),
    "learn-spn": (lambda M: M.learn_spn(_data(1), num_categories=3, min_instances=40, seed=1),
                  dict(semiring="lse-sum", fold=True), _worlds((3,) * 5)),
    "learn-spn-gaussian": (
        lambda M: M.learn_spn(np.random.default_rng(3).normal(size=(150, 3)) * [1.0, 2.0, 0.5],
                              input_type="gaussian", min_instances=50, seed=3),
        dict(semiring="lse-sum", fold=True), np.random.default_rng(4).normal(size=(16, 3))),
}


@pytest.mark.parametrize("name", list(CASES))
def test_template_matches_jax(name):
    make, flags, x = CASES[name]
    (jctx, jcc, _), (ctx, cc, _) = _compile_both(make, flags)
    _assert_same(jcc, jctx, cc, x)


SDD_TEXT = """c (x0 and x1) or (not x0 and x2)
sdd 6
L 1 0 1
L 2 2 2
L 3 0 -1
L 4 4 3
D 0 1 2 1 2 3 4
"""
# vtree ((1,2),3); D5 = 0.6 (x1 and Bern(x2; .3)) + 0.4 (not x1 and Bern(x2; .9))
PSDD_TEXT = """psdd 7
L 0 0 1
L 1 0 -1
T 2 1 2 {l3}
T 3 1 2 {l9}
T 4 2 3 {l8}
D 5 3 2 0 2 {l6} 1 3 {l4}
D 6 4 1 5 4 0.0
""".format(l3=np.log(0.3), l9=np.log(0.9), l8=np.log(0.8), l6=np.log(0.6), l4=np.log(0.4))


@pytest.mark.parametrize("kind", ["sdd", "psdd"])
def test_logic_circuits_match_jax(kind, tmp_path):
    """``tests/models/test_logic.py``'s SDD and ``test_psdd.py``'s PSDD,
    loaded and lowered by each package's ``models.logic``."""
    path = tmp_path / f"c.{kind}"
    path.write_text(SDD_TEXT if kind == "sdd" else PSDD_TEXT)

    def make(models):
        cls = models.logic.SDD if kind == "sdd" else models.logic.PSDD
        return cls.load(str(path)).build_circuit()

    flags = dict(semiring="sum-product" if kind == "sdd" else "lse-sum", fold=True)
    (jctx, jcc, _), (ctx, cc, _) = _compile_both(make, flags)
    _assert_same(jcc, jctx, cc, _worlds((2,) * 3))


def test_complex_tensor_train_matches_jax():
    """Complex TT cores under ``complex-lse-sum``: the amplitudes and the
    squared circuit's values, against JAX's complex128."""

    def make(models):
        return models.tensor_train((2, 3, 2), 2,
                                   factor_param=models.Parameterization(dtype="complex"))

    (jctx, jcc, jsq), (ctx, cc, sq) = _compile_both(
        make, dict(semiring="complex-lse-sum", fold=True), square=True)
    x = _worlds((2, 3, 2))
    _assert_same(jcc, jctx, cc, x)
    _assert_same(jsq, jctx, sq, x)
    with torch.no_grad():
        assert cc(torch.as_tensor(x)).dtype == torch.complex128
