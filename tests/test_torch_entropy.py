"""The port's ``EntropyQuery``, ``KLDivergenceQuery`` and ``renyi2_entropy``
(``cirkit_tpu_torch.backend.torch.entropy``) against the JAX package's
(``cirkit_tpu.backend.jax.entropy``), on the CPU in float64.

The circuits are those of ``tests/backend/test_entropy.py``: a
deterministic two-variable circuit (folded and not), the non-deterministic
deep categorical circuit (the latent bound), the Gaussian mixture, the
posterior entropies under evidence, the optimized 4x4 ``image_data`` plans
(``tucker``, ``cp``, ``cp-t``) with their log-partitions, and the logic
circuit ``(x0 and x1) or (not x0 and x2)`` compiled through each package's
``models.logic``, whose entropy is log 4. KL runs between the store and a
perturbed copy (categorical leaf rows renormalized), between a store and
itself (0), and across a support gap (``+inf``); Rényi-2 on the
non-deterministic, the conditional and the Gaussian circuits, with each
product circuit built before the store is carried. Everything is held to JAX
at rtol 1e-9 (plus 1e-12 absolute where a value is 0).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cirkit_tpu.models.logic as JL
import cirkit_tpu_torch.models.logic as TL
from cirkit_tpu.backend.jax import entropy as JE
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu_torch.backend.torch import (
    EntropyQuery,
    KLDivergenceQuery,
    renyi2_entropy,
)
from cirkit_tpu_torch.backend.torch.layers import TorchCategoricalLayer
from cirkit_tpu_torch.backend.torch.parameters import TorchTensorSlot
from cirkit_tpu_torch.pipeline import PipelineContext
from tests.test_torch_expectation import (
    JAX,
    PORT,
    assert_close,
    compile_both,
    const,
    deep_pc,
    gmm,
    image,
)


def deterministic_pc(S, Sc, rng):
    """2 variables, 2 units per leaf on disjoint supports (unit 0 on states
    {0, 1}, unit 1 on {2, 3}), a Hadamard product and a sum root."""

    def leaf(v):
        a, b = rng.uniform(0.2, 0.8, size=2)
        probs = np.array([[a, 1 - a, 0.0, 0.0], [0.0, 0.0, b, 1 - b]])
        return S.CategoricalLayer(Sc([v]), 2, num_categories=4, probs=const(S, probs))

    leaves = [leaf(0), leaf(1)]
    prod = S.HadamardLayer(2, arity=2)
    root = S.SumLayer(2, 1, weight=const(S, rng.dirichlet(np.ones(2))[None]))
    return S.Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])


def logic_pc(S, Sc, rng):
    """``(x0 and x1) or (not x0 and x2)``: the disjuncts split on x0."""
    L = JL if S is JAX[0] else TL
    x0, x1, x2 = L.LiteralNode(0), L.LiteralNode(1), L.LiteralNode(2)
    nx0 = L.NegatedLiteralNode(0)
    c1, c2, root = L.ConjunctionNode(), L.ConjunctionNode(), L.DisjunctionNode()
    lc = L.LogicalCircuit([x0, x1, x2, nx0, c1, c2, root],
                          {c1: [x0, x1], c2: [nx0, x2], root: [c1, c2]}, [root])
    return lc.build_circuit(enforce_smoothness=True)


def gaussian_product(S, Sc, rng):
    """One Gaussian unit per variable under a product and a unit sum."""
    sds = rng.uniform(0.5, 2.0, size=2)
    leaves = [S.GaussianLayer(Sc([v]), 1, mean=const(S, [0.1]), stddev=const(S, [sds[v]]))
              for v in range(2)]
    prod = S.HadamardLayer(1, arity=2)
    root = S.SumLayer(1, 1, weight=const(S, [[1.0]]))
    return S.Circuit(leaves + [prod, root], {prod: leaves, root: [prod]}, [root])


def _normalized_leaf_slots(cc):
    """The slots that probs-parameterized categorical leaves assume
    normalized."""
    return {n.slot for layer in cc.layers if isinstance(layer, TorchCategoricalLayer)
            and layer.logits is None for n in layer.probs.nodes
            if isinstance(n, TorchTensorSlot)}


def _perturbed(ctx, cc, seed, scale=0.4):
    """A multiplicatively perturbed copy of the store: zeros stay zero (the
    supports, hence determinism, are kept) and categorical rows are
    renormalized. Returns (jax store, port store)."""
    rng = np.random.default_rng(seed)
    renorm = _normalized_leaf_slots(cc)
    out = {}
    for k, v in cc.restrict_store(ctx.parameters).items():
        a = v.detach().numpy()
        if a.dtype.kind == "f":
            a = a * np.exp(rng.uniform(-scale, scale, a.shape))
            if k in renorm:
                a = a / a.sum(axis=-1, keepdims=True)
        out[k] = a
    return {k: jnp.asarray(a) for k, a in out.items()}, {k: torch.as_tensor(a)
                                                          for k, a in out.items()}


# --------------------------------------------------------------------------- #
# EntropyQuery
# --------------------------------------------------------------------------- #

# name -> (circuit, seed, compile flags, (x, evidence) or None)
ENTROPY = {
    "deterministic": (deterministic_pc, 43, {}, None),
    "deterministic-unfolded": (deterministic_pc, 43, {"fold": False}, None),
    "nondeterministic": (deep_pc(4, 3, 2), 46, {}, None),
    "gaussian": (gmm, 70, {}, None),
    "conditional": (deterministic_pc, 47, {},
                    (np.array([[0, 0], [2, 0], [1, 3]]), np.array([[True, False]] * 3))),
    "conditional-deep": (deep_pc(4, 3, 2), 46, {},
                         (np.array([[0, 1, 0, 1], [1, 0, 0, 0]]),
                          np.array([[True, False, True, False], [False] * 4]))),
    "image-tucker": (image("tucker", 8), 17, {"optimize": True}, None),
    "image-cp": (image("cp", 8), 17, {"optimize": True}, None),
    "image-cp-t": (image("cp-t", 8), 17, {"optimize": True}, None),
    "logic": (logic_pc, 0, {}, None),
}


@pytest.mark.parametrize("name", list(ENTROPY))
def test_entropy_matches_jax(name):
    build, seed, flags, ev = ENTROPY[name]
    jcc, jstore, ctx, cc = compile_both(build, seed, **flags)
    args, kw = ((), {}) if ev is None else ((ev[0],), {"evidence_mask": ev[1]})
    h, lz = EntropyQuery(cc)(*args, return_log_partition=True, **kw)
    jh, jlz = JE.EntropyQuery(jcc)(*args, store=jstore, return_log_partition=True, **kw)
    assert h.shape == jh.shape
    assert_close(h, jh, atol=1e-12)
    assert_close(lz, jlz, atol=1e-12)  # log Z = 0 for a normalized circuit
    if name == "logic":
        assert_close(h[0, 0], np.log(4.0))  # 4 models, uniform


def test_entropy_errors():
    ctx = PipelineContext(semiring="sum-product", fold=True, device="cpu", seed=0)
    cc = ctx.compile(deterministic_pc(*PORT, np.random.default_rng(44)))
    with pytest.raises(ValueError, match="lse-sum"):
        EntropyQuery(cc)
    ctx2 = PipelineContext(semiring="lse-sum", fold=True, device="cpu", seed=0)
    cc2 = ctx2.compile(deterministic_pc(*PORT, np.random.default_rng(44)))
    with pytest.raises(ValueError, match="requires x|evidence_mask"):
        EntropyQuery(cc2)(evidence_mask=np.zeros((1, 2), bool))
    with pytest.raises(ValueError, match="evidence_mask"):
        EntropyQuery(cc2)(np.zeros((1, 2)))


# --------------------------------------------------------------------------- #
# KLDivergenceQuery
# --------------------------------------------------------------------------- #

KL = {
    "deterministic": (deterministic_pc, 45, {}, None),
    "nondeterministic": (deep_pc(4, 3, 2), 46, {}, None),
    "conditional": (deterministic_pc, 47, {},
                    (np.array([[0, 0], [2, 0]]), np.array([[True, False]] * 2))),
    "gaussian": (gmm, 48, {}, None),
    "image-tucker": (image("tucker"), 3, {"optimize": True}, None),
}


@pytest.mark.parametrize("name", list(KL))
def test_kl_matches_jax(name):
    build, seed, flags, ev = KL[name]
    jcc, jstore, ctx, cc = compile_both(build, seed, **flags)
    jq, tq = _perturbed(ctx, cc, seed + 100)
    args, kw = ((), {}) if ev is None else ((ev[0],), {"evidence_mask": ev[1]})
    got = KLDivergenceQuery(cc)(ctx.parameters, tq, *args, **kw)
    want = JE.KLDivergenceQuery(jcc)(jstore, jq, *args, **kw)
    assert got.shape == want.shape
    assert_close(got, want)
    assert torch.isfinite(got).all()
    # a store against itself: 0
    assert_close(KLDivergenceQuery(cc)(ctx.parameters, ctx.parameters, *args, **kw), 0.0,
                 atol=1e-12)


def test_kl_support_gap_is_infinite():
    """q puts zero mass on a state p reaches: ``+inf``, as in JAX."""
    jcc, jstore, ctx, cc = compile_both(deterministic_pc, 45)
    slot = sorted(_normalized_leaf_slots(cc))[0]
    q = {k: v.detach().clone() for k, v in cc.restrict_store(ctx.parameters).items()}
    q[slot][..., 0, 0] = 0.0
    q[slot][..., 0, 1] = 1.0
    jq = {k: jnp.asarray(v.numpy()) for k, v in q.items()}
    got = KLDivergenceQuery(cc)(ctx.parameters, q)
    want = JE.KLDivergenceQuery(jcc)(jstore, jq)
    assert np.isposinf(np.asarray(want)).all() and torch.isposinf(got).all()


# --------------------------------------------------------------------------- #
# renyi2_entropy
# --------------------------------------------------------------------------- #


def _renyi_both(build, seed):
    """Both contexts with the product circuit built before the JAX store
    (its slots included) is carried into the port."""
    flags = dict(semiring="lse-sum", fold=True)
    jctx = JaxPipelineContext(**flags)
    jcc = jctx.compile(build(*JAX, np.random.default_rng(seed)))
    ctx = PipelineContext(**flags, device="cpu", seed=0)
    cc = ctx.compile(build(*PORT, np.random.default_rng(seed)))
    JE.renyi2_entropy(jcc, ctx=jctx)
    renyi2_entropy(cc, ctx=ctx)
    arrays = {s: np.asarray(v) for s, v in jctx.parameters.items()}
    ctx.load_parameters({s: a.astype(np.float64) if a.dtype.kind == "f" else a
                         for s, a in arrays.items()})
    return jctx, jcc, ctx, cc


RENYI = {
    "nondeterministic": (deep_pc(4, 3, 2), 49, None),
    "conditional": (deterministic_pc, 50,
                    (np.array([[0, 0], [2, 0]]), np.array([[True, False]] * 2))),
    "gaussian": (gaussian_product, 51, None),
    "image-cp": (image("cp"), 52, None),
}


@pytest.mark.parametrize("name", list(RENYI))
def test_renyi2_entropy_matches_jax(name):
    build, seed, ev = RENYI[name]
    jctx, jcc, ctx, cc = _renyi_both(build, seed)
    kw = {} if ev is None else {"x": ev[0], "evidence_mask": ev[1]}
    got = renyi2_entropy(cc, ctx=ctx, **kw)
    want = JE.renyi2_entropy(jcc, ctx=jctx, **kw)
    assert got.shape == want.shape
    assert_close(got, want)
    # H2 <= the Shannon recursion's value
    if ev is None:
        assert (got <= EntropyQuery(cc)() + 1e-9).all()
