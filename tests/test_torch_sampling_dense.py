"""The port's dense bottom-up sampler (``SamplingQuery`` off the lse-sum
semiring) and its layer hooks against the JAX package's, on the CPU.

- Routing to the bit: the JAX dense sampler's per-entry inputs, mixture
  draws and outputs are recorded on ``image_data((1,4,4), "quad-tree-2")``
  circuits (CP and Tucker, unoptimized and optimized: the Hadamard,
  Kronecker, Sum, CP-T and Tucker hooks), and each port hook's
  ``route(x, mix)`` (``_pad_samples`` for the input layers) given JAX's
  ``x`` and ``mix`` equals JAX's output exactly.
- The port's sampler routes assignments with no variable column and
  gathers the selected rows on the way down; its samples and mixture
  draws equal those of the hooks' padded bottom-up route from the same
  seeds, to the bit.
- Frequencies: the circuits of ``tests/backend/test_queries.py:89, :132,
  :328, :364`` under ``sum-product``, each world's frequency against JAX's
  symbolic circuit enumerated (``tests/reference_eval.py``), with those
  tests' bounds; the input layers' draws (categorical with zero-probability
  states, binomial, Gaussian) against their distributions.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.backend.jax import queries as JQ
from cirkit_tpu.backend.jax.layers import JaxInputLayer
from cirkit_tpu.models import image_data as jax_image_data
from cirkit_tpu.pipeline import PipelineContext as JaxPipelineContext
from cirkit_tpu_torch.backend.torch import SamplingQuery
from cirkit_tpu_torch.backend.torch import queries as Q
from cirkit_tpu_torch.backend.torch.layers import TorchInputLayer, draw_rows
from cirkit_tpu_torch.models import image_data
from cirkit_tpu_torch.pipeline import PipelineContext
from tests.reference_eval import enumerate_worlds, eval_circuit
from tests.test_torch_expectation import JAX, PORT, const

FLAGS = dict(semiring="sum-product", fold=True)


def _image_both(spl, optimize, k=4):
    kw = dict(input_layer="categorical", num_input_units=k, sum_product_layer=spl,
              num_sum_units=k)
    jctx = JaxPipelineContext(**FLAGS, optimize=optimize)
    jcc = jctx.compile(jax_image_data((1, 4, 4), "quad-tree-2", **kw))
    ctx = PipelineContext(**FLAGS, optimize=optimize, device="cpu", seed=0)
    cc = ctx.compile(image_data((1, 4, 4), "quad-tree-2", **kw))
    arrays = {s: np.asarray(v, np.float64) for s, v in jctx.parameters.items()}
    ctx.load_parameters(arrays)
    return jcc, {s: jnp.asarray(a) for s, a in arrays.items()}, ctx, cc


def _jax_dense_records(jcc, jstore, n, key):
    """JAX's dense sampler (``queries.py:381-409``) run eagerly, recording
    each entry's (layer, input, mixture draw or None, output)."""
    num_vars = max(jcc.scope) + 1
    keys = iter(jax.random.split(key, len(jcc.layers)))
    records = []

    def layer_fn(layer, s, xin):
        lk = next(keys)
        if isinstance(layer, JaxInputLayer):
            samples = layer.sample(s, lk, n)
            out = JQ._pad_samples(samples, layer.scope_idx, num_vars)
            records.append((layer, samples, None, out))
            return out
        out, mix = layer.sample(s, lk, xin)
        records.append((layer, xin, mix, out))
        return out

    jcc.evaluate_raw(jstore, None, module_fn=layer_fn)
    return records


def _t(a) -> torch.Tensor:
    return torch.as_tensor(np.array(a))


# the routing hooks each configuration's plan holds
ROUTED = {("cp", False): {"Hadamard", "Sum"}, ("cp", True): {"CPT", "Sum"},
          ("tucker", False): {"Kronecker", "Sum"}, ("tucker", True): {"Tucker"}}


@pytest.mark.parametrize("spl,optimize", list(ROUTED))
def test_route_matches_jax_to_the_bit(spl, optimize):
    jcc, jstore, ctx, cc = _image_both(spl, optimize)
    records = _jax_dense_records(jcc, jstore, 6, jax.random.PRNGKey(3))
    assert len(records) == len(cc._entries)
    num_vars = max(cc.scope) + 1
    routed = set()
    for (jl, xin, mix, want), entry in zip(records, cc._entries):
        layer = entry.layer
        assert type(layer).__name__[len("Torch"):] == type(jl).__name__[len("Jax"):]
        if isinstance(layer, TorchInputLayer):
            got = Q._pad_samples(_t(xin), layer.scope_idx, num_vars)
        else:
            got = layer.route(_t(xin), None if mix is None else _t(mix).long())
            routed.add(type(layer).__name__[len("Torch"):-len("Layer")])
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert routed == ROUTED[spl, optimize]
    # the port's draws have JAX's shapes: (N, D) samples, one (F, Ko, N) per
    # sum-style entry
    jsamples, jmix = JQ.SamplingQuery(jcc)(6, key=jax.random.PRNGKey(4), store=jstore)
    samples, mix = SamplingQuery(cc)(6, generator=torch.Generator().manual_seed(4))
    assert samples.shape == jsamples.shape and samples.dtype == torch.float64
    assert [tuple(m.shape) for m in mix] == [tuple(m.shape) for m in jmix]


def _padded_route(cc, store, n, generator):
    """The hooks' padded bottom-up route (JAX's mechanism) with the
    sampler's seeds: (samples (N, D), mixtures)."""
    entries = cc._entries
    seeds = torch.randint(0, 2**62, (len(entries),), generator=generator).tolist()
    step = iter(range(len(entries)))
    num_vars = max(cc.scope) + 1
    mixtures = []

    def layer_fn(layer, st, xin):
        gen = torch.Generator().manual_seed(seeds[next(step)])
        if isinstance(layer, TorchInputLayer):
            return Q._pad_samples(layer.sample(st, gen, n), layer.scope_idx, num_vars)
        out, mix = layer.sample(st, gen, xin)
        if mix is not None:
            mixtures.append(mix)
        return out

    with torch.inference_mode():
        out = cc.evaluate_raw(store, None, module_fn=layer_fn)  # (O, K, N, D)
    return out[0, 0], mixtures


@pytest.mark.parametrize("spl,optimize", list(ROUTED))
def test_sampler_equals_the_padded_route(spl, optimize):
    _, _, ctx, cc = _image_both(spl, optimize)
    want, want_mix = _padded_route(cc, ctx.parameters, 9, torch.Generator().manual_seed(5))
    got, mix = SamplingQuery(cc)(9, generator=torch.Generator().manual_seed(5))
    assert torch.equal(got, want.to(got.dtype))
    assert len(mix) == len(want_mix) and all(torch.equal(a, b) for a, b in zip(mix, want_mix))
    assert bool(((got >= 0) & (got <= 255) & (got == got.round())).all())


# --------------------------------------------------------------------------- #
# Frequencies against enumeration
# --------------------------------------------------------------------------- #


def _leaf(S, Sc, rng, v, k, c):
    raw = rng.uniform(0.1, 1.0, (k, c))
    return S.CategoricalLayer(Sc([v]), k, num_categories=c,
                              probs=const(S, raw / raw.sum(axis=1, keepdims=True)))


def mixture_pc(product, k=2, c=2):
    """The normalized two-variable circuits of ``test_queries.py:89`` and
    ``:364`` (Hadamard), ``:132`` (Kronecker, fused into a Tucker layer by
    the optimizer) and ``:328`` (Kronecker of K=32, a 1024-wide composite)."""

    def build(S, Sc, rng):
        leaves = [_leaf(S, Sc, rng, v, k, c) for v in range(2)]
        if product == "hadamard":
            prod, width = S.HadamardLayer(k, arity=2), k
        else:
            prod, width = S.KroneckerLayer(k, arity=2), k * k
        w = rng.uniform(0.1, 1.0, (1, width))
        s = S.SumLayer(width, 1, weight=const(S, w / w.sum()))
        return S.Circuit(leaves + [prod, s], {prod: leaves, s: [prod]}, [s])

    return build


@pytest.mark.parametrize("line,product,k,c,fold,optimize,seed,n", [
    (89, "hadamard", 2, 2, False, False, 24, 20000),
    (89, "hadamard", 2, 2, True, False, 24, 20000),
    (132, "kronecker", 2, 2, True, True, 31, 20000),
    (328, "kronecker", 32, 3, True, True, 70, 20000),
    (364, "hadamard", 2, 2, True, False, 71, 20000),
])
def test_sampling_frequencies_match_enumeration(line, product, k, c, fold, optimize, seed, n):
    build = mixture_pc(product, k, c)
    sc_j = build(*JAX, np.random.default_rng(seed))
    ctx = PipelineContext(semiring="sum-product", fold=fold, optimize=optimize, device="cpu")
    cc = ctx.compile(build(*PORT, np.random.default_rng(seed)))
    if optimize:
        assert any(type(l).__name__ == "TorchTuckerLayer" for l in cc.layers)
    samples, mixtures = SamplingQuery(cc)(n, generator=torch.Generator().manual_seed(line))
    assert samples.shape == (n, 2) and len(mixtures) >= 1
    counts = collections.Counter(map(tuple, samples.numpy().astype(int).tolist()))
    worlds = enumerate_worlds(2, c)
    probs = eval_circuit(sc_j, worlds)[:, 0, 0]
    probs = probs / probs.sum()
    freqs = np.array([counts.get(tuple(w), 0) / n for w in worlds.tolist()])
    # the bounds of the mirrored tests
    tol = 4 * np.sqrt(probs * (1 - probs) / n) + 1e-3 if line == 328 else 0.02
    assert (np.abs(freqs - probs) < tol).all(), (freqs, probs)


def test_draw_rows_frequencies_and_zero_weights():
    """Every row's frequencies against its normalized weights, a
    zero-weight column never drawn, a row of one nonzero column always it."""
    w = torch.tensor([[[0.0, 1.0, 3.0, 0.0, 4.0], [0.0, 0.0, 0.0, 0.0, 2.0]]],
                     dtype=torch.float64)
    n = 40000
    draws = draw_rows(w, torch.Generator().manual_seed(0), n)
    assert draws.shape == (1, 2, n) and draws.dtype == torch.int64
    assert bool((draws[0, 1] == 4).all())
    freq = torch.bincount(draws[0, 0], minlength=5).double() / n
    p = w[0, 0] / w[0, 0].sum()
    assert bool((freq[p == 0] == 0).all())
    tol = 5 * torch.sqrt(p * (1 - p) / n) + 1e-3
    assert bool(((freq - p).abs() <= tol).all()), (freq, p)


def gaussian_binomial_pc(S, Sc, rng):
    """A two-component mixture over (Gaussian x0, Binomial x1)."""
    g = S.GaussianLayer(Sc([0]), 2, mean=const(S, [-1.0, 2.0]), stddev=const(S, [0.5, 1.5]))
    b = S.BinomialLayer(Sc([1]), 2, total_count=5, probs=const(S, [0.2, 0.7]))
    prod = S.HadamardLayer(2, arity=2)
    s = S.SumLayer(2, 1, weight=const(S, [[0.3, 0.7]]))
    return S.Circuit([g, b, prod, s], {prod: [g, b], s: [prod]}, [s])


def test_gaussian_and_binomial_leaves_sample_their_mixture():
    from scipy.stats import binom

    ctx = PipelineContext(semiring="sum-product", fold=True, device="cpu")
    cc = ctx.compile(gaussian_binomial_pc(*PORT, np.random.default_rng(0)))
    n = 40000
    x = SamplingQuery(cc)(n, generator=torch.Generator().manual_seed(2))[0].numpy()
    w, mu, sd = np.array([0.3, 0.7]), np.array([-1.0, 2.0]), np.array([0.5, 1.5])
    mean = (w * mu).sum()
    var = (w * (sd**2 + mu**2)).sum() - mean**2
    assert abs(x[:, 0].mean() - mean) < 4 * np.sqrt(var / n)
    np.testing.assert_allclose(x[:, 0].var(), var, rtol=0.05)
    probs = (w[:, None] * binom.pmf(np.arange(6)[None, :], 5, np.array([0.2, 0.7])[:, None])
             ).sum(0)
    freqs = np.bincount(x[:, 1].astype(int), minlength=6) / n
    assert (np.abs(freqs - probs) < 4 * np.sqrt(probs * (1 - probs) / n) + 1e-3).all()


def test_dense_sampler_refuses_what_jax_refuses():
    """Layers with no sampling hook raise ``TypeError`` (a polynomial leaf),
    ``conditional`` stays lse-sum only, and the count must be positive."""

    def poly(S, Sc, rng):
        leaves = [S.PolynomialLayer(Sc([v]), 1, degree=1) for v in range(2)]
        prod = S.HadamardLayer(1, arity=2)
        return S.Circuit(leaves + [prod], {prod: leaves}, [prod])

    ctx = PipelineContext(semiring="sum-product", fold=True, device="cpu")
    cc = ctx.compile(poly(*PORT, None))
    with pytest.raises(TypeError, match="Sampling is not supported"):
        SamplingQuery(cc)(2)
    cc2 = ctx.compile(mixture_pc("hadamard")(*PORT, np.random.default_rng(0)))
    with pytest.raises(ValueError, match="lse-sum"):
        SamplingQuery(cc2).conditional(np.zeros((1, 2)), evidence_mask=np.zeros((1, 2), bool))
    with pytest.raises(ValueError, match="positive"):
        SamplingQuery(cc2)(0)
