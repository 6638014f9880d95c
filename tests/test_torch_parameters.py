"""The port's parameter nodes, parameter rewrites and categorical layer
(``cirkit_tpu_torch.backend.torch``) against the JAX package's, node by
node in float64 on the CPU: the same numpy inputs through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.backend.jax import layers as jl
from cirkit_tpu.backend.jax import optimization as jo
from cirkit_tpu.backend.jax import parameters as jp
from cirkit_tpu_torch.backend.torch import layers as tl
from cirkit_tpu_torch.backend.torch import optimization as to
from cirkit_tpu_torch.backend.torch import parameters as tp

F = 2

NODES = [
    ("SoftmaxParameter", [(4, 6)], {"axis": -1}),
    ("SoftmaxParameter", [(4, 6)], {"axis": 0}),
    ("LogSoftmaxParameter", [(4, 6)], {"axis": 1}),
    ("MixingWeightParameter", [(3, 2)], {}),
    ("MatMulParameter", [(5, 6), (4, 5)], {}),
    ("EinsumParameter", [(3, 4), (3, 5)], {"equation": "zab,zac->zbc", "out_shape": (4, 5)}),
    ("FlattenParameter", [(3, 4, 5)], {"start_dim": 1, "end_dim": 2}),
    ("LogParameter", [(4, 6)], {}),
    ("OuterProductParameter", [(3, 4), (3, 5)], {"axis": 1}),
    ("ReduceSumParameter", [(4, 6)], {"axis": 0}),
]


@pytest.mark.parametrize("name,in_shapes,cfg", NODES)
def test_node_matches_jax(name, in_shapes, cfg):
    rng = np.random.default_rng(0)
    ins = [rng.uniform(0.1, 2.0, size=(F, *s)) for s in in_shapes]
    jnode = getattr(jp, "Jax" + name)(*in_shapes, **cfg, num_folds=F)
    tnode = getattr(tp, "Torch" + name)(*in_shapes, **cfg, num_folds=F)
    assert tnode.shape == jnode.shape
    ref = np.asarray(jnode({}, *(jnp.asarray(a) for a in ins)))
    out = tnode({}, *(torch.as_tensor(a) for a in ins)).numpy()
    assert out.shape == (F, *tnode.shape)
    np.testing.assert_allclose(out, ref, rtol=1e-12)


def test_pointer_slot_gathers_and_folds_like_jax():
    arr = np.random.default_rng(1).normal(size=(4, 3))
    jptr = [jp.JaxPointerSlot("p0", (3,), fold_idx=idx) for idx in ([2, 0], [3])]
    tptr = [tp.TorchPointerSlot("p0", (3,), fold_idx=idx) for idx in ([2, 0], [3])]
    jfold = jptr[0].fold(jptr)
    tfold = tptr[0].fold(tptr)
    assert tfold.num_folds == jfold.num_folds == 3
    for jn, tn in [*zip(jptr, tptr), (jfold, tfold)]:
        ref = np.asarray(jn({"p0": jnp.asarray(arr)}))
        np.testing.assert_array_equal(tn({"p0": torch.as_tensor(arr)}).numpy(), ref)


def _slot(mod, prefix, name, shape):
    return getattr(mod, prefix + "TensorSlot")(
        name, shape, dtype=None, learnable=True, inits=[None], origins=[None]
    )


def _graph(mod, prefix, chain, ins):
    """A parameter graph: the input slots feed the first op of ``chain``,
    each op feeds the next."""
    slots = [_slot(mod, prefix, f"s{i}", s) for i, s in enumerate(ins)]
    ops = [getattr(mod, prefix + cls)(*shapes, **cfg) for cls, shapes, cfg in chain]
    in_nodes = {ops[0]: slots, **{b: [a] for a, b in zip(ops, ops[1:])}}
    graph_cls = getattr(mod, prefix + "Parameter")
    return graph_cls([*slots, *ops], in_nodes, [ops[-1]])


@pytest.mark.parametrize(
    "chain,ins",
    [
        # log(softmax(x)) -> log_softmax(x)
        ([("SoftmaxParameter", [(4, 6)], {"axis": 1}), ("LogParameter", [(4, 6)], {})],
         [(4, 6)]),
        # reduce_sum(outer(a, b)) -> einsum (+ flatten when the axes differ)
        ([("OuterProductParameter", [(3, 4), (3, 5)], {"axis": 1}),
          ("ReduceSumParameter", [(3, 20)], {"axis": 1})], [(3, 4), (3, 5)]),
        ([("OuterProductParameter", [(3, 4), (3, 5)], {"axis": 1}),
          ("ReduceSumParameter", [(3, 20)], {"axis": 0})], [(3, 4), (3, 5)]),
        ([("OuterProductParameter", [(3, 4), (2, 4)], {"axis": 0}),
          ("ReduceSumParameter", [(6, 4)], {"axis": 1})], [(3, 4), (2, 4)]),
    ],
)
def test_parameter_rewrites_match_jax(chain, ins):
    jgraph = _graph(jp, "Jax", chain, ins)
    tgraph = _graph(tp, "Torch", chain, ins)
    jnew = jo._rewrite_parameter_graph(None, jgraph, jo.DEFAULT_PARAMETER_OPT_RULES)
    tnew = to._rewrite_parameter_graph(None, tgraph, to.DEFAULT_PARAMETER_OPT_RULES)
    assert [type(n).__name__[5:] for n in tnew.topological_ordering()] == [
        type(n).__name__[3:] for n in jnew.topological_ordering()
    ]
    rng = np.random.default_rng(2)
    store = {f"s{i}": rng.uniform(0.1, 2.0, size=(1, *s)) for i, s in enumerate(ins)}
    tstore = {k: torch.as_tensor(v) for k, v in store.items()}
    before = tgraph(tstore).numpy()
    np.testing.assert_allclose(tnew(tstore).numpy(), before, rtol=1e-12)
    np.testing.assert_allclose(before, np.asarray(jgraph(store)), rtol=1e-12)


@pytest.mark.parametrize("param", ["probs", "logits"])
def test_categorical_layer_matches_jax(param):
    rng = np.random.default_rng(3)
    k, c, b = 3, 5, 7
    if param == "probs":
        theta = rng.dirichlet(np.ones(c), size=(F, k))
    else:
        theta = rng.normal(size=(F, k, c))
    x = rng.integers(-1, c + 1, size=(F, b, 1))  # out-of-range indices clamp

    def layer(mod, lay, prefix):
        slot = getattr(mod, prefix + "TensorSlot")(
            "p0", (k, c), dtype=None, learnable=True, inits=[None] * F, origins=[None] * F,
            num_folds=F,
        )
        graph = getattr(mod, prefix + "Parameter")([slot], {}, [slot])
        return getattr(lay, prefix + "CategoricalLayer")(
            np.arange(F)[:, None], k, num_categories=c, num_folds=F, **{param: graph}
        )

    jlayer, tlayer = layer(jp, jl, "Jax"), layer(tp, tl, "Torch")
    jstore, tstore = {"p0": jnp.asarray(theta)}, {"p0": torch.as_tensor(theta)}
    np.testing.assert_allclose(
        tlayer.log_partition_function(tstore).numpy(),
        np.asarray(jlayer.log_partition_function(jstore)),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        tlayer(tstore, torch.as_tensor(x)).numpy(),
        np.asarray(jlayer(jstore, jnp.asarray(x))),
        rtol=1e-12,
    )
