"""Interop with other probabilistic-model ecosystems: Juice ``.jpc``
files, SPFlow text equations, and UAI-format graphical models.

Beyond the reference (whose only external format is ``.sdd`` logic files,
ref ``cirkit/templates/logic/sdd.py:19``; we additionally load ``.psdd``).
``load_uai`` additionally COMPILES UAI-format Markov/Bayes networks into
smooth decomposable circuits by bucket elimination (see its docstring).
Both directions are supported for both circuit formats:

- **Juice** (ProbabilisticCircuits.jl) ``.jpc``: a line-per-node text
  format over *binary* variables — ``L`` literal leaves, ``P`` products,
  ``S`` sums with per-edge log-probabilities, nodes listed bottom-up with
  the root last. ``load_jpc`` lowers one into a symbolic
  :class:`~cirkit_tpu.symbolic.circuit.Circuit` (indicator categorical
  leaves, scalar sum/product layers); ``save_jpc`` unfolds any compiled
  circuit over binary categorical leaves into scalar nodes and writes it.
- **SPFlow** text equations (``spn.io.Text``): nested
  ``(0.3*(...) + 0.7*(...))`` sums, ``((...) * (...))`` products and
  ``Categorical(V0|p=[...])`` / ``Bernoulli(V0|p=0.3)`` /
  ``Gaussian(V0|mean=0.0;stdev=1.0)`` leaves. ``load_spflow`` parses the
  equation (string or file); ``save_spflow`` emits one.

Scalarization (wide folded layers -> one node per unit) reads trained
parameter values back through the compiled context exactly like
structural pruning does (``backend/jax/pruning.py::_materialize``), so a
trained/EM-fit circuit exports its *learned* weights. Loading builds
constant-parameterized scalar circuits; ``learnable=True`` makes sum
weights (and, for SPFlow, leaf distributions) plain learnable slots, so
imported models are directly ``fit_em``-eligible.

Caveats, by design of the formats:

- ``.jpc`` carries vtree ids; standalone files do not include the vtree,
  so we write ``0`` placeholders and ignore them on load.
- ``.jpc`` literals are binary: saving requires every leaf to be a
  2-category categorical; rows that are exact one-hots become literals,
  anything else becomes a Bernoulli-style weighted sum of the two
  literals (how Juice encodes leaf distributions).
- SPFlow equations are trees: shared sub-circuits are duplicated in the
  text (loading such a file rebuilds them as separate layers).
- SPFlow sum weights are conventionally normalized; weights are written
  as learned, without renormalization.
"""

from __future__ import annotations

import math
import os
import re

import numpy as np

from cirkit_tpu_torch.symbolic.circuit import Circuit
from cirkit_tpu_torch.symbolic.initializers import ConstantTensorInitializer
from cirkit_tpu_torch.symbolic.layers import (
    CategoricalLayer,
    GaussianLayer,
    HadamardLayer,
    KroneckerLayer,
    Layer,
    SumLayer,
)
from cirkit_tpu_torch.symbolic.parameters import Parameter, TensorParameter
from cirkit_tpu_torch.utils.scope import Scope

__all__ = [
    "load_jpc",
    "load_spflow",
    "load_uai",
    "load_uai_evidence",
    "save_jpc",
    "save_spflow",
]


def _const(value: np.ndarray, learnable: bool = False) -> Parameter:
    value = np.asarray(value, dtype=np.float64)
    return Parameter.from_input(
        TensorParameter(
            *value.shape,
            initializer=ConstantTensorInitializer(value),
            learnable=learnable,
        )
    )


# ---------------------------------------------------------------------------
# scalarization: a compiled circuit -> one node per (layer, unit)
# ---------------------------------------------------------------------------

# scalar node encodings:
#   ("cat", var, probs_1d)          categorical leaf
#   ("gauss", var, mean, stddev)    gaussian leaf
#   ("prod", child_ids)
#   ("sum", child_ids, weights_1d)  linear-space weights


def _scalar_graph(sc: Circuit, ctx, store=None) -> tuple[list[tuple], int]:
    """Unfold ``sc``'s units into scalar nodes (topological order, root
    last), with parameter values read back through the compiled context
    (``store`` entries override the context's, like ``prune_circuit``).
    Returns ``(nodes, root_id)``."""
    from cirkit_tpu_torch.backend.torch.pruning import _materialize

    if not ctx._compiler.is_compiled(sc):
        raise ValueError(
            "Compile the circuit through this context first (ctx.compile(sc)): "
            "export reads the trained parameters back through the context's "
            "slot state"
        )
    if len(sc.outputs) != 1 or sc.outputs[0].num_output_units != 1:
        raise ValueError(
            "Interop export needs a single scalar root "
            f"(got {len(sc.outputs)} output layer(s))"
        )
    full = dict(ctx.parameters)
    if store is not None:
        full.update(store)
    values = _materialize(sc, ctx, full)

    nodes: list[tuple] = []
    ids: dict[Layer, list[int]] = {}

    def add(node: tuple) -> int:
        nodes.append(node)
        return len(nodes) - 1

    for sl in sc.topological_ordering():
        if isinstance(sl, CategoricalLayer):
            (var,) = tuple(sc.layer_scope(sl))
            probs = np.asarray(values[sl], np.float64)
            ids[sl] = [add(("cat", var, probs[u])) for u in range(probs.shape[0])]
        elif isinstance(sl, GaussianLayer):
            (var,) = tuple(sc.layer_scope(sl))
            mean, std = (np.asarray(a, np.float64) for a in values[sl])
            ids[sl] = [
                add(("gauss", var, float(mean[u]), float(std[u])))
                for u in range(mean.shape[0])
            ]
        elif isinstance(sl, HadamardLayer):
            kids = [ids[c] for c in sc.layer_inputs(sl)]
            ids[sl] = [
                add(("prod", [k[u] for k in kids]))
                for u in range(sl.num_output_units)
            ]
        elif isinstance(sl, KroneckerLayer):
            kids = [ids[c] for c in sc.layer_inputs(sl)]
            ki, h = sl.num_input_units, sl.arity
            ids[sl] = [
                # row-major digit order, matching JaxKroneckerLayer
                # (backend/jax/layers.py:175)
                add(("prod", [kids[d][dig] for d, dig in
                              enumerate(np.unravel_index(o, (ki,) * h))]))
                for o in range(sl.num_output_units)
            ]
        elif isinstance(sl, SumLayer):
            kids = [ids[c] for c in sc.layer_inputs(sl)]
            concat = [i for k in kids for i in k]
            w = np.asarray(values[sl], np.float64)
            if np.any(w < 0.0):
                raise ValueError(
                    "Interop formats are monotone: negative sum weights "
                    f"found in {sl}"
                )
            ids[sl] = [
                add(("sum", concat, w[o])) for o in range(sl.num_output_units)
            ]
        else:
            raise NotImplementedError(
                f"Interop export does not support {type(sl).__name__}"
            )
    return nodes, ids[sc.outputs[0]][0]


# ---------------------------------------------------------------------------
# scalar nodes -> symbolic circuit (shared by both loaders)
# ---------------------------------------------------------------------------


def _build_scalar_circuit(
    nodes: list[tuple], root: int, learnable: bool, freeze_onehot: bool = False
) -> Circuit:
    layers: dict[int, Layer] = {}
    in_layers: dict[Layer, list[Layer]] = {}
    alias: dict[int, int] = {}

    def resolve(i: int) -> Layer:
        while i in alias:
            i = alias[i]
        return layers[i]

    for i, node in enumerate(nodes):
        kind = node[0]
        if kind == "cat":
            _, var, probs = node
            probs = np.asarray(probs, np.float64)
            # JPC literal indicators are structure, not parameters: they
            # stay constant even under learnable=True (freeze_onehot;
            # matches the PSDD loader). SPFlow one-hot rows are genuine
            # parameters and follow the learnable flag.
            one_hot = probs.min() == 0.0 and probs.max() == 1.0 and probs.sum() == 1.0
            layers[i] = CategoricalLayer(
                Scope([var]), 1, num_categories=probs.shape[0],
                probs=_const(
                    probs[None],
                    learnable=learnable and not (freeze_onehot and one_hot),
                ),
            )
        elif kind == "gauss":
            _, var, mean, std = node
            layers[i] = GaussianLayer(
                Scope([var]), 1,
                mean=_const(np.asarray([mean]), learnable=learnable),
                stddev=_const(np.asarray([std]), learnable=learnable),
            )
        elif kind == "prod":
            kids = node[1]
            if len(kids) == 1:  # a unary product is a pass-through
                alias[i] = kids[0]
                continue
            sl = HadamardLayer(1, arity=len(kids))
            layers[i] = sl
            in_layers[sl] = [resolve(k) for k in kids]
        else:  # sum
            _, kids, w = node
            w = np.asarray(w, np.float64)
            if np.any(w < 0.0):
                raise ValueError(
                    "Interop circuits are monotone: negative sum weights "
                    f"{w[w < 0.0]} in the input"
                )
            sl = SumLayer(
                1, 1, arity=len(kids),
                weight=_const(w[None], learnable=learnable),
            )
            layers[i] = sl
            in_layers[sl] = [resolve(k) for k in kids]

    root_layer = resolve(root)
    all_layers = list({id(v): v for v in layers.values()}.values())
    return Circuit(all_layers, in_layers, [root_layer])


# ---------------------------------------------------------------------------
# Juice .jpc
# ---------------------------------------------------------------------------


def load_jpc(filename: str, *, learnable: bool = False) -> Circuit:
    """Load a Juice (ProbabilisticCircuits.jl) ``.jpc`` file as a symbolic
    circuit over binary categorical variables.

    Line grammar (ids 0-based, bottom-up, root last; vtree ids ignored)::

        c    <comment>
        jpc  <count-of-nodes>
        L <id> <vtree-id> <literal>                 (negative = negated)
        P <id> <vtree-id> <n> {<child-id>}*n
        S <id> <vtree-id> <n> {<child-id> <log-prob>}*n

    ``learnable=True`` makes sum weights plain learnable slots
    (``fit_em``-eligible); literal indicators stay constant."""
    nodes: list[tuple] = []
    by_id: dict[int, int] = {}
    last: int | None = None
    with open(filename, encoding="utf-8") as f:
        for lineno, line in enumerate(f, start=1):
            fields = line.split()
            if not fields or fields[0] in ("c", "jpc"):
                continue
            tag, *args = fields
            try:
                n_id = int(args[0])
                if tag == "L":
                    lit = int(args[2])
                    probs = np.array([0.0, 1.0] if lit > 0 else [1.0, 0.0])
                    nodes.append(("cat", abs(lit) - 1, probs))
                elif tag == "P":
                    n = int(args[2])
                    if len(args) - 3 != n:
                        raise ValueError(
                            f"expected {n} children, got {len(args) - 3}"
                        )
                    kids = [by_id[int(a)] for a in args[3:]]
                    nodes.append(("prod", kids))
                elif tag == "S":
                    n = int(args[2])
                    pairs = args[3:]
                    if len(pairs) != 2 * n:
                        raise ValueError(
                            f"expected {n} (child, log-prob) pairs, got "
                            f"{len(pairs) / 2:g}"
                        )
                    kids = [by_id[int(a)] for a in pairs[0::2]]
                    w = np.exp(np.array([float(a) for a in pairs[1::2]]))
                    nodes.append(("sum", kids, w))
                else:
                    raise ValueError(f"unknown node tag {tag!r}")
                by_id[n_id] = len(nodes) - 1
                last = n_id
            except (ValueError, KeyError, IndexError) as e:
                raise ValueError(
                    f"{filename}:{lineno}: malformed JPC line: {e}"
                ) from e
    if last is None:
        raise ValueError(f"{filename}: no JPC nodes found")
    return _build_scalar_circuit(nodes, by_id[last], learnable, freeze_onehot=True)


def save_jpc(filename: str, sc: Circuit, ctx, *, store=None) -> None:
    """Write a compiled circuit over binary categorical leaves as a Juice
    ``.jpc`` file, with the trained parameter values read back through
    ``ctx`` (which must have compiled ``sc``; ``store`` entries override
    the context's parameters, like ``prune_circuit``). One-hot leaf rows
    become literals; other rows become weighted sums of the two literals.
    Raises for non-binary leaves (the format has only binary literals)."""
    nodes, root = _scalar_graph(sc, ctx, store)
    lines: list[str] = []
    nid = 0
    literal_ids: dict[int, int] = {}  # signed literal -> jpc id
    jpc_of: dict[int, int] = {}

    def emit(line: str) -> int:
        nonlocal nid
        lines.append(line)
        nid += 1
        return nid - 1

    def literal(lit: int) -> int:
        got = literal_ids.get(lit)
        if got is None:
            got = literal_ids[lit] = emit(f"L {nid} 0 {lit}")
        return got

    def logp(p: float) -> float:
        # exp(-800) rounds to exactly 0.0, so structural zeros round-trip
        # (exp(-745) is still a 5e-324 subnormal)
        return math.log(p) if p > 0.0 else -800.0

    for i, node in enumerate(nodes):
        kind = node[0]
        if kind == "cat":
            _, var, probs = node
            if probs.shape[0] != 2:
                raise ValueError(
                    "JPC literals are binary: leaf over variable "
                    f"{var} has {probs.shape[0]} categories"
                )
            p0, p1 = float(probs[0]), float(probs[1])
            if (p0, p1) == (0.0, 1.0):
                jpc_of[i] = literal(var + 1)
            elif (p0, p1) == (1.0, 0.0):
                jpc_of[i] = literal(-(var + 1))
            else:
                pos, neg = literal(var + 1), literal(-(var + 1))
                jpc_of[i] = emit(
                    f"S {nid} 0 2 {pos} {logp(p1)!r} {neg} {logp(p0)!r}"
                )
        elif kind == "gauss":
            raise ValueError("JPC files cannot carry Gaussian leaves")
        elif kind == "prod":
            kids = " ".join(str(jpc_of[k]) for k in node[1])
            jpc_of[i] = emit(f"P {nid} 0 {len(node[1])} {kids}")
        else:
            _, kids, w = node
            pairs = " ".join(
                f"{jpc_of[k]} {logp(float(x))!r}" for k, x in zip(kids, w)
            )
            jpc_of[i] = emit(f"S {nid} 0 {len(kids)} {pairs}")

    header = [
        "c saved by cirkit-tpu (vtree ids are placeholders)",
        "c L id vtree literal",
        "c P id vtree n children...",
        "c S id vtree n (child log-prob)...",
        f"jpc {len(lines)}",
    ]
    # the root must be the last listed node; topo order guarantees it
    # except for the degenerate one-hot-leaf-as-root case
    if jpc_of[root] != len(lines) - 1:
        raise ValueError("Cannot save a bare indicator leaf as a JPC root")
    with open(filename, "w", encoding="utf-8") as f:
        f.write("\n".join(header + lines) + "\n")


# ---------------------------------------------------------------------------
# SPFlow text equations
# ---------------------------------------------------------------------------

# signs are separate tokens (consumed by number()): a signed-number token
# would swallow the "+" that separates sum elements
_TOKEN = re.compile(
    r"\s*(?:(?P<num>(?:\d+\.\d*|\.\d+|\d+)(?:[eE][+-]?\d+)?)"
    r"|(?P<name>[A-Za-z_][A-Za-z_0-9]*)"
    r"|(?P<sym>[()*+\-|;=\[\],]))"
)


def _tokenize(text: str) -> list[tuple[str, str]]:
    out, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            if text[pos:].strip() == "":
                break
            raise ValueError(f"SPFlow equation: bad token at ...{text[pos:pos+20]!r}")
        pos = m.end()
        for kind in ("num", "name", "sym"):
            tok = m.group(kind)
            if tok is not None:
                out.append((kind, tok))
                break
    return out


def load_spflow(src: str, *, learnable: bool = False) -> Circuit:
    """Parse an SPFlow text equation (``spn.io.Text`` format) into a
    symbolic circuit. ``src`` is the equation itself or a path to a file
    containing it. Supported leaves: ``Categorical(V0|p=[...])``,
    ``Bernoulli(V0|p=0.3)`` and ``Gaussian(V0|mean=0.0;stdev=1.0)``;
    sums are ``(w*(..) + w*(..))``, products ``((..) * (..))``.

    ``learnable=True`` makes sum weights and leaf distributions plain
    learnable slots (``fit_em``-eligible)."""
    # a path wins over the equation heuristic, so paths containing "(" work
    if os.path.exists(src) or "(" not in src:
        with open(src, encoding="utf-8") as f:
            src = f.read()
    toks = _tokenize(src)
    pos = 0
    nodes: list[tuple] = []

    def peek(k: int = 0):
        return toks[pos + k] if pos + k < len(toks) else ("eof", "")

    def expect(tok: str) -> None:
        nonlocal pos
        kind, val = peek()
        if val != tok:
            raise ValueError(f"SPFlow equation: expected {tok!r}, got {val!r}")
        pos += 1

    def number() -> float:
        nonlocal pos
        sign = 1.0
        while peek()[1] in ("+", "-"):
            sign = -sign if peek()[1] == "-" else sign
            pos += 1
        kind, val = peek()
        if kind != "num":
            raise ValueError(f"SPFlow equation: expected a number, got {val!r}")
        pos += 1
        return sign * float(val)

    def value():
        if peek()[1] == "[":
            expect("[")
            out = [number()]
            while peek()[1] == ",":
                expect(",")
                out.append(number())
            expect("]")
            return out
        return number()

    def add(node: tuple) -> int:
        nodes.append(node)
        return len(nodes) - 1

    def leaf() -> int:
        nonlocal pos
        name = peek()[1]
        pos += 1
        expect("(")
        var_tok = peek()[1]
        m = re.fullmatch(r"V(\d+)", var_tok)
        if m is None:
            raise ValueError(f"SPFlow leaf: expected V<idx>, got {var_tok!r}")
        var = int(m.group(1))
        pos += 1
        expect("|")
        params: dict[str, object] = {}
        while True:
            key = peek()[1]
            pos += 1
            expect("=")
            params[key] = value()
            if peek()[1] != ";":
                break
            expect(";")
        expect(")")
        if name == "Categorical":
            return add(("cat", var, np.asarray(params["p"], np.float64)))
        if name == "Bernoulli":
            p = float(params["p"])  # type: ignore[arg-type]
            return add(("cat", var, np.array([1.0 - p, p])))
        if name == "Gaussian":
            return add(
                ("gauss", var, float(params["mean"]), float(params["stdev"]))  # type: ignore[arg-type]
            )
        raise ValueError(f"SPFlow leaf type {name!r} is not supported")

    def parse() -> int:
        # iterative shift-reduce over the nesting (frames: sum/prod with
        # their collected children) — no Python recursion, so arbitrarily
        # deep equations (chain/HMM-shaped circuits) reload fine
        stack: list[tuple] = []
        result: int | None = None
        while True:
            if result is None:  # at the start of a node
                if peek()[0] == "name":
                    result = leaf()
                    continue
                expect("(")
                if peek()[0] == "num":  # sum: (w*(..) + w*(..))
                    w = number()
                    expect("*")
                    stack.append(("sum", [], [w]))
                else:  # product: ((..) * (..))
                    stack.append(("prod", [], None))
                continue
            if not stack:
                return result
            kind, kids, weights = stack[-1]
            kids.append(result)
            result = None
            if kind == "sum":
                if peek()[1] == "+":
                    expect("+")
                    weights.append(number())
                    expect("*")
                    continue
                expect(")")
                stack.pop()
                result = add(("sum", kids, np.asarray(weights, np.float64)))
            else:
                if peek()[1] == "*":
                    expect("*")
                    continue
                expect(")")
                stack.pop()
                # unary product = redundant parentheses
                result = kids[0] if len(kids) == 1 else add(("prod", kids))

    root = parse()
    if pos != len(toks):
        raise ValueError(
            f"SPFlow equation: trailing tokens from {toks[pos][1]!r}"
        )
    return _build_scalar_circuit(nodes, root, learnable)


def save_spflow(
    sc: Circuit, ctx, *, store=None, filename: str | None = None
) -> str:
    """Emit a compiled circuit as an SPFlow text equation (and optionally
    write it to ``filename``), with trained parameter values read back
    through ``ctx`` (``store`` entries override the context's). Shared
    sub-circuits are duplicated in the text (the format is a tree).
    Returns the equation string."""
    nodes, root = _scalar_graph(sc, ctx, store)
    text: dict[int, str] = {}
    for i, nd in enumerate(nodes):
        kind = nd[0]
        if kind == "cat":
            _, var, probs = nd
            ps = ", ".join(repr(float(p)) for p in probs)
            text[i] = f"Categorical(V{var}|p=[{ps}])"
        elif kind == "gauss":
            _, var, mean, std = nd
            text[i] = f"Gaussian(V{var}|mean={mean!r};stdev={std!r})"
        elif kind == "prod":
            text[i] = "(" + " * ".join(text[k] for k in nd[1]) + ")"
        else:
            _, kids, w = nd
            text[i] = "(" + " + ".join(
                f"{float(x)!r}*{text[k]}" for k, x in zip(kids, w)
            ) + ")"
    eq = text[root]
    if filename is not None:
        with open(filename, "w", encoding="utf-8") as f:
            f.write(eq + "\n")
    return eq


# ---------------------------------------------------------------------------
# UAI competition format: Markov / Bayes networks, compiled by bucket
# elimination into smooth + decomposable circuits
# ---------------------------------------------------------------------------


def load_uai(
    filename: str,
    *,
    elimination_order: list[int] | None = None,
    max_table_entries: int = 1 << 16,
) -> Circuit:
    """Load a UAI-format network (MARKOV or BAYES preamble) and COMPILE it
    into a smooth, decomposable symbolic circuit via bucket (variable)
    elimination over the network polynomial — Darwiche's classic
    compilation, so every downstream query is the exact inference engine:
    ``evaluate`` is the unnormalized factor product, ``IntegrateQuery``
    the partition function / evidence marginals, ``MAPQuery`` the
    max-product bound, sampling is exact after normalizing by Z. An
    extension beyond both the reference and the interop formats above
    (which carry circuits, not graphical models).

    Format (whitespace-separated tokens)::

        MARKOV|BAYES
        <num-vars>  <card_1> ... <card_n>
        <num-factors>
        <k  v_1 ... v_k>   per factor (0-based variable scopes)
        <num-entries  e_1 ... >  per factor (row-major, LAST scope
                                  variable fastest — the UAI convention)

    Compilation structure: each variable's indicators form a singleton
    "lambda" potential placed in its bucket; multiplying bucket potentials
    entrywise and summing a variable out becomes one weighted sum node per
    surviving assignment (factor values fold into sum weights, so pure
    table constants never become nodes). Eliminated-variable sets are
    disjoint across potentials, which yields decomposability; within one
    elimination every child mentions the same variable set, which yields
    smoothness. ``elimination_order`` overrides the default greedy
    min-degree order; ``max_table_entries`` guards against treewidth
    blow-ups — the default (64k) reflects what the per-assignment host
    loop and the scalar-layer builder handle in seconds; raise it
    deliberately for dense networks you are willing to wait on."""
    with open(filename, encoding="utf-8") as f:
        toks = f.read().split()
    pos = 0

    def take(k: int = 1) -> list[str]:
        nonlocal pos
        if pos + k > len(toks):
            raise ValueError(f"{filename}: truncated UAI file")
        out = toks[pos : pos + k]
        pos += k
        return out

    net_type = take()[0].upper()
    if net_type not in ("MARKOV", "BAYES"):
        raise ValueError(f"{filename}: unknown network type {net_type!r}")
    n = int(take()[0])
    cards = [int(t) for t in take(n)]
    if any(c < 1 for c in cards):
        raise ValueError(f"{filename}: variable cardinalities must be >= 1")
    m = int(take()[0])
    scopes: list[tuple[int, ...]] = []
    for _ in range(m):
        k = int(take()[0])
        scope = tuple(int(t) for t in take(k))
        if any(not 0 <= v < n for v in scope):
            raise ValueError(f"{filename}: factor scope {scope} out of range")
        if len(set(scope)) != len(scope):
            raise ValueError(
                f"{filename}: factor scope {scope} repeats a variable "
                "(forbidden by the UAI format)"
            )
        scopes.append(scope)
    tables = []
    for scope in scopes:
        cnt = int(take()[0])
        want = int(np.prod([cards[v] for v in scope])) if scope else 1
        if cnt != want:
            raise ValueError(
                f"{filename}: factor over {scope} declares {cnt} entries, "
                f"scope implies {want}"
            )
        vals = np.array([float(t) for t in take(cnt)], np.float64)
        if np.any(vals < 0.0):
            raise ValueError(f"{filename}: negative factor entries")
        tables.append(vals.reshape([cards[v] for v in scope]))
    if pos != len(toks):
        raise ValueError(
            f"{filename}: {len(toks) - pos} trailing token(s) after the "
            f"declared {m} factor table(s) — factor count understated?"
        )

    nodes: list[tuple] = []

    def add(node: tuple) -> int:
        nodes.append(node)
        return len(nodes) - 1

    # potentials: (scope tuple, coef ndarray, ids object-ndarray of
    # tuples-of-node-ids); the lambda potential of v carries v's indicators
    pots: list[tuple[tuple[int, ...], np.ndarray, np.ndarray]] = []
    for scope, table in zip(scopes, tables):
        ids = np.empty(table.shape, dtype=object)
        ids.fill(())
        pots.append((scope, table, ids))
    for v in range(n):
        lam_ids = np.empty((cards[v],), dtype=object)
        for s in range(cards[v]):
            row = np.zeros(cards[v])
            row[s] = 1.0
            lam_ids[s] = (add(("cat", v, row)),)
        pots.append(((v,), np.ones(cards[v]), lam_ids))

    if elimination_order is None:
        # greedy min-degree on the interaction graph
        adj: dict[int, set[int]] = {v: set() for v in range(n)}
        for scope in scopes:
            for a in scope:
                adj[a].update(u for u in scope if u != a)
        remaining = set(range(n))
        elimination_order = []
        while remaining:
            v = min(remaining, key=lambda u: len(adj[u] & remaining))
            elimination_order.append(v)
            nbrs = adj[v] & remaining
            for a in nbrs:
                adj[a].update(nbrs - {a})
            remaining.discard(v)
    elif sorted(elimination_order) != list(range(n)):
        raise ValueError("elimination_order must be a permutation of all variables")

    for v in elimination_order:
        bucket = [p for p in pots if v in p[0]]
        pots = [p for p in pots if v not in p[0]]
        merged = tuple(
            sorted({u for scope, _, _ in bucket for u in scope} - {v})
        )
        shape = [cards[u] for u in merged]
        if int(np.prod(shape + [cards[v]])) > max_table_entries:
            raise ValueError(
                f"Eliminating variable {v} builds a table of "
                f"{int(np.prod(shape + [cards[v]]))} entries "
                f"(> max_table_entries={max_table_entries}); pass a better "
                "elimination_order or raise the limit"
            )
        out_coef = np.ones(shape)
        out_ids = np.empty(shape, dtype=object)
        for a in np.ndindex(*shape):
            pos_of = dict(zip(merged, a))
            children, weights = [], []
            for s in range(cards[v]):
                pos_of[v] = s
                coef = 1.0
                ids: tuple[int, ...] = ()
                for scope, ctab, itab in bucket:
                    idx = tuple(pos_of[u] for u in scope)
                    coef *= float(ctab[idx])
                    ids += itab[idx]
                node = ids[0] if len(ids) == 1 else add(("prod", list(ids)))
                children.append(node)
                weights.append(coef)
            out_ids[a] = (add(("sum", children, np.asarray(weights))),)
        pots.append((merged, out_coef, out_ids))

    # all variables eliminated: every survivor is a scalar potential
    coef = 1.0
    ids = ()
    for _scope, ctab, itab in pots:
        coef *= float(ctab.reshape(-1)[0])
        ids += itab.reshape(-1)[0]
    if not ids:
        raise ValueError(f"{filename}: the network has no variables")
    root = ids[0] if len(ids) == 1 else add(("prod", list(ids)))
    if coef != 1.0:
        root = add(("sum", [root], np.asarray([coef])))
    return _build_scalar_circuit(nodes, root, learnable=False, freeze_onehot=True)


def load_uai_evidence(
    filename: str, num_variables: int, *, cards: list[int] | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Load a UAI ``.evid`` evidence file: one line of whitespace-separated
    tokens ``k v_1 x_1 ... v_k x_k`` (k observed variable/value pairs;
    files with a leading sample count of 1 are accepted too). Returns
    ``(x, observed)`` — a ``(1, num_variables)`` int32 assignment row
    (unobserved entries 0) and a ``(num_variables,)`` boolean mask —
    ready for the queries: pass ``integrate_vars=~observed`` to
    ``IntegrateQuery`` for the evidence marginal, or
    ``evidence_mask=observed`` to ``MAPQuery`` for MPE completion.

    Pass the network's ``cards`` to validate states against variable
    cardinalities (an evidence file for a different network otherwise
    produces silently wrong marginals — categorical indexing clamps);
    negative states always raise."""
    with open(filename, encoding="utf-8") as f:
        toks = [int(t) for t in f.read().split()]
    if not toks:
        raise ValueError(f"{filename}: empty evidence file")
    if len(toks) >= 2 and toks[0] == 1 and len(toks) == 2 * toks[1] + 2:
        toks = toks[1:]  # leading number-of-evidence-samples line
    k, pairs = toks[0], toks[1:]
    if len(pairs) != 2 * k:
        raise ValueError(
            f"{filename}: expected {k} (variable, value) pairs, "
            f"got {len(pairs) / 2:g}"
        )
    x = np.zeros((1, num_variables), dtype=np.int32)
    observed = np.zeros(num_variables, dtype=bool)
    for v, s in zip(pairs[0::2], pairs[1::2]):
        if not 0 <= v < num_variables:
            raise ValueError(f"{filename}: evidence variable {v} out of range")
        if s < 0 or (cards is not None and s >= cards[v]):
            raise ValueError(
                f"{filename}: evidence state {s} out of range for "
                f"variable {v}"
            )
        x[0, v] = s
        observed[v] = True
    return x, observed
