"""Graphviz rendering of symbolic circuits.

Rebuild of ``cirkit/symbolic/io.py:11-155``: purely introspective — renders
the layer DAG with sum/product/input styling; returns the ``graphviz``
object (renders inline in notebooks) and optionally writes a file whose
format is deduced from the extension.
"""

from __future__ import annotations

from collections.abc import Callable
from os import PathLike
from pathlib import Path

from cirkit_tpu_torch.symbolic.circuit import Circuit
from cirkit_tpu_torch.symbolic.layers import (
    HadamardLayer,
    InputLayer,
    KroneckerLayer,
    Layer,
    ProductLayer,
    SumLayer,
)


def _resolve(value, layer, default):
    if value is None:
        return default(layer)
    return value(layer) if callable(value) else value


def _default_product_label(sl: ProductLayer) -> str:
    if isinstance(sl, HadamardLayer):
        return "⊙"
    if isinstance(sl, KroneckerLayer):
        return "⊗"
    return "×"


def _default_input_label(sl: InputLayer) -> str:
    return f"{type(sl).__name__.replace('Layer', '')}({sl.scope})"


def plot_circuit(
    circuit: Circuit,
    out_path: str | PathLike[str] | None = None,
    orientation: str = "vertical",
    node_shape: str = "box",
    label_font: str = "times italic bold",
    label_size: str = "21pt",
    label_color: str = "white",
    sum_label: str | Callable[[SumLayer], str] = "+",
    sum_color: str | Callable[[SumLayer], str] = "#607d8b",
    product_label: str | Callable[[ProductLayer], str] | None = None,
    product_color: str | Callable[[ProductLayer], str] = "#24a5af",
    input_label: str | Callable[[InputLayer], str] | None = None,
    input_color: str | Callable[[InputLayer], str] = "#ffbd2a",
):
    """Render a symbolic circuit with graphviz.

    Labels/colors accept either a constant or a per-layer callable. Returns
    the ``graphviz.Digraph``; when ``out_path`` is given the plot is also
    rendered to that file (format deduced from the extension).
    """
    import graphviz

    if orientation not in ("vertical", "horizontal"):
        raise ValueError("Orientation must be 'vertical' or 'horizontal'")

    fmt = "svg"
    if out_path is not None:
        suffix = Path(out_path).suffix.lower().lstrip(".")
        if suffix:
            fmt = "jpg" if suffix == "jpeg" else suffix

    dot = graphviz.Digraph(
        format=fmt,
        node_attr={
            "shape": node_shape,
            "style": "filled",
            "fontcolor": label_color,
            "fontsize": label_size,
            "fontname": label_font,
        },
        engine="dot",
    )
    dot.graph_attr["rankdir"] = "BT" if orientation == "vertical" else "LR"

    def node_id(sl: Layer) -> str:
        return f"l{id(sl):x}"

    for sl in circuit.layers:
        if isinstance(sl, SumLayer):
            label = _resolve(sum_label, sl, lambda _: "+")
            color = _resolve(sum_color, sl, lambda _: "#607d8b")
        elif isinstance(sl, ProductLayer):
            label = _resolve(product_label, sl, _default_product_label)
            color = _resolve(product_color, sl, lambda _: "#24a5af")
        else:
            label = _resolve(input_label, sl, _default_input_label)
            color = _resolve(input_color, sl, lambda _: "#ffbd2a")
        dot.node(node_id(sl), str(label), fillcolor=str(color))

    for sl in circuit.layers:
        for sl_in in circuit.layer_inputs(sl):
            dot.edge(node_id(sl_in), node_id(sl))

    if out_path is not None:
        out_path = Path(out_path)
        dot.render(outfile=out_path, filename=out_path.with_suffix(""), cleanup=True)
    return dot
