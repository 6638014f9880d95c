"""Graphviz rendering of region graphs.

Rebuild of ``cirkit/templates/region_graph/io.py:10-133``: regions render as
rounded boxes labeled with their scope, partitions as small circles.
"""

from __future__ import annotations

from collections.abc import Callable
from os import PathLike
from pathlib import Path

from cirkit_tpu_torch.models.region_graph.graph import PartitionNode, RegionGraph, RegionNode


def plot_region_graph(
    region_graph: RegionGraph,
    out_path: str | PathLike[str] | None = None,
    orientation: str = "vertical",
    label_font: str = "times italic bold",
    label_size: str = "21pt",
    label_color: str = "white",
    region_label: str | Callable[[RegionNode], str] | None = None,
    region_color: str | Callable[[RegionNode], str] = "#607d8b",
    partition_label: str | Callable[[PartitionNode], str] = "⊗",
    partition_color: str | Callable[[PartitionNode], str] = "#24a5af",
):
    """Render a region graph with graphviz; see :func:`plot_circuit`."""
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
            "style": "filled",
            "fontcolor": label_color,
            "fontsize": label_size,
            "fontname": label_font,
        },
        engine="dot",
    )
    dot.graph_attr["rankdir"] = "BT" if orientation == "vertical" else "LR"

    for node in region_graph.nodes:
        nid = f"n{id(node):x}"
        if isinstance(node, RegionNode):
            label = region_label
            if label is None:
                label = str(node.scope)
            elif callable(label):
                label = label(node)
            color = region_color(node) if callable(region_color) else region_color
            dot.node(nid, str(label), shape="box", style="rounded,filled", fillcolor=str(color))
        else:
            label = partition_label(node) if callable(partition_label) else partition_label
            color = partition_color(node) if callable(partition_color) else partition_color
            dot.node(nid, str(label), shape="circle", fillcolor=str(color))

    for node in region_graph.nodes:
        for child in region_graph.node_inputs(node):
            dot.edge(f"n{id(child):x}", f"n{id(node):x}")

    if out_path is not None:
        out_path = Path(out_path)
        dot.render(outfile=out_path, filename=out_path.with_suffix(""), cleanup=True)
    return dot
