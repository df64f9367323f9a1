"""mx.viz — network visualization (a copy of ``mxnet_tpu/visualization.py``).

Reference: python/mxnet/visualization.py (print_summary:39,
plot_network:214). print_summary walks the Symbol DAG and prints the
layer table with parameter counts; plot_network emits a graphviz
Digraph when the graphviz package is importable (else it raises
ImportError naming ``print_summary``).
"""
from __future__ import annotations

__all__ = ["print_summary", "plot_network"]


def _param_count(node, shapes):
    total = 0
    for inp in node._inputs:
        if inp._is_var() and inp._name in shapes and \
                not inp._name.endswith("_label") and inp._name != "data":
            n = 1
            for s in shapes[inp._name]:
                n *= s
            total += n
    return total


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """Print a layer-by-layer summary table (reference:
    visualization.py:39). ``shape``: dict of input shapes for shape
    inference (e.g. {'data': (1, 3, 224, 224)})."""
    positions = positions or [0.44, 0.64, 0.74, 1.0]
    shapes = {}
    out_shapes = {}
    if shape:
        arg_shapes, _, aux_shapes = symbol.infer_shape(**shape)
        args = symbol.list_arguments()
        shapes = dict(zip(args, arg_shapes))
        shapes.update(zip(symbol.list_auxiliary_states(), aux_shapes))

    cols = [int(line_length * p) for p in positions]
    header = ["Layer (type)", "Output Shape", "Param #", "Previous Layer"]

    def row(fields):
        line = ""
        for f, c in zip(fields, cols):
            line = (line + str(f))[:c].ljust(c)
        print(line)

    print("=" * line_length)
    row(header)
    print("=" * line_length)
    total = 0
    for node in symbol._topo():
        if node._is_var():
            continue
        # per-node output shape via eval on the subgraph when available
        oshape = ""
        if shape:
            try:
                _, os_, _ = node.infer_shape(**{
                    k: v for k, v in shape.items()
                    if k in node.list_inputs()})
                oshape = str(os_[0])
            except Exception:
                oshape = "?"
        prev = ",".join(i._name for i in node._inputs
                        if not i._is_var())[:40]
        n_params = _param_count(node, shapes)
        total += n_params
        row([f"{node._name} ({node._op})", oshape, n_params, prev])
    print("=" * line_length)
    print(f"Total params: {total}")
    print("=" * line_length)
    return total


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Graphviz Digraph of the Symbol DAG (reference:
    visualization.py:214). Requires the ``graphviz`` package."""
    try:
        from graphviz import Digraph
    except ImportError as e:
        raise ImportError(
            "plot_network requires the graphviz package; use "
            "print_summary for a text rendering") from e
    dot = Digraph(name=title, format=save_format)
    for node in symbol._topo():
        if node._is_var():
            if not hide_weights or node._name in ("data",) or \
                    not any(node._name.endswith(s) for s in
                            ("_weight", "_bias", "_gamma", "_beta",
                             "_moving_mean", "_moving_var")):
                dot.node(node._name, node._name, shape="oval")
            continue
        dot.node(node._name, f"{node._name}\n{node._op}", shape="box")
        for inp in node._inputs:
            if inp._is_var() and hide_weights and \
                    any(inp._name.endswith(s) for s in
                        ("_weight", "_bias", "_gamma", "_beta",
                         "_moving_mean", "_moving_var")):
                continue
            dot.edge(inp._name, node._name)
    return dot
