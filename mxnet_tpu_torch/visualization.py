"""Network visualization, `print_summary` and `plot_network`: the
counterpart of mxnet_tpu/visualization.py (reference
python/mxnet/visualization.py). A text table of layers, shapes and
parameter counts, the JAX package's text for the same symbol and shapes,
and a graphviz rendering of the symbol's graph when the graphviz package
is there (ImportError naming print_summary when it is not).
"""
import numpy as np


def _node_params(node, shapes_by_entry):
    """Parameter count = total size of this op's variable inputs."""
    total = 0
    for src, idx in node.inputs:
        if src.op is None and not src.name.endswith(('data', 'label')):
            s = shapes_by_entry.get((id(src), idx))
            if s:
                total += int(np.prod(s))
    return total


def print_summary(symbol, shape=None, line_length=120, positions=None):
    """Print a layer-by-layer summary (reference
    visualization.py print_summary)."""
    if positions is None:
        positions = [.44, .64, .74, 1.]
    shapes_by_entry = {}
    if shape is not None:
        var_shapes, _ = symbol._run_shape_inference(
            {k: tuple(v) for k, v in shape.items()}, partial=True)
        # re-run entry shape capture: walk topo inferring again
        topo = symbol._topo()
        entry = {}
        for node in topo:
            if node.op is None:
                s = var_shapes.get(node.name)
                if s:
                    entry[(id(node), 0)] = tuple(s)
                continue
            in_shapes = [entry.get((id(src), i)) for src, i in node.inputs]
            try:
                in_shapes, out_shapes = node.op.infer_shape(
                    node.attrs, in_shapes)
                for (src, i), s in zip(node.inputs, in_shapes):
                    if s is not None:
                        entry[(id(src), i)] = tuple(s)
                if out_shapes:
                    for i, s in enumerate(out_shapes):
                        entry[(id(node), i)] = tuple(s)
            except Exception:
                pass
        shapes_by_entry = entry

    positions = [int(line_length * p) for p in positions]
    fields = ['Layer (type)', 'Output Shape', 'Param #', 'Previous Layer']

    def print_row(f, pos):
        line = ''
        for i, field in enumerate(f):
            line += str(field)
            line = line[:pos[i]]
            line += ' ' * (pos[i] - len(line))
        print(line)

    print('_' * line_length)
    print_row(fields, positions)
    print('=' * line_length)
    total_params = 0
    topo = symbol._topo()
    for node in topo:
        if node.op is None:
            continue
        out_shape = shapes_by_entry.get((id(node), 0), '')
        params = _node_params(node, shapes_by_entry)
        total_params += params
        prev = ','.join(src.name for src, _ in node.inputs
                        if src.op is not None) or \
            ','.join(src.name for src, _ in node.inputs)
        print_row(['%s(%s)' % (node.name, node.op.name),
                   str(out_shape), str(params), prev], positions)
        print('_' * line_length)
    print('Total params: %d' % total_params)
    print('_' * line_length)
    return total_params


def plot_network(symbol, title='plot', save_format='pdf', shape=None,
                 node_attrs=None, hide_weights=True):
    """Render the symbol DAG with graphviz (reference
    visualization.py plot_network).  Requires the `graphviz` package."""
    try:
        from graphviz import Digraph
    except ImportError:
        raise ImportError(
            'plot_network requires the graphviz python package; install '
            'it or use print_summary instead')
    node_attrs = node_attrs or {}
    node_attr = {'shape': 'box', 'fixedsize': 'false',
                 'style': 'filled', 'align': 'center'}
    node_attr.update(node_attrs)
    dot = Digraph(name=title, format=save_format)
    topo = symbol._topo()
    hidden = set()
    palette = ['#8dd3c7', '#fb8072', '#ffffb3', '#bebada', '#80b1d3',
               '#fdb462', '#b3de69', '#fccde5']
    for node in topo:
        name = node.name
        if node.op is None:
            if hide_weights and not name.endswith(('data', 'label')):
                hidden.add(id(node))
                continue
            dot.node(name, name, node_attr,
                     fillcolor='#8dd3c7')
            continue
        color = palette[hash(node.op.name) % len(palette)]
        label = '%s\n%s' % (node.op.name, name)
        dot.node(name, label, node_attr, fillcolor=color)
    for node in topo:
        if node.op is None:
            continue
        for src, _ in node.inputs:
            if id(src) in hidden:
                continue
            dot.edge(src.name, node.name)
    return dot
