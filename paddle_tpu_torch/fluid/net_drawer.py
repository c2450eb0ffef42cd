"""Draw a Program's op/variable graph as graphviz dot.

Parity: the JAX package's fluid/net_drawer.py and the reference
python/paddle/fluid/net_drawer.py (draw_graph over the startup and main
programs; ops as rects, parameters highlighted)."""
import logging

from . import graphviz

__all__ = ['draw_graph']

logger = logging.getLogger(__name__)

OP_STYLE = dict(shape='rect', style='rounded,filled', fillcolor='lightblue')
VAR_STYLE = dict(shape='box', style='dotted')
PARAM_STYLE = dict(shape='ellipse', style='filled', fillcolor='lightgrey')


def parse_graph(program, graph, var_dict, **kwargs):
    block = program.global_block()
    param_names = {p.name for p in block.all_parameters()}
    for name in block.vars:
        if name not in var_dict:
            style = PARAM_STYLE if name in param_names else VAR_STYLE
            var_dict[name] = graph.add_node(name, prefix='var', **style)
    for op in block.ops:
        op_node = graph.add_node(op.type, prefix='op', **OP_STYLE)
        for _, invars in op.inputs.items():
            for v in invars:
                if v is not None and v.name in var_dict:
                    graph.add_edge(var_dict[v.name], op_node)
        for _, outvars in op.outputs.items():
            for v in outvars:
                if v is not None:
                    if v.name not in var_dict:
                        var_dict[v.name] = graph.add_node(
                            v.name, prefix='var', **VAR_STYLE)
                    graph.add_edge(op_node, var_dict[v.name])


def draw_graph(startup_program, main_program, path='graph.dot', **kwargs):
    """Emit one dot graph covering both programs; returns the dot path."""
    graph = graphviz.Graph('ProgramGraph', rankdir='TB')
    var_dict = {}
    if startup_program is not None:
        parse_graph(startup_program, graph, var_dict)
    if main_program is not None:
        parse_graph(main_program, graph, var_dict)
    graph.compile(path)
    return path
