"""Eager NaN/Inf attribution.

Parity: the JAX package's fluid/debugger.py (:17-40) and the reference's
FLAGS_check_nan_inf (paddle/fluid/framework/operator.cc CheckNanInf). While
the check is active, Executor.run takes the artifact's eager walk
(StepArtifact.debug_step) instead of replaying its captured graph, checks
every floating output of every op and raises FloatingPointError naming the
first op whose output holds a NaN or an Inf. `pprint_program_codes` and
`draw_block_graphviz` (the JAX :42-67) print a program and write a dot
file of a block's op/var graph.
"""
import contextlib

__all__ = ['pprint_program_codes', 'draw_block_graphviz',
           'enable_check_nan_inf', 'disable_check_nan_inf',
           'nan_inf_check_active', 'check_nan_inf']

_check_nan_inf = {'active': False}


def enable_check_nan_inf():
    """Run subsequent Executor.run calls op by op, raising
    FloatingPointError naming the first op whose output is NaN/Inf."""
    _check_nan_inf['active'] = True


def disable_check_nan_inf():
    _check_nan_inf['active'] = False


def nan_inf_check_active():
    return _check_nan_inf['active']


@contextlib.contextmanager
def check_nan_inf():
    """Scoped debug mode: with debugger.check_nan_inf(): exe.run(...)"""
    prev = _check_nan_inf['active']
    _check_nan_inf['active'] = True
    try:
        yield
    finally:
        _check_nan_inf['active'] = prev


def pprint_program_codes(program):
    print(program.to_string())


def _var_id(name):
    return 'var_%s' % name.replace('.', '_').replace('@', '_')


def draw_block_graphviz(block, highlights=None, path="./temp.dot"):
    """Write a graphviz dot file of the block's op/var DAG (ops whose type
    is in `highlights` filled red); returns the path."""
    lines = ["digraph G {", "  rankdir=TB;"]
    highlights = set(highlights or [])
    for i, op in enumerate(block.ops):
        color = 'red' if op.type in highlights else 'lightblue'
        lines.append('  op%d [label="%s" shape=box style=filled '
                     'fillcolor=%s];' % (i, op.type, color))
        for vs in op.inputs.values():
            for v in vs:
                lines.append('  %s [label="%s" shape=ellipse];'
                             % (_var_id(v.name), v.name))
                lines.append('  %s -> op%d;' % (_var_id(v.name), i))
        for vs in op.outputs.values():
            for v in vs:
                lines.append('  %s [label="%s" shape=ellipse];'
                             % (_var_id(v.name), v.name))
                lines.append('  op%d -> %s;' % (i, _var_id(v.name)))
    lines.append("}")
    with open(path, 'w') as f:
        f.write("\n".join(lines))
    return path
