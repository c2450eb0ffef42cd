"""Shared mesh_axes annotation rebuild for the parallelism transpilers
(the JAX package's fluid/transpiler/_mesh_axes.py)."""

# the executor's canonical axis order: dp, tp, pp, sp
_CANONICAL = ('dp', 'tp', 'pp', 'sp')


def rebuild_mesh_axes(base):
    """The mesh_axes annotation from the MERGED axis sizes of a
    _dist_config, in the canonical order, naming the pipeline axis by its
    configured pp_axis rather than the literal 'pp'. Every transpiler calls
    this after updating its own *_size so later transpiles never clobber
    earlier axes."""
    pp_ax = base.get('pp_axis', 'pp')
    return tuple(
        (pp_ax if ax == 'pp' else ax) for ax in _CANONICAL
        if int(base.get(ax + '_size') or 1) > 1)
