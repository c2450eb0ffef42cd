"""Debug and finiteness rules.

Parity: the JAX package's fluid/ops_impl/control_ops.py (reference
paddle/fluid/operators/{print,isfinite}_op.cc). The structured control
flow (While, IfElse, Switch, StaticRNN, DynamicRNN) lives in
block_ops.py; these are leaf rules.

`print` returns its input. JAX prints from the device (jax.debug.print)
on every run; a CUDA-graph replay runs no Python, and the warm-up of a
captured step may not read the card (a host sync raises there), so the
port prints on eager walks only: a CPU run, and on the card the eager
walk of debug_step (fluid.debugger.check_nan_inf). The warm-up, the
capture and every replay print nothing.
"""
import torch

from ..lowering import data_of, register


def _can_print(x):
    if x.device.type == 'cpu':
        return True
    if x.device.type != 'cuda':
        return False          # meta: build-time shape inference
    return (not torch.cuda.is_current_stream_capturing()
            and torch.cuda.get_sync_debug_mode() == 0)


@register('print')
def _print(ins, attrs, ctx):
    x = ins['In'][0]
    d = data_of(x)
    if _can_print(d):
        print('%s %s' % (attrs.get('message', '') or '', d.detach().cpu()))
    return {'Out': x}


@register('isfinite')
def _isfinite(ins, attrs, ctx):
    """One bool: every element of every input is finite."""
    ok = None
    for v in ins['X']:
        f = torch.isfinite(data_of(v)).all()
        ok = f if ok is None else ok & f
    if ok is None:
        ok = torch.ones((), dtype=torch.bool, device=ctx.device)
    return {'Out': ok}
