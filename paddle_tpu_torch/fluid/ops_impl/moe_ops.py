"""Mixture-of-experts op lowering.

Parity: the JAX package's fluid/ops_impl/moe_ops.py (:33-111). The
`moe_mlp` op is a top-k gated two-layer expert FFN:

  gate_logits = x @ gate_w                       [N, E]
  expert e:  y = act(x @ w1[e] + b1[e]) @ w2[e] + b2[e]

Dispatch uses the Switch/GShard fixed-capacity packing of parallel/moe.py:
tokens routed top-k, packed into [E, capacity] slots (overflow dropped,
first choices before second), gate-weighted on return. The op also emits
the load-balancing auxiliary loss E * sum_e f_e * P_e as the scalar
`AuxLoss`, computed on the global batch's logits. Two paths, as in JAX:

- mesh path: when the step runs on a mesh (set_mesh, ParallelExecutor or
  DistributeTranspiler) whose dp size divides num_experts, each rank runs
  num_experts/dp experts and its tokens ride TWO all_to_alls
  (parallel.moe.moe_apply); the capacity counts the rank's own tokens.
- dense path: the same pack/transform/unpack with every expert run
  locally (torch.func.vmap over the experts: a batched product). Under a
  dp mesh whose size does not divide num_experts it routes the GLOBAL
  tokens (gathered from the ranks) with the global capacity and keeps
  this rank's rows, as the JAX dense path does on the sharded batch.

The two agree exactly when capacity is not exceeded; under overflow the
drop pattern differs (per rank vs global token order), as in JAX.
"""
import torch
import torch.nn.functional as F

from ...parallel import _comm
from ...parallel.moe import (combine_topk, load_balancing_loss, moe_apply,
                             pack_topk)
from ..lowering import amp_cast, data_of, register

_ACTS = {
    'relu': torch.relu,
    # jax.nn.gelu's default is the tanh approximation
    'gelu': lambda x: F.gelu(x, approximate='tanh'),
    'tanh': torch.tanh,
    'sigmoid': torch.sigmoid,
    'swish': F.silu,
    None: lambda x: x,
    '': lambda x: x,
}


def supported_acts():
    """Expert activations the rule can lower (layers.moe_mlp validates
    against this at construction time)."""
    return set(_ACTS)


def _expert_mlp(p, t, act):
    h = _ACTS[act](t @ p['w1'] + p['b1'])
    return h @ p['w2'] + p['b2']


def _dense_moe(params, x, logits, capacity_factor, act, top_k):
    """Local pack/transform/unpack with moe_apply's fixed-capacity
    semantics (minus the all_to_alls): the routing is pack_topk /
    combine_topk's, so the paths cannot drift."""
    nt = x.shape[0]
    n_exp = logits.shape[-1]
    cap = int(max(1, capacity_factor * top_k * nt / n_exp))
    send, route = pack_topk(x, logits, n_exp, cap, top_k)
    out = torch.func.vmap(lambda p, t: _expert_mlp(p, t, act))(params, send)
    return combine_topk(out, route, x.dtype)


@register('moe_mlp')
def _moe_mlp(ins, attrs, ctx):
    x = data_of(ins['X'][0])
    gate_w = data_of(ins['GateW'][0])
    params = {
        'w1': data_of(ins['W1'][0]), 'b1': data_of(ins['B1'][0]),
        'w2': data_of(ins['W2'][0]), 'b2': data_of(ins['B2'][0]),
    }
    act = attrs.get('act') or None
    cf = float(attrs.get('capacity_factor', 2.0))
    n_exp = int(attrs.get('num_experts'))
    top_k = int(attrs.get('top_k', 1))

    shape_in = tuple(x.shape)
    if x.ndim > 2:
        x = x.reshape(-1, x.shape[-1])
    x, gate_w = amp_cast(ctx, x, gate_w)
    params = dict(zip(params, amp_cast(ctx, *params.values())))
    if x.is_meta:
        # build-time shape inference: the routing's [tokens, experts]
        # cumsum on the dynamic batch's stand-in is not worth tracing
        out = x.new_empty(shape_in[:-1] + tuple(params['w2'].shape[-1:]))
        return {'Out': out,
                'AuxLoss': torch.empty((), dtype=torch.float32,
                                       device='meta')}
    mesh = ctx.mesh
    group = mesh.group('dp') if mesh is not None else None
    if group is not None and n_exp % mesh.shape['dp'] == 0:
        logits = (x @ gate_w).to(torch.float32)
        # the auxiliary loss of the global batch's logits
        aux = load_balancing_loss(_comm.all_gather(logits, 0, group), top_k)
        y = moe_apply(lambda p, t: _expert_mlp(p, t, act), params, x,
                      logits, mesh, axis='dp', capacity_factor=cf,
                      top_k=top_k)
    elif group is not None:
        nt = x.shape[0]
        xg = _comm.all_gather(x, 0, group)
        logits = (xg @ gate_w).to(torch.float32)
        aux = load_balancing_loss(logits, top_k)
        y = _dense_moe(params, xg, logits, cf, act, top_k).narrow(
            0, mesh.coords['dp'] * nt, nt)
    else:
        logits = (x @ gate_w).to(torch.float32)
        aux = load_balancing_loss(logits, top_k)
        y = _dense_moe(params, x, logits, cf, act, top_k)
    return {'Out': y.reshape(shape_in[:-1] + tuple(y.shape[-1:])),
            'AuxLoss': aux}
