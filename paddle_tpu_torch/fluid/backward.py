"""append_backward: gradients for a loss.

Parity: reference python/paddle/fluid/backward.py:469 and the JAX package's
fluid/backward.py:19-54. As there, one `autodiff` op is planted instead of
a grad op per forward op. The Executor splits the op walk at it: it runs
the forward ops with the trainable parameters as leaves that require grad,
then torch.autograd.grad of the loss binds every `<param>@GRAD`, so each
op's backward is torch's autograd of the rule that defines its forward (and
the flash-attention kernel's own backward kernel). The public contract is
the reference's: `<param>@GRAD` Variables appear in the block and (param,
grad) pairs are returned for the optimizer.
"""
from . import framework
from .framework import grad_var_name

__all__ = ['append_backward']


def append_backward(loss, parameter_list=None, no_grad_set=None,
                    callbacks=None):
    """callbacks (the reference's error-clip hooks) are accepted and, as
    in the JAX package, not called."""
    assert loss is not None, "loss is required by append_backward"
    program = loss.block.program
    block = program.global_block()

    if parameter_list is not None:
        names = set(parameter_list)
        params = [p for p in block.all_parameters() if p.name in names]
    else:
        params = [p for p in block.all_parameters()]
    no_grad = set(no_grad_set or [])
    params = [p for p in params
              if p.trainable and not p.stop_gradient and p.name not in no_grad]

    forward_op_count = len(block.ops)
    grads = []
    for p in params:
        g = block.create_var(name=grad_var_name(p.name), shape=p.shape,
                             dtype=p.dtype, persistable=False)
        grads.append(g)

    block.append_op(
        type='autodiff',
        inputs={'Loss': [loss]},
        outputs={'Grads': grads},
        attrs={
            'loss_name': loss.name,
            'param_names': [p.name for p in params],
            'grad_names': [g.name for g in grads],
            'forward_op_count': forward_op_count,
            'op_role': framework.ROLE_BACKWARD,
        },
        infer_shape=False)

    return [(p, g) for p, g in zip(params, grads)]
