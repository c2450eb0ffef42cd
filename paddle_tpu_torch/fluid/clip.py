"""Gradient clipping.

Parity: reference python/paddle/fluid/clip.py and the JAX package's
fluid/clip.py: clip by value, by norm and by global norm, as ops appended
between the autodiff marker and the optimizer's update ops.
ErrorClipByValue appends its clip where a caller asks for it; as in the
JAX package, append_backward applies no error clip (its callbacks are
accepted and not called).
"""
import copy

from . import framework

__all__ = ['ErrorClipByValue', 'GradientClipByValue', 'GradientClipByNorm',
           'GradientClipByGlobalNorm', 'set_gradient_clip',
           'append_gradient_clip_ops']


class BaseErrorClipAttr(object):
    def _append_clip_op(self, block, grad_name):
        raise NotImplementedError


class ErrorClipByValue(BaseErrorClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _append_clip_op(self, block, grad_name):
        var = block.var(grad_name)
        block.append_op(type='clip', inputs={'X': var}, outputs={'Out': var},
                        attrs={'min': self.min, 'max': self.max,
                               'op_role': framework.ROLE_BACKWARD},
                        infer_shape=False)


class BaseGradientClipAttr(object):
    def _process_context(self, context, param, grad):
        pass

    def _create_operators(self, param, grad):
        raise NotImplementedError


class NullGradientClipAttr(BaseGradientClipAttr):
    def _create_operators(self, param, grad):
        return param, grad


class GradientClipByValue(BaseGradientClipAttr):
    def __init__(self, max, min=None):
        max = float(max)
        self.max = max
        self.min = float(min) if min is not None else -max

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(dtype=grad.dtype, shape=grad.shape)
        block.append_op(type='clip', inputs={'X': grad}, outputs={'Out': out},
                        attrs={'min': self.min, 'max': self.max,
                               'op_role': framework.ROLE_BACKWARD})
        return param, out


class GradientClipByNorm(BaseGradientClipAttr):
    def __init__(self, clip_norm):
        self.clip_norm = clip_norm

    def _create_operators(self, param, grad):
        block = grad.block
        out = block.create_var(dtype=grad.dtype, shape=grad.shape)
        block.append_op(type='clip_by_norm', inputs={'X': grad},
                        outputs={'Out': out},
                        attrs={'max_norm': self.clip_norm,
                               'op_role': framework.ROLE_BACKWARD})
        return param, out


class GradientClipByGlobalNorm(BaseGradientClipAttr):
    """reference clip.py GradientClipByGlobalNorm: scale all grads by
    clip_norm / max(global_norm, clip_norm)."""

    def __init__(self, clip_norm, group_name='default_group'):
        self.clip_norm = clip_norm
        self.group_name = group_name

    def _process_context(self, context, param, grad):
        ctx = context.setdefault(self.group_name,
                                 {'grads': [], 'clip_norm': self.clip_norm})
        ctx['grads'].append((param, grad))

    def _create_operators(self, param, grad):
        return param, grad  # actual ops emitted by append_gradient_clip_ops

    @staticmethod
    def _emit_group(ctx):
        pgs = ctx['grads']
        block = pgs[0][1].block
        role = {'op_role': framework.ROLE_BACKWARD}
        sq_sums = []
        for _, g in pgs:
            sq = block.create_var(dtype=g.dtype)
            block.append_op(type='square', inputs={'X': g},
                            outputs={'Out': sq}, attrs=dict(role))
            red = block.create_var(dtype=g.dtype)
            block.append_op(type='reduce_sum', inputs={'X': sq},
                            outputs={'Out': red},
                            attrs=dict(role, reduce_all=True))
            sq_sums.append(red)
        gsum = block.create_var(dtype=sq_sums[0].dtype)
        block.append_op(type='sum', inputs={'X': sq_sums},
                        outputs={'Out': gsum}, attrs=dict(role))
        gnorm = block.create_var(dtype=gsum.dtype)
        block.append_op(type='sqrt', inputs={'X': gsum},
                        outputs={'Out': gnorm}, attrs=dict(role))
        clip_c = block.create_var(dtype=gnorm.dtype)
        block.append_op(type='fill_constant', outputs={'Out': clip_c},
                        attrs=dict(role, shape=[], dtype='float32',
                                   value=float(ctx['clip_norm'])),
                        infer_shape=False)
        denom = block.create_var(dtype=gnorm.dtype)
        block.append_op(type='elementwise_max',
                        inputs={'X': gnorm, 'Y': clip_c},
                        outputs={'Out': denom}, attrs=dict(role))
        scale = block.create_var(dtype=gnorm.dtype)
        block.append_op(type='elementwise_div',
                        inputs={'X': clip_c, 'Y': denom},
                        outputs={'Out': scale}, attrs=dict(role))
        outs = []
        for p, g in pgs:
            ng = g.block.create_var(dtype=g.dtype, shape=g.shape)
            g.block.append_op(type='elementwise_mul',
                              inputs={'X': g, 'Y': scale},
                              outputs={'Out': ng}, attrs=dict(role))
            outs.append((p, ng))
        return outs


def set_gradient_clip(clip, param_list=None, program=None):
    """reference clip.py:set_gradient_clip."""
    if not isinstance(clip, BaseGradientClipAttr):
        raise TypeError("clip should be BaseGradientClipAttr")
    if program is None:
        program = framework.default_main_program()
    if param_list is None:
        param_list = program.global_block().all_parameters()
    if all(isinstance(elem, str) for elem in param_list):
        param_list = [framework.get_var(name, program) for name in param_list]
    for param in param_list:
        param.gradient_clip_attr = copy.deepcopy(clip)


def append_gradient_clip_ops(param_grad):
    context = {}
    clips = []
    for p, g in param_grad:
        clip_attr = getattr(p, 'gradient_clip_attr', None) \
            or NullGradientClipAttr()
        clips.append(clip_attr)
        clip_attr._process_context(context, p, g)
    res = []
    global_groups = {}
    for (p, g), clip_attr in zip(param_grad, clips):
        if isinstance(clip_attr, GradientClipByGlobalNorm):
            global_groups.setdefault(clip_attr.group_name, []).append((p, g))
        else:
            res.append(clip_attr._create_operators(p, g))
    for name in global_groups:
        res.extend(GradientClipByGlobalNorm._emit_group(context[name]))
    return res
