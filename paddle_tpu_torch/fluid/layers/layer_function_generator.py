"""Layer-function generation utilities.

Parity: the JAX package's fluid/layers/layer_function_generator.py and the
reference python/paddle/fluid/layers/layer_function_generator.py, which
reads the C++ OpProto registry and stamps out a Python layer function per
registered operator (generate_layer_fn), plus the deprecated / autodoc /
templatedoc decorators used across layers/*.py.

There is no OpProto registry: ops are lowering rules (op type -> torch
rule) in paddle_tpu_torch.fluid.lowering. generate_layer_fn stamps a
LayerHelper-based layer for any registered rule: tensor inputs map to the
slots 'X', 'Y', 'Z', 'A', ... in order, the remaining kwargs become op
attrs, and one output 'Out' takes the first input's dtype. The decorators
keep the reference's documented semantics.
"""
import functools
import re
import string
import warnings

from ..layer_helper import LayerHelper

__all__ = ['deprecated', 'generate_layer_fn', 'autodoc', 'templatedoc']


def deprecated(func_or_class):
    """Mark a layer as deprecated: emits DeprecationWarning on call
    (reference layer_function_generator.py deprecated)."""

    @functools.wraps(func_or_class)
    def wrapper(*args, **kwargs):
        warnings.warn(
            "API {0} is deprecated since paddle_tpu 1.0".format(
                func_or_class.__name__),
            DeprecationWarning, stacklevel=2)
        return func_or_class(*args, **kwargs)

    return wrapper


def autodoc(comment=""):
    """Attach an auto-generated docstring (reference autodoc). With no op
    proto to render, documents the op type and signature."""

    def decorator(func):
        if not func.__doc__:
            func.__doc__ = comment or (
                "Layer %s: lowered to the registered '%s' rule."
                % (func.__name__, func.__name__))
        return func

    return decorator


_TMPL_PATTERN = re.compile(r"\$\{([^}]+)\}")


def templatedoc(op_type=None):
    """Render ${comment}-style placeholders in a layer docstring
    (reference templatedoc). With no OpProto metadata here, ``${comment}``
    renders as the op name, ``${x_comment}`` as the slot name ("x"), and
    ``${x_type}`` as "Variable" (the reference renders proto var types)."""

    def decorator(func):
        doc = func.__doc__ or ""
        tname = op_type or func.__name__

        def _sub(m):
            key = m.group(1)
            if key == 'comment':
                return "The %s operator." % tname
            if key.endswith('_type'):
                return "Variable"
            if key.endswith('_comment'):
                return key[:-len('_comment')]
            return key

        func.__doc__ = _TMPL_PATTERN.sub(_sub, doc)
        return func

    return decorator


def generate_layer_fn(op_type):
    """Stamp a layer function for a registered lowering rule.

    The generated layer mirrors the reference's generated signature:
    positional/keyword tensor inputs (x, y), optional name, remaining
    kwargs become attributes. The reference's generate_layer_fn
    introspects the OpProto; here the lowering registry is the source of
    truth.
    """
    from ..lowering import has_rule
    if not has_rule(op_type):
        raise ValueError(
            "No lowering rule registered for op '%s'" % op_type)

    def layer(*args, **kwargs):
        helper = LayerHelper(op_type, name=kwargs.pop('name', None),
                             act=kwargs.pop('act', None))
        inputs = {}
        vars_in = list(args)
        for slot_kw in ('input', 'x'):
            if slot_kw in kwargs:
                vars_in.insert(0, kwargs.pop(slot_kw))
        if 'y' in kwargs:
            vars_in.append(kwargs.pop('y'))
        if not vars_in:
            raise ValueError(
                "generate_layer_fn(%s): at least one tensor input required"
                % op_type)
        slots = ['X', 'Y', 'Z'] + list(string.ascii_uppercase[:23])
        for slot, v in zip(slots, vars_in):
            inputs[slot] = [v]
        dtype = kwargs.pop('dtype', None) or vars_in[0].dtype
        out = helper.create_variable_for_type_inference(dtype)
        helper.append_op(type=op_type, inputs=inputs,
                         outputs={'Out': [out]}, attrs=kwargs)
        return helper.append_activation(out)

    layer.__name__ = op_type
    layer.__doc__ = ("Generated layer for the '%s' op (reference "
                     "layer_function_generator.py)." % op_type)
    return layer
