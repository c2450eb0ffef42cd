"""API annotations (parity: the JAX package's fluid/annotations.py and the
reference python/paddle/fluid/annotations.py): the `deprecated` decorator
used across the fluid API."""
import functools
import sys

__all__ = ['deprecated']


def deprecated(since, instead, extra_message=""):
    """Mark an API as deprecated since version `since`; point at `instead`."""
    def decorator(func):
        err_msg = "API {0} is deprecated since {1}. Please use {2} instead.".format(
            func.__name__, since, instead)
        if extra_message:
            err_msg += "\n" + extra_message

        @functools.wraps(func)
        def wrapper(*args, **kwargs):
            print(err_msg, file=sys.stderr)
            return func(*args, **kwargs)

        wrapper.__doc__ = (("\n\nWarning: " + err_msg + "\n")
                           + (func.__doc__ or ""))
        return wrapper
    return decorator
