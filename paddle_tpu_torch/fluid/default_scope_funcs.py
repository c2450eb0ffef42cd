"""Thread-local default scope stack.

Parity: the JAX package's fluid/default_scope_funcs.py and the reference
python/paddle/fluid/default_scope_funcs.py: a thread-local stack of Scopes
with enter/leave local scope helpers and a `scoped_function` runner, over
the port's Scope (executor.py) instead of the reference's C++ core.Scope;
`var` creates or gets a slot holder in the current scope.
"""
import threading

from .executor import Scope

__all__ = [
    'get_cur_scope', 'enter_local_scope', 'leave_local_scope', 'var',
    'find_var', 'scoped_function'
]

_tl = threading.local()


def _stack():
    if not hasattr(_tl, 'scopes') or not _tl.scopes:
        _tl.scopes = [Scope()]
    return _tl.scopes


def get_cur_scope():
    """The innermost scope on this thread's stack."""
    return _stack()[-1]


def enter_local_scope():
    """Push a child scope (its lookups fall back to the parent)."""
    child = get_cur_scope().new_scope()
    _stack().append(child)
    return child


def leave_local_scope():
    """Pop the innermost scope; the root scope is never popped."""
    s = _stack()
    if len(s) > 1:
        s.pop()


def var(name):
    """Create (or fetch) variable `name` in the current scope; returns a
    holder with the reference Variable-like get/set surface."""
    scope = get_cur_scope()
    if name not in scope.vars:
        scope.vars[name] = None
    return _Holder(scope, name)


def find_var(name):
    """Find `name` walking the scope chain (innermost outward)."""
    scope = get_cur_scope()
    while scope is not None:
        if name in scope.vars:
            return _Holder(scope, name)
        scope = scope.parent
    return None


class _Holder(object):
    def __init__(self, scope, name):
        self._scope = scope
        self._name = name

    def get(self):
        return self._scope.vars[self._name]

    def set(self, value):
        self._scope.vars[self._name] = value

    def name(self):
        return self._name


def scoped_function(func):
    """Run `func` inside a fresh local scope (popped afterwards even on
    error)."""
    enter_local_scope()
    try:
        return func()
    finally:
        leave_local_scope()
