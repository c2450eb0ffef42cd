"""String/number compat helpers.

Parity: reference python/paddle/compat.py and the JAX package's
compat.py (to_text/to_bytes container-aware codecs, py2-style
round-half-away-from-zero, floor_division, get_exception_message).
Python-3 native: the py2 branches collapse.
"""
import math

__all__ = [
    'long_type',
    'to_text',
    'to_bytes',
    'round',
    'floor_division',
    'get_exception_message',
]

int_type = int
long_type = int


def _decode_one(obj, encoding):
    # non-bytes objects pass through unchanged (the reference's six.u is
    # an identity on py3 text; ints/tuples/etc. must not be repr-coerced)
    if isinstance(obj, bytes):
        return obj.decode(encoding)
    return obj


def to_text(obj, encoding='utf-8', inplace=False):
    """Decode obj (or every item of a list/set obj) to str."""
    if obj is None:
        return obj
    if isinstance(obj, list):
        if inplace:
            obj[:] = [_decode_one(v, encoding) for v in obj]
            return obj
        return [_decode_one(v, encoding) for v in obj]
    if isinstance(obj, set):
        decoded = {_decode_one(v, encoding) for v in obj}
        if inplace:
            obj.clear()
            obj.update(decoded)
            return obj
        return decoded
    return _decode_one(obj, encoding)


def _encode_one(obj, encoding):
    assert encoding is not None
    if isinstance(obj, str):
        return obj.encode(encoding)
    # bytes as-is; other objects pass through unchanged (see _decode_one)
    return obj


def to_bytes(obj, encoding='utf-8', inplace=False):
    """Encode obj (or every item of a list/set obj) to bytes."""
    if obj is None:
        return obj
    if isinstance(obj, list):
        if inplace:
            obj[:] = [_encode_one(v, encoding) for v in obj]
            return obj
        return [_encode_one(v, encoding) for v in obj]
    if isinstance(obj, set):
        encoded = {_encode_one(v, encoding) for v in obj}
        if inplace:
            obj.clear()
            obj.update(encoded)
            return obj
        return encoded
    return _encode_one(obj, encoding)


def round(x, d=0):
    """Round half away from zero (python2 semantics; python3's builtin
    rounds half to even)."""
    p = 10 ** d
    if x > 0.0:
        return float(math.floor(x * p + 0.5)) / p
    if x < 0.0:
        return float(math.ceil(x * p - 0.5)) / p
    return math.copysign(0.0, x)


def floor_division(x, y):
    return x // y


def get_exception_message(exc):
    assert exc is not None
    return str(exc)
