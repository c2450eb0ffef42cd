"""Shape-bucket policy for the serving engine.

Parity: the JAX package's serving/buckets.py. Every micro-batch is padded
UP to one of a small closed set of batch-dimension buckets (powers of two
by default), so the model sees a bounded set of batch shapes and
`warmup()` can run each of them before traffic arrives: first-use costs
on the card (kernel build, allocator growth, matmul heuristics) are paid
there, not by a request.

Host-side and stdlib+numpy only: padding happens on the request rows
BEFORE the feed crosses to the device.
"""
import numpy as np

__all__ = ['default_buckets', 'pick_bucket', 'pad_rows']


def default_buckets(max_batch_size):
    """Powers of two up to max_batch_size, always including
    max_batch_size itself: 32 -> (1, 2, 4, 8, 16, 32); 24 -> (1, 2, 4,
    8, 16, 24). The smallest buckets keep single-request latency from
    paying a full max-batch worth of padded FLOPs under light load."""
    m = int(max_batch_size)
    if m < 1:
        raise ValueError('max_batch_size must be >= 1, got %r'
                         % (max_batch_size,))
    out = []
    b = 1
    while b < m:
        out.append(b)
        b *= 2
    out.append(m)
    return tuple(out)


def pick_bucket(n, buckets):
    """Smallest bucket >= n rows. ValueError when n exceeds every bucket
    (admission control should have split or rejected the batch first)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError('batch of %d rows exceeds the largest bucket %d'
                     % (n, max(buckets)))


def pad_rows(arr, bucket):
    """Pad `arr` along axis 0 up to `bucket` rows by repeating the last
    row (repeated real rows keep every dtype valid — e.g. embedding ids
    stay in-vocabulary, where zero-fill could not promise that). The
    padded rows are sliced off the outputs before results reach any
    caller, so their values only need to be *computable*, never
    correct."""
    arr = np.asarray(arr)
    n = arr.shape[0]
    if n == bucket:
        return arr
    if n > bucket:
        raise ValueError('cannot pad %d rows down to bucket %d'
                         % (n, bucket))
    pad = np.repeat(arr[-1:], bucket - n, axis=0)
    return np.concatenate([arr, pad], axis=0)
