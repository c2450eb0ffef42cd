"""paddle.batch. Parity: reference python/paddle/batch.py and the JAX
package's batch.py (the port keeps its own copy)."""

__all__ = ['batch']


def batch(reader, batch_size, drop_last=False):
    """Create a batched reader from a sample-level reader."""

    def batch_reader():
        r = reader()
        b = []
        for instance in r:
            b.append(instance)
            if len(b) == batch_size:
                yield b
                b = []
        if drop_last is False and len(b) != 0:
            yield b

    return batch_reader
