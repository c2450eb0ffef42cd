"""paddle_tpu_torch.serving — dynamic micro-batching serving engine.

Parity: the JAX package's paddle_tpu.serving, reduced to the
`ServingEngine` over a `Predictor` (the decode engine, router, pod and
transport layers wait for later slices of the port).

    from paddle_tpu_torch import inference, serving

    pred = inference.Predictor(model_dir)        # CUDAPlace(0)
    eng = serving.ServingEngine(pred, serving.ServingConfig(
        max_batch_size=16, max_queue_delay_ms=5))
    eng.warmup()                       # run every bucket once
    fut = eng.submit({'x': batch})     # concurrent.futures.Future
    logits, = fut.result()
    eng.shutdown()                     # drains in-flight requests
"""
from . import buckets  # noqa: F401
from .buckets import default_buckets, pad_rows, pick_bucket  # noqa: F401
from .engine import (DeadlineExceeded, ServerClosed,  # noqa: F401
                     ServerOverloaded, ServingConfig, ServingEngine)

__all__ = ['ServingEngine', 'ServingConfig', 'ServerOverloaded',
           'ServerClosed', 'DeadlineExceeded', 'buckets',
           'default_buckets', 'pick_bucket', 'pad_rows']
