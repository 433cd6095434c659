"""Serving (``multihmr_tpu/serve``): the dynamic batcher and the HTTP server."""

from multihmr_tpu_torch.serve.batcher import (  # noqa: F401
    BatcherStats,
    DeadlineExceeded,
    DynamicBatcher,
    QueueFull,
)
from multihmr_tpu_torch.serve.server import (  # noqa: F401
    build_batched_infer,
    make_server,
    serve_forever_in_thread,
)
