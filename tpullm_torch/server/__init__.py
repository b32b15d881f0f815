"""OpenAI-compatible completion server of the PyTorch port: slots as fixed
batch rows of the KV cache, a task queue feeding one inference loop thread,
chunked prefill with prefix-cache reuse, chunked decode with per-slot
sampler parameters, SSE streaming, Prometheus metrics."""
from .context import GenParams, ServerContext, Task
from .http import serve

__all__ = ["GenParams", "ServerContext", "Task", "serve"]
