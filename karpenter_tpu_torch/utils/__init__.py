"""Host utilities of the port: the TTL cache, the request batcher, the
metric registry and the component logger, copied from
``karpenter_tpu/utils`` (the port imports nothing of the JAX package)."""

from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.batcher import Batcher, BatcherOptions
from karpenter_tpu_torch.utils.cache import TTLCache
from karpenter_tpu_torch.utils.logging import get_logger

__all__ = ["Batcher", "BatcherOptions", "TTLCache", "get_logger", "metrics"]
