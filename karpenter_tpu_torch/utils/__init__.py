"""Host utilities of the port: the metric registry and the component
logger, copied from ``karpenter_tpu/utils`` (the port imports nothing of
the JAX package)."""

from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch.utils.logging import get_logger

__all__ = ["get_logger", "metrics"]
