"""Copy of ``karpenter_tpu/cloud/__init__.py``."""

from karpenter_tpu_torch.cloud.errors import (
    CloudError, is_not_found, is_rate_limit, is_retryable, is_timeout,
)
from karpenter_tpu_torch.cloud.retry import retry_with_backoff, RetryConfig
from karpenter_tpu_torch.cloud.fake import FakeCloud, FakeInstance, FakeSubnet, FakeImage

__all__ = [
    "CloudError", "is_not_found", "is_rate_limit", "is_retryable", "is_timeout",
    "retry_with_backoff", "RetryConfig",
    "FakeCloud", "FakeInstance", "FakeSubnet", "FakeImage",
]
