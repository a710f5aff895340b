"""Controller plane: the reference's 16 controllers rebuilt host-side.

The reference registers its controllers with controller-runtime
(``pkg/controllers/controllers.go:117-259``); here a small native runtime
(`runtime.py`) provides the same two shapes — watch-driven reconcilers and
singleton pollers with requeue — over the in-memory ClusterState, feeding
the solve loop on the card instead of the K8s API server.

(Copy of ``karpenter_tpu/controllers/__init__.py``.)
"""

from karpenter_tpu_torch.controllers.runtime import (  # noqa: F401
    ControllerManager, PollController, Result, WatchController,
)
