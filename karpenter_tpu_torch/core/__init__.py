"""Provisioning core of the port: the cluster store, the circuit
breaker, the actuator, the solve window and the provisioning loop
(``Provisioner``, whose solve runs on the card through ``make_solver``).

(Copy of ``karpenter_tpu/core/__init__.py``.)
"""
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.core.circuitbreaker import (
    CircuitBreaker, CircuitBreakerConfig, CircuitBreakerManager, CircuitBreakerOpenError,
)
from karpenter_tpu_torch.core.actuator import Actuator
from karpenter_tpu_torch.core.window import SolveWindow, WindowOptions
from karpenter_tpu_torch.core.provisioner import Provisioner, ProvisionerOptions

__all__ = [
    "ClusterState",
    "CircuitBreaker", "CircuitBreakerConfig", "CircuitBreakerManager",
    "CircuitBreakerOpenError",
    "Actuator", "SolveWindow", "WindowOptions",
    "Provisioner", "ProvisionerOptions",
]
