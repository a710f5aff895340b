"""Operator layer: process wiring, layered options, credential store
(port of ``karpenter_tpu/operator``).

The L0/L1 equivalent of the reference (``cmd/controller/main.go`` +
``pkg/operator``): validates credentials, builds the shared providers and
blackout cache, registers every controller, and runs the provisioning loop.
``Operator`` runs on the card unless it is given ``device="cpu"``.
"""

from karpenter_tpu_torch.operator.credentials import (  # noqa: F401
    Credentials, CredentialStore, EnvCredentialProvider, StaticCredentialProvider,
)
from karpenter_tpu_torch.operator.options import Options  # noqa: F401
from karpenter_tpu_torch.operator.operator import Operator  # noqa: F401
