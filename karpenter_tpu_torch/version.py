"""Build version plumbing (reference: pkg/version/version.go — "injected
at build time via ldflags"; the Python analogue is an env override set
by the image build, surfaced in the operator boot log and /healthz).

(Copy of ``karpenter_tpu/version.py``.)
"""

from __future__ import annotations

import os

# Overridden by the release pipeline (KARPENTER_TPU_VERSION baked into
# the image); "dev" for source checkouts, matching the reference default.
VERSION: str = os.environ.get("KARPENTER_TPU_VERSION", "dev")


def get_version() -> str:
    return VERSION
