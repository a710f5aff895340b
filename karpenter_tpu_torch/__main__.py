"""Simulation entry point: run the full control plane on the fake cloud
(port of ``karpenter_tpu/__main__.py``).

    python -m karpenter_tpu_torch [--pods N] [--seconds S] [--backend B]
                                  [--device D]

The standalone-framework analogue of the reference's ``cmd/controller``
binary, driving a synthetic workload end-to-end: NodeClass validation ->
pending pods -> solve windows -> instance creation -> node joins ->
registration, with the full controller fleet live.

``--backend`` defaults to ``$KARPENTER_SOLVER_BACKEND`` or ``torch``;
``--device`` (default ``cuda``) is where the operator plans: the card,
or ``cpu`` for the plain PyTorch programs.  Without a card the default
raises.  Exit 0 only when every pod is nominated, bound or not: the
reference counts only the pods still pending, so it prints 0 nominated
and exits 1 once the kubelet has bound every pod.
"""

from __future__ import annotations

import argparse
import os
import time


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(prog="karpenter_tpu_torch")
    parser.add_argument("--pods", type=int, default=200)
    parser.add_argument("--seconds", type=float, default=15.0)
    parser.add_argument("--backend", default=os.environ.get(
        "KARPENTER_SOLVER_BACKEND", "torch"))
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    os.environ.setdefault("TPU_CLOUD_REGION", "us-south")
    os.environ.setdefault("TPU_CLOUD_API_KEY", "simulated")
    os.environ.setdefault("KARPENTER_SOLVER_BACKEND", args.backend)
    os.environ.setdefault("KARPENTER_WINDOW_IDLE_SECONDS", "0.2")
    os.environ.setdefault("KARPENTER_WINDOW_MAX_SECONDS", "2.0")
    os.environ.setdefault("CIRCUIT_BREAKER_RATE_LIMIT_PER_MINUTE", "1000")
    os.environ.setdefault("CIRCUIT_BREAKER_MAX_CONCURRENT_INSTANCES", "1000")

    from karpenter_tpu_torch.apis.nodeclass import (
        InstanceRequirements, NodeClass, NodeClassSpec, PlacementStrategy,
    )
    from karpenter_tpu_torch.apis.pod import ResourceRequests, make_pods
    from karpenter_tpu_torch.core.kubelet import FakeKubelet
    from karpenter_tpu_torch.operator import Operator, Options
    from karpenter_tpu_torch.utils import metrics

    op = Operator(Options.from_env(), device=args.device)
    nc = NodeClass(name="default", spec=NodeClassSpec(
        region=op.options.region, image="img-1", vpc="vpc-1",
        instance_requirements=InstanceRequirements(min_cpu=2),
        placement_strategy=PlacementStrategy()))
    op.cluster.add_nodeclass(nc)
    op.start()
    kubelet = FakeKubelet(op.cluster, op.cloud)
    try:
        for pod in make_pods(args.pods, name_prefix="sim",
                             requests=ResourceRequests(500, 1024, 0, 1)):
            op.cluster.add_pod(pod)
        deadline = time.time() + args.seconds
        while time.time() < deadline:
            kubelet.join_pending(ready=True)   # the async continuation
            pending = [p for p in op.cluster.pending_pods()
                       if not p.nominated_node]
            if not pending and all(
                    c.initialized for c in op.cluster.nodeclaims()):
                break
            time.sleep(0.25)
        claims = op.cluster.nodeclaims()
        # every pod, bound ones too: a bound pod keeps its nomination and
        # leaves pending_pods(), so counting only the pending ones (as
        # the reference does) reads 0 once the kubelet has bound them all
        nominated = sum(1 for p in op.cluster.list("pods")
                        if p.nominated_node)
        print(f"pods nominated: {nominated}/{args.pods}")
        print(f"nodes created:  {len(claims)} "
              f"({sum(1 for c in claims if c.initialized)} initialized)")
        cost = sum(c.hourly_price for c in claims)
        print(f"fleet cost:     ${cost:.2f}/h")
        print(f"instances:      {op.cloud.instance_count()}")
        windows = metrics.SOLVE_DURATION.count(op.options.solver.backend)
        print(f"solve windows:  {windows}")
        return 0 if nominated == args.pods else 1
    finally:
        op.stop()


if __name__ == "__main__":
    raise SystemExit(main())
