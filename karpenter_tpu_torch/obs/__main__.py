"""obs CLI: export traces as Chrome trace-event JSON or JSONL (port of
``karpenter_tpu/obs/__main__.py``).

    python -m karpenter_tpu_torch.obs export --format chrome       # demo run
    python -m karpenter_tpu_torch.obs export --input spans.jsonl -o out.json
    python -m karpenter_tpu_torch.obs export --format jsonl [--device cpu]

Without ``--input`` the command runs a small self-contained provisioning
cycle (fake cloud, greedy solver) and exports ITS trace — a one-command
way to produce a Perfetto-loadable file showing the pod-event -> batch
-> solve -> actuation -> RPC chain.  With ``--input`` it converts a span
dump produced by the chaos harness or ``/debug/traces`` tooling.

The demo's solver is the host greedy oracle, as in the reference, but
its ``Provisioner`` resolves ``--device`` (default ``cuda``) as every
entry point of the port does: without a card the default raises, and
``--device cpu`` runs the demo on the host.

Exit codes: 0 ok, 2 usage error.
"""

from __future__ import annotations

import argparse
import json
import sys


def _run_demo(device="cuda"):
    """One provisioning cycle on the fakes, traced into a fresh recorder."""
    from karpenter_tpu_torch import obs
    from karpenter_tpu_torch.apis.nodeclass import (
        InstanceRequirements, NodeClass, NodeClassSpec, PlacementStrategy,
    )
    from karpenter_tpu_torch.apis.pod import ResourceRequests, make_pods, pod_key
    from karpenter_tpu_torch.catalog.instancetype import InstanceTypeProvider
    from karpenter_tpu_torch.catalog.pricing import PricingProvider
    from karpenter_tpu_torch.cloud.fake import FakeCloud
    from karpenter_tpu_torch.core.actuator import Actuator
    from karpenter_tpu_torch.core.cluster import ClusterState
    from karpenter_tpu_torch.core.provisioner import Provisioner, ProvisionerOptions
    from karpenter_tpu_torch.solver.types import SolverOptions

    recorder = obs.FlightRecorder()
    with obs.use(obs.Tracer(recorder)):
        cloud = FakeCloud(region="us-south")
        pricing = PricingProvider(cloud)
        try:
            cluster = ClusterState()
            nc = NodeClass(name="default", spec=NodeClassSpec(
                region="us-south", image="img-1", vpc="vpc-1",
                instance_requirements=InstanceRequirements(min_cpu=2),
                placement_strategy=PlacementStrategy()))
            nc.status.resolved_image_id = "img-1"
            nc.status.set_condition("Ready", "True", "ObsDemo")
            cluster.add_nodeclass(nc)
            provisioner = Provisioner(
                cluster, InstanceTypeProvider(cloud, pricing),
                Actuator(cloud, cluster),
                ProvisionerOptions(solver=SolverOptions(backend="greedy")),
                device=device)
            for pod in make_pods(12, name_prefix="demo",
                                 requests=ResourceRequests(500, 1024, 0, 1)):
                cluster.add_pod(pod)
                obs.instant("pod.event", pod=pod_key(pod))
            provisioner.provision_once()
        finally:
            pricing.close()
    return recorder


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="karpenter_tpu_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)
    exp = sub.add_parser("export", help="export traces")
    exp.add_argument("--format", choices=("chrome", "jsonl"),
                     default="chrome")
    exp.add_argument("--input", help="span-dump JSONL (chaos artifact); "
                                     "default: run a traced demo cycle")
    exp.add_argument("-o", "--output", default="-",
                     help="output path (default stdout)")
    exp.add_argument("--device", default="cuda",
                     help="the demo provisioner's device (default cuda; "
                          "cpu runs it on the host)")
    args = ap.parse_args(argv)

    from karpenter_tpu_torch.obs import export as ex

    if args.input:
        span_dicts = ex.load_jsonl(args.input)
    else:
        span_dicts = ex.recorder_to_dicts(_run_demo(args.device))

    if args.format == "chrome":
        text = json.dumps(ex.dicts_to_chrome(span_dicts), indent=1,
                          default=str)
    else:
        text = "\n".join(json.dumps(d, sort_keys=True, default=str)
                         for d in span_dicts)
    if args.output == "-":
        print(text)
    else:
        from pathlib import Path

        p = Path(args.output)
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(text + "\n")
        print(f"wrote {len(span_dicts)} spans -> {p}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
