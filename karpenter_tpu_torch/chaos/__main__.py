"""Chaos harness CLI (`make chaos`, `make soak`).

    python -m karpenter_tpu_torch.chaos                   # full matrix
    python -m karpenter_tpu_torch.chaos --seeds 4 --rounds 10
    python -m karpenter_tpu_torch.chaos --profile spot-storm --seed 3
                                                          # replay
    python -m karpenter_tpu_torch.chaos --soak [--short]  # production day
    python -m karpenter_tpu_torch.chaos --crash           # crashpoint matrix
    python -m karpenter_tpu_torch.chaos --crash \
        --crashpoint actuate.mid_create --seed 2          # crash replay
    python -m karpenter_tpu_torch.chaos --list-profiles

``--device`` (default ``cuda``) places the harness's device planes: the
card, or ``cpu`` for the plain PyTorch programs.  Without a card the
default raises.  On the card a device fault that a profile injects
raises out of the scenario, which is reported as failed with its replay
command.

Exit codes: 0 all invariants held and every trace was reproducible (for
--soak: every SLO met, gate proven, no invariant violation), 1 any
invariant violation / determinism failure / burned SLO / device fault,
2 usage error.
"""

from __future__ import annotations

import argparse
import sys

from karpenter_tpu_torch.chaos.profile import FIXTURE_PROFILES, PROFILES
from karpenter_tpu_torch.chaos.runner import (
    REPLAY_FMT, run_matrix, run_scenario,
)
from karpenter_tpu_torch.faulttol import DeviceFaultError


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="karpenter_tpu_torch.chaos")
    ap.add_argument("--profile", action="append", default=None,
                    help="profile name (repeatable; default: full matrix)")
    ap.add_argument("--seed", type=int, default=None,
                    help="single seed (replay mode)")
    ap.add_argument("--seeds", type=int, default=4,
                    help="run seeds 1..N (default 4)")
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds per scenario (default: 10, or 8 with "
                         "--crash)")
    ap.add_argument("--no-verify-determinism", action="store_true",
                    help="skip the double-run trace-digest comparison")
    ap.add_argument("--trace-dir", default=".chaos-traces",
                    help="where failing scenarios dump their event trace")
    ap.add_argument("--list-profiles", action="store_true")
    ap.add_argument("--soak", action="store_true",
                    help="run the composed production-day soak with SLO "
                         "gates (docs/design/observability.md)")
    ap.add_argument("--short", action="store_true",
                    help="with --soak: the CI-sized short day")
    ap.add_argument("--sharded", type=int, default=0, metavar="S",
                    help="with --soak: arm the sharded continuous-solve "
                         "plane with S shards across every segment (the "
                         "`make soak-sharded-short` gate: same SLOs, "
                         "2-shard virtual mesh on CPU)")
    ap.add_argument("--serving", action="store_true",
                    help="with --soak: stream every pump beat's window "
                         "through the persistent device-resident serving "
                         "loop across every segment (the `make "
                         "soak-serving-short` gate: same SLOs, ring "
                         "kicks + depth-1 deferred fetch on CPU)")
    ap.add_argument("--report-dir", default=".soak-report",
                    help="with --soak: burn report + span bundle output")
    ap.add_argument("--crash", action="store_true",
                    help="run the crashpoint x seed matrix (operator "
                         "kill/restart chaos; docs/design/recovery.md)")
    ap.add_argument("--crashpoint", action="append", default=None,
                    help="with --crash: crashpoint name (repeatable; "
                         "default: full catalog)")
    ap.add_argument("--device", default="cuda",
                    help="the device planes' device: cuda (default; "
                         "raises without a card) or cpu")
    args = ap.parse_args(argv)

    # an explicit --rounds must never be silently coerced: the crash
    # path's different default is resolved only when the flag is absent
    # (a replay with --rounds N MUST run exactly N, or the digest the
    # user is chasing never reproduces)
    if args.crash:
        from karpenter_tpu_torch.chaos.crash import (
            run_crash_matrix, run_crash_scenario,
        )

        rounds = args.rounds if args.rounds is not None else 8
        if args.crashpoint and args.seed is not None \
                and len(args.crashpoint) == 1:
            res = run_crash_scenario(args.crashpoint[0], args.seed,
                                     rounds=rounds, device=args.device)
            if res.violations:
                print(res.render_failure())
                return 1
            print(f"ok   {res.crashpoint} seed={res.seed} "
                  f"crashes={res.crashes} events={len(res.trace)} "
                  f"digest={res.digest[:12]}")
            return 0
        seeds = (args.seed,) if args.seed is not None \
            else tuple(range(1, args.seeds + 1))
        _, failures = run_crash_matrix(
            args.crashpoint, seeds, rounds=rounds,
            verify_determinism=not args.no_verify_determinism,
            trace_dir=args.trace_dir, device=args.device)
        return 1 if failures else 0

    if args.soak:
        from karpenter_tpu_torch.chaos.soak import (
            PRODUCTION_DAY, SHORT_DAY, run_soak,
        )

        res = run_soak(SHORT_DAY if args.short else PRODUCTION_DAY,
                       seed=args.seed if args.seed is not None else 1,
                       report_dir=args.report_dir,
                       shard_count=args.sharded,
                       serving=args.serving, device=args.device)
        return 0 if res.ok else 1

    if args.list_profiles:
        for name, p in {**PROFILES, **FIXTURE_PROFILES}.items():
            tag = " [fixture]" if p.fixture else ""
            print(f"{name:<18}{tag} {p.description}")
        return 0

    rounds = args.rounds if args.rounds is not None else 10
    seeds = (args.seed,) if args.seed is not None \
        else tuple(range(1, args.seeds + 1))
    if args.profile and args.seed is not None and len(args.profile) == 1:
        # replay mode: one scenario, full report
        try:
            res = run_scenario(args.profile[0], args.seed, rounds=rounds,
                               device=args.device)
        except DeviceFaultError as e:
            print(f"CHAOS DEVICE FAULT scenario={args.profile[0]} "
                  f"seed={args.seed}: {e}")
            print("replay: " + REPLAY_FMT.format(
                profile=args.profile[0], seed=args.seed, rounds=rounds))
            return 1
        if res.violations:
            print(res.render_failure())
            return 1
        print(f"ok   {res.profile} seed={res.seed} "
              f"events={len(res.trace)} digest={res.digest[:12]}")
        return 0
    _, failures = run_matrix(
        args.profile, seeds, rounds=rounds,
        verify_determinism=not args.no_verify_determinism,
        trace_dir=args.trace_dir, device=args.device)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
