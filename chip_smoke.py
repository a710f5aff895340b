"""Chip smoke test of the PyTorch/CUDA port (``karpenter_tpu_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

It drives the port's main path — the default provisioning solve of the
headline window, 10k pending pods x 500 instance types (seed 42) —
through ``TorchSolver(device="cuda").solve``, then the batched paths:
the multi-cluster fleet (8 clusters x 10k pods, each with its own
catalog) through ``fleet_solve_packed``, the window stream through
``solve_stream`` and a zone-candidate window through ``solve``, then the
routes the default dispatch takes on its own, each through ``solve`` at
10k pods x 500 types: the flat regime (two heterogeneous windows), the
affinity plane and the stochastic plane; then the soft-preference window
(the FFD kernel with a rank row per group), the resident store's churn
stream, the serving loop's churn stream and the fleet with its resident
input, then the what-if plane (64 scenarios in one stacked plan), the
gang plane and the preemption plane at the shapes of bench.py's
``run_whatif``, ``run_gang`` and ``run_preempt``, then the sharded
service (the headline window, ``run_sharded``'s churn and hash-skewed
streams, its serving loop) and the repack plane at ``run_repack``'s
fleet; and checks that each
path ran through its hand-written CUDA kernels (the order-fixed cost sum
on every path that writes a cost word, the flat program's order-fixed
segment sum, the pref right-size's order-fixed presence sum; the
affinity and stochastic scans and the gang, preemption and repack
grids are PyTorch ops).  Phases, in order; any failure exits non-zero and prints
no result line:

1. the card's name and power limit, as nvidia-smi reports them;
2. build every kernel from ``karpenter_tpu_torch/csrc`` (one nvcc per
   source, all at once) into ``karpenter_tpu_torch/_build/``;
3. hold each kernel against its plain PyTorch version on the card, with
   exact int32 equality: ``ffd_scan`` over seeds at the headline shape,
   the largest scan shape and edge cases; ``ffd_scan_fleet`` with eight
   distinct catalogs at the headline shape, with one catalog expanded
   over 16 problems (stride 0, also against the problems launched one
   by one) and with distinct catalogs at the largest shape; then the
   shapes the kernel's design has to get right: offering counts that
   are not multiples of 4, 16 or 128 (int32 and uint8 compat, one
   problem and a fleet of three catalogs), N = 8192, G = 0 and G below
   the row ring's depth, and a rank tie that only division by a small
   rem makes; then a rank row per group (the soft-preference scan) at one
   shape per instantiation that form takes (the headline shape, N = 4096
   at O = 4096, N = 8192 at O = 4096 and 5000), one problem and a fleet
   of three, windows shorter than the ring or not a whole number of its
   slots, and on the pref window's own tensors.  Over all these checks,
   every instantiation of
   the chain kernel must have run, and the uncapped branch, the capped
   branch and the summed takes (groups that request nothing) of its
   step, counted on the host from the plain version's outputs; with a
   rank row per group, every instantiation and both branches; then
   ``cost_sum`` bit for bit against its plain version over C in {1, 8,
   64}, every N in NODE_BUCKETS and ragged lengths, with 30-70% of the
   nodes open and totals small and near 2^24, and ``cost_word`` (the
   gather, mask and sum in one launch) over the same shapes with a
   price row per problem, one shared row and one row, and at every N
   from 1 to 64 (rows of 30-32 nodes take the 8-lane order) and from 929
   to 1024 (30-32 window sums at the last level) with C in {1, 4, 8};
4. the paths, each with every launch count set to 0 just before and
   read just after, each needing its kernels launched and no pod left
   unplaced: (a) the main path, whose plan must validate clean and
   whose packed result must equal the plain CPU solve word for word
   (the float cost word included); (b) the fleet, whose
   [C, Lo] result must equal the plain CPU fleet program word for word;
   (c) the stream of 64 windows at depth 32, batch 16, each plan equal
   to its single-window plan and clean; (d) the zone-candidate window,
   whose plan must equal the CPU solver's, with its candidate rounds
   batched; (e) the two flat windows, (f) the affinity window and (g)
   the stochastic window, each plan equal to the CPU solver's and clean
   (validate_plan, validate_affinity_plan, the chance rule), its placed
   count the CPU's, ``last_stats["path"]`` naming the route and the
   card, and its raw result equal to the plain CPU program word for
   word; ``segment_sum`` held bit for bit against its plain version on
   every call of the flat program (calls per window printed), and on the
   largest call its wrapper beside ``index_add_`` (medians of rounds in
   turns), its device time alone and its device kernels per call from
   ``torch.profiler`` (at most 2, or the run fails); for each route the
   cold wall, the p50
   of 20 warm windows, the device program's CUDA-event time, kernels per
   window from ``torch.profiler`` and, for flat, host syncs per window;
   (h) the pref window (the headline pods with soft preferences, G below
   the flat gate, a node holding three or more groups with fractional
   misses): ``ffd_scan_pref`` and ``presence_sum`` launched, the plan
   equal to the CPU solver's and clean, the raw result equal to the
   plain CPU program word for word, ``presence_sum`` bit for bit against
   its plain version (the window's tensors and seeded ones: ragged O, G
   not a multiple of 32, a node holding every group, an all-closed node
   axis, one node, G at its maximum), the same timings plus the kernel
   beside its shared-rank form in turns (with the window's capped
   sweeps, the extra time per capped sweep and the chain instantiation)
   and the pref right-size beside the shared-rank one, and
   ``presence_sum`` beside its plain version and ``torch.matmul`` in
   turns, its device time alone, its device kernels per call (at most
   2, or the run fails) and its bound as the data needs it; (i) the
   resident stream
   (bench.py's ``run_resident`` churn at 10k x 500), resident on and off
   alternately, every plan equal, each resident solve launching one
   ``ffd_scan``, one ``cost_sum`` and nothing else (counts zeroed
   before it and read after it), its raw result equal to the classic
   dispatch's word for word,
   the device state equal to the mirror after every window, the modes
   rebuild, delta and hit all seen; (j)
   the serving stream (``run_serving``'s churn at 10k x 500, depth 2, a
   cold and a warm pass): every window on the ring, no backpressure,
   ``ring_state_violations`` empty, every plan and raw ring result equal
   to the classic one, and the port's 8-seed parity checks empty; (k)
   the fleet with ``resident_buf``: a rebuild, a hit on the same window
   and a delta with one cluster churned, each equal to the fleet without
   it; (l) the what-if plane at ``run_whatif``'s shape (10k pods x 500
   types, K = 64 from its menu of arrival waves, spot storm, zone
   blackout and quota clamp): one ``ffd_scan_fleet`` and one
   ``cost_sum`` launch for the stacked plan and nothing else, every
   scenario's words equal to ``solve_packed_torch`` of its perturbed
   buffer on the card (cost word included) and to the numpy oracle up to
   the cost word, ``validate_whatif`` clean, ``ffd_scan_fleet`` exact
   against its plain version at C = 64 and C = 128, ``cost_sum`` on the
   plan's own prices, and the stacked p50 beside 64 sequential single
   solves and ``plan_host``; (m) the gang plane at ``run_gang``'s shape
   (64 gangs x 16 members, 500 accelerator types, seed 17): the torch
   grid on the card equal to the numpy grid, ``validate_gang_plan``
   clean, no partial gang; (n) the preemption plane at ``run_preempt``'s
   shape (10k pending, 2000 claims, seed 31): the torch fit grid on the
   card equal to the numpy grid, ``validate_preemption_plan`` clean;
   (o) the headline window through ``make_solver(SolverOptions(
   sharded=2))`` (the sharded service: the shards are the fleet kernel's
   problem axis): one ``ffd_scan_fleet`` and one ``cost_sum`` launch per
   window over 21 windows, each shard's raw row equal to the plain CPU
   solve of its buffer word for word, the plan equal to the CPU sharded
   solver's and clean, its warm p50 beside ``TorchSolver``'s; then the
   window through ``ShardedSolveService(4)``; (p) ``run_sharded``'s churn
   at 10k pods x 500 types (4 seeds x 4 rounds): every window one launch
   of each, its rows equal to single solves of its shards' buffers on the
   card, the state and partition checks clean, the resident modes and
   delta words; the hash-skewed stream migrating, every decision equal to
   ``rebalance_oracle``; aggregate and single-shard pods/s; (q) seed 0's
   churn through ``ShardedServingLoop(capacity=2)``: plans equal to
   ``solve_window``'s, the overlap fraction, the port's sharded parity
   checks, the wall of every submit, result and window with the garbage
   collections of each pass, and a ``cProfile`` of warm windows; (r) ``run_repack``'s fleet (2000 claims x 500 types): the
   repack grid as torch ops on the card reading the resident occupancy
   rows, its plan equal to the numpy grid's and
   ``validate_repack_plan`` clean, both warm p50s; and the torus-defrag
   case reopening a slice on both routes; (s) the fault and profiling
   planes (every dispatch runs in ``faulttol.device_guard`` and a sampled
   ``obs.prof`` bracket): 300 headline windows with the guard's and the
   profiler's overhead fractions (each under 1%) and the sampled scan
   split beside the CUDA-event device time, then the headline window's
   wall with the planes on and taken out, in turns (the planes may cost
   no more than the run's own spread plus 1%); a real allocator OOM in
   ``device_guard("scan-batch")`` typed ``DeviceResourceExhausted``, the
   next window equal to the plain CPU solve word for word; the FFD
   library's C entry with N above its maximum returning
   cudaErrorInvalidValue, typed ``DeviceFaultError`` in a guard; a
   quarantine and a probation walk with the torch probe on the card; an
   injected oom halving a 16-window batch, plans equal; the first
   window of each of three new signatures beside its warm p50, in fresh
   processes of this script, two without ``warmup_solver`` and two with
   it (printed, not gated); kernels per window of the headline and pref windows
   equal with and without the guard and the profiler; (t) the host
   greedy oracles on the card's plans: the native per-pod twin built
   from ``csrc/ffd_host.cpp``; the headline and flat plans clean,
   placing at least the greedy oracle's pods at no more than its cost
   (the flat oracle uncapped, ``max_nodes=32768``); the greedy's p50 on
   its python and native paths and ``solve_per_pod_native``'s (the
   per-pod loop that stands in for karpenter-core's ``Scheduler.Solve``)
   beside the card's warm p50, with bench.py's verdict name (printed,
   not gated); the stochastic and affinity routes' packed results equal
   to ``solve_stochastic_host`` / ``solve_affinity_host`` on node_off,
   assign, unplaced and words, their cost words equal to the oracles'
   plans priced in the reference's order; ``check_plan_reasons`` empty
   on the headline, pref, flat, stochastic and affinity plans; the gang,
   preemption and repack plans on the card equal to the greedy
   planners' at bench.py's shapes; the recorder's telemetry
   ring holding one entry per solved headline window and
   ``solve_quality_windows_total{plane="scan"}`` the same count, with
   the recording's host time per window; (u) the degraded modes, after
   the fault phase; no window leaves the card for a host oracle there:
   (u1) ``make_solver()`` on the headline gives ``TorchSolver``'s plan,
   a scripted error on the next dispatch raises ``DeviceFaultError`` out
   of it with no breadcrumb and the resident store invalidated once,
   and the next window launches ``ffd_scan`` again; (u2) the stochastic
   and affinity windows of (g) and (f) with their route program raising:
   one breadcrumb, the re-run launches ``ffd_scan``, the plan equals the
   CPU twin's stripped plan, the same window again takes the scan with
   none; a scripted device fault on the route strips nothing and raises
   out of ``ResilientSolver``; (u3) ``ServingLoop`` faults at the kick
   and the fetch of (j)'s windows fail over to the classic plan on the
   card (``host_failovers`` 2), the pref window through
   ``make_solver(sharded=2)`` takes the host route and equals the CPU
   host route's plan, sharded kick and fetch faults raise out of
   ``ResilientShardedService`` and the sharded serving loop
   (``degraded_windows`` and ``host_failovers`` 0) and the next windows
   run on the card; (u4) the gang, preemption, repack and what-if
   wrappers pass their planners' clean plans on the card ((t)'s greedy
   plans) and raise a scripted fault; (u5) the headline p50 through
   ``make_solver()`` beside ``TorchSolver`` in 10 rounds of turns and
   ``plan_defects`` alone (printed, not gated; no timed window may
   degrade); (v) the catalog intake, after (t) and before the fault
   phase: (v1) the 500-type catalog listed from the port's
   ``FakeCloud``, priced through ``PricingProvider``'s batcher and built
   by ``InstanceTypeProvider`` under a default ``NodeClass``, equal to
   ``workload.build_catalog(500)`` on every field, the headline pods
   solved on it through ``make_solver()`` to phase (a)'s plan; (v2) the
   10,000 pods through ``SolveWindow`` at the reference's max_pods,
   idle and max 60 s (no stall of the host fires it early): one
   window carrying them all, every future the direct plan's node, 10,000
   ``window_enqueue`` ledger stamps linked to one trace, the wall from
   the first add to the last future and the solve's share; then the
   same pods at ``WindowOptions()`` (idle 1 s, max 10 s): every pod
   delivered once over however many windows the timers fire; (v3) the
   offerings (v1)'s plan opened in us-south-1 blacked out on an
   injected clock and refreshed into the catalog: one catalog upload,
   none on a repeat, no blacked-out offering opened, ``validate_plan``
   clean, the plan the CPU solver's and the packed result the plain CPU
   program's word for word; the blackout expired: one upload, (v1)'s
   plan; (v4) (v1)'s spot pairs at 3/4 interrupted, ``price_catalog``
   bumping the risk generation once: one upload, none on a repeat, the
   words the CPU program's, the stochastic window on the risk-priced
   catalog on ``stochastic-cuda`` and equal to the CPU plan, the nodes
   moved off the penalised pairs printed; (v5) the default soak SLOs
   over the phase's ledger and recorder printed, gated only that both
   telemetry objectives were measured from the card's windows and that
   no resolution was degraded; (w) the provisioning loop, after (v):
   (w1) the rig (the port's ``FakeCloud`` with the headline's 500
   profiles, ``PricingProvider``, ``UnavailableOfferings``,
   ``InstanceTypeProvider``, a ``ClusterState`` with a ready NodeClass
   and the default NodePool, an ``Actuator``, ``Provisioner(device=
   "cuda")``); (w2) the 10,000 headline pods added through
   ``ClusterState.add_pod`` with the provisioner started: every pod
   nominated, every future of the window a claim name, the plan and the
   claims (by pod set) those of the CPU port's ``provision_once`` on a
   fresh rig, the wall from the first add to the last nomination split
   into intake, catalog resolve, solve, actuation and nomination; (w3) a
   capacity error injected on one offering of (w2)'s plan after a claim
   of it is deleted: the offering blacked out, the retry ticker
   re-windowing the pods elsewhere, one availability upload, the
   re-keyed plan the CPU solver's, the time to recovery; (w4) a pool
   whose cpu limit trims the plan (NodePoolLimitReached on the dropped
   pods) and a soft-tainted pool reached only in the second pass, each
   equal to the CPU port's; (w5) ``FakeKubelet``, ``CloudProvider``
   get / list / delete, drift on a new image, and a provisioner killed
   at ``provision.pre_nominate`` with an ``IntentJournal``, recovered by
   a new one and ``Reconciler.recover()`` with every pod nominated once
   and nothing leaked; (w6), after (s): a scripted device fault in the
   loop's solve raises ``DeviceFaultError`` out of ``provision_once``
   and into every future of a window, with no claim and no breadcrumb;
   (x) the controllers, after (w): (x1) a ``ControllerManager``
   (``AlwaysLeader``) carrying every ported controller in the reference
   operator's order over a rig like (w1)'s, driven by ``sync``; (x2) the
   10,000 headline pods provisioned through the started watch path in
   one window that fires at its count, joined and registered, half of them deleted, three ticks 31 s apart
   (empty and underutilized consolidation, the migration repack on the
   card's grid, the blue/green proposal solved on the card), once with
   the resident occupancy view off and once on; (x3) ``run_gang``'s 64
   gangs x 16 parked out of a window by ``provisioner.admission``, then
   admitted and the slice gangs placed on the card's grid; (x4) 2,000
   full claims and 10,000 pending pods, one preemption reconcile on the
   card's fit grid within the pool's budget; (x5) a spot preemption
   blacking its offering out, the next window re-keying the catalog
   with one upload and avoiding it; each step's claims, bindings,
   nominations, events, fake-cloud calls and logs equal to the same
   script's on a CPU rig of the port (names from counters); (x6), after
   (w6): one scripted device fault in each planning controller raises
   out of its planner and is counted once by the manager
   (``ERRORS{controller.<name>, reconcile}``), with no claim, eviction,
   migration or breadcrumb, and the next sync plans on the card;
   (y) the gRPC solver sidecar, after (x): whether ``grpc`` imports on
   this machine (printed; the phase fails without it);
   ``SolverServer(device="cuda")`` on 127.0.0.1 with ``RemoteSolver``
   over the socket; the headline,
   the flat seed-7 window, the pref window and the zone-candidate window
   (``SolveBatch``), each plan equal to ``TorchSolver(device="cuda")``'s,
   each reply's arrays equal to the plain CPU handlers' on the same
   request bytes, ``ffd_scan``, ``ffd_scan_pref``, ``ffd_scan_fleet``,
   ``segment_sum``, ``presence_sum`` and ``cost_sum`` launched;
   ``compute_handle``'s words equal to the headline dispatch's, its
   CUDA-event time per solve at k = 1 and 10 beside the remote and
   local p50 walls (not gated); (y6), after (x6): a scripted device
   fault in the sidecar's solve raises to ``make_solver(backend=
   "remote")``'s caller, counted once, no breadcrumb; (z) the chaos
   harness with its device planes on the card, after (y): ``calm``,
   ``shard-skew`` and ``affinity`` at seed 1 and ``serving-storm`` with
   its device faults taken out (a changed profile), each with zero
   violations and the digest of the same call on the CPU, the planes'
   devices printed, ``ffd_scan_fleet`` (sharded) and ``ffd_scan``
   (serving) launched; (z6), after (y6): ``device-fault`` at seed 1
   raises ``DeviceFaultError`` out of ``run_scenario``, counted once, no
   breadcrumb, no window on the host route;
   (l2) the what-if planning service, after (z): ``PlanningService`` over
   the headline's 10,000 pending pods with a ledger seeded with arrivals
   of every signature group over 24 virtual hours, ``evaluate(record=
   True, hour=9)``: the standing menu (baseline, forecast peak, spot
   storm, zone blackout, pool shrink) in one stacked plan that launches
   exactly one ``ffd_scan_fleet`` and one ``cost_sum``, the fresh single
   solves of ``validate=True`` one ``ffd_scan`` each, the payload (clock
   fields aside) and ``digest()`` equal to the CPU port's; three
   ``WhatIfController`` ticks through a ``ControllerManager`` at the
   pinned hour, the registry growing as on the CPU; (w7) the headline
   pods provisioned through ``ProviderFactory`` (``IKS_CLUSTER_ID`` in
   the env it is given) as ``FakeIKS`` pool workers, half the claims (the
   smallest pools' first) deleted through
   ``NodeClaimTerminationController(factory=...)`` and one
   ``PoolCleanupController`` tick, the live claims registered in one
   ``FakeLoadBalancers`` pool by ``LoadBalancerController``, a quarter of
   them dropped unseen and one ``LBMembershipSweeper`` tick: plan, pools,
   workers, claims and members equal to a CPU rig's; (w8) the headline
   pods provisioned over HTTP: ``StubCloudServer`` on 127.0.0.1 over a
   500-profile ``FakeCloud``, ``VPCCloudClient`` -> ``PricingProvider``
   -> ``InstanceTypeProvider`` -> ``CatalogArrays`` (equal to the direct
   catalog on every field), ``provision_once`` on the card with an
   ``Actuator`` over the same client: the plan (w2)'s, the instances on
   the stub's cloud a CPU rig's over its own stub, the intake, solve and
   actuation walls printed; (l6), after (z6): a scripted fault at the
   ``whatif`` guard site raises ``DeviceFaultError`` out of ``evaluate``,
   a ``WhatIfController`` tick counts ``ERRORS{whatif,
   DeviceFaultError}`` once and records nothing, no breadcrumb and no
   host plan, and the next clean tick records.
   (u0) every phase but (s), (u), (w6), (x6), (y6), (z6) and (l6) runs
   under a gate that
   fails the run if it moves a degradation breadcrumb
   (``solver/degraded.breadcrumbs()``), an
   ``ERRORS{controller.*, reconcile}`` sample or an
   ``ERRORS{gang|preempt|repack, invalid_plan}`` sample;
   ``sharded_solves_total{host}`` is printed, not gated;
5. timings (taken after path (d) and before paths (e)-(g) run): p50
   wall of 20 warm windows, the device phases of one
   window, launches and device busy share of warm windows from a
   ``torch.profiler`` trace, each kernel's own time beside its plain
   version and its bound, with the time per group step, and the scan
   at the largest shape (G=2048, O=4096, N=4096); the fleet's
   single-shot and pipelined walls;
   the stream's amortized per-window wall at batch 1 and 16 beside the
   single-window p50, and its kernels per batch and device busy share
   (none of these gates the run).

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.  With ``--json-out PATH`` everything
measured also lands in the JSON file PATH.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import cProfile
import dataclasses
import gc
import importlib
import json
import os
import pstats
import random
import re
import secrets
import subprocess
import sys
import tempfile
import time
import uuid
import warnings
from collections import deque
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from karpenter_tpu_torch import (
    SolveRequest, SolverOptions, TorchSolver, validate_plan,
)
from karpenter_tpu_torch import cuda_build, workload
from karpenter_tpu_torch.apis import pod as pod_api
from karpenter_tpu_torch.apis.requirements import LABEL_ZONE
from karpenter_tpu_torch.parallel import (
    FleetProblem, fleet_device_catalog, fleet_pack_inputs,
    fleet_solve_packed,
)
from karpenter_tpu_torch.affinity.kernel import solve_packed_affinity
from karpenter_tpu_torch.affinity.validate import validate_affinity_plan
from karpenter_tpu_torch.apis.nodeclaim import NodePool
from karpenter_tpu_torch.solver import (
    cost_sum, ffd_kernel, presence_sum, segment_sum,
)
from karpenter_tpu_torch.solver import flat as flat_mod
from karpenter_tpu_torch.solver import packed as tp
from karpenter_tpu_torch.resident import delta as resident_delta
from karpenter_tpu_torch.resident.store import ResidentBuffer
from karpenter_tpu_torch.solver.torch_backend import (
    _pad1, _pad2, unpack_result,
)
from karpenter_tpu_torch.solver.types import (
    FIT_BIG, GROUP_BUCKETS, NODE_BUCKETS, OFFERING_BUCKETS, bucket,
)
from karpenter_tpu_torch.stochastic.kernel import solve_packed_stochastic
from karpenter_tpu_torch import whatif
from karpenter_tpu_torch.apis.nodeclaim import NodeClaim
from karpenter_tpu_torch.apis.podgroup import PodGroup
from karpenter_tpu_torch.core.cluster import ClusterState
from karpenter_tpu_torch.gang import GangOptions, GangPlanner, encode_gangs
from karpenter_tpu_torch.preempt import (
    PlannerOptions, PreemptionPlanner, encode_victims, group_node_compat,
)
from karpenter_tpu_torch.solver.validate import (
    validate_gang_plan, validate_preemption_plan,
)
from karpenter_tpu_torch.whatif import kernels as whatif_kernels
from karpenter_tpu_torch.whatif import oracle as whatif_oracle
from karpenter_tpu_torch.whatif import scenario as whatif_scenario
from karpenter_tpu_torch import native, obs
from karpenter_tpu_torch.affinity.greedy import solve_affinity_host
from karpenter_tpu_torch.explain.validate import check_plan_reasons
from karpenter_tpu_torch.gang import GreedyGangPlanner
from karpenter_tpu_torch.obs import telemetry_words
from karpenter_tpu_torch.preempt import GreedyPreemptionPlanner
from karpenter_tpu_torch.repack import (
    GreedyRepacker, RepackOptions, RepackPlanner, encode_repack,
)
from karpenter_tpu_torch.solver.greedy import (
    GreedySolver, expand_per_pod, solve_per_pod_native,
)
from karpenter_tpu_torch.solver.degraded import breadcrumbs, plan_defects
from karpenter_tpu_torch.solver.result_layout import unpack_reason_words
from karpenter_tpu_torch.stochastic.greedy import solve_stochastic_host
from karpenter_tpu_torch.utils import metrics
from karpenter_tpu_torch import make_solver
from karpenter_tpu_torch.apis.nodeclass import nodeclass_from_dict
from karpenter_tpu_torch.carry import CATALOG_FIELDS
from karpenter_tpu_torch.catalog import (
    CatalogArrays, InstanceTypeProvider, PricingProvider,
    UnavailableOfferings,
)
from karpenter_tpu_torch.cloud.fake import FakeCloud, generate_profiles
from karpenter_tpu_torch.core.window import SolveWindow, WindowOptions
from karpenter_tpu_torch.obs.devtel import get_devtel
from karpenter_tpu_torch.obs.ledger import PlacementLedger
from karpenter_tpu_torch.obs.slo import (
    DEFAULT_SOAK_SLOS, evaluate_slos, ledger_measurements,
    telemetry_measurements,
)
from karpenter_tpu_torch.stochastic.risk import SpotRiskModel
from karpenter_tpu_torch.apis.nodeclaim import provider_id
from karpenter_tpu_torch.cloud.errors import CloudError, NodeClaimNotFoundError
from karpenter_tpu_torch.core import (
    Actuator, CircuitBreakerConfig, CircuitBreakerManager, Provisioner,
    ProvisionerOptions,
)
from karpenter_tpu_torch.core.cloudprovider import CloudProvider
from karpenter_tpu_torch.controllers import ControllerManager
from karpenter_tpu_torch.controllers.bootstrap import BootstrapTokenController
from karpenter_tpu_torch.controllers.disruption import DisruptionController
from karpenter_tpu_torch.controllers.faults import (
    InstanceTypeRefreshController, InterruptionController,
    OrphanCleanupController, PricingRefreshController,
    SpotPreemptionController,
)
from karpenter_tpu_torch.controllers.gang import GangAdmissionController
from karpenter_tpu_torch.controllers.nodeclaim import (
    GarbageCollectionController, NodeClaimTerminationController,
    RegistrationController, StartupTaintController, TaggingController,
)
from karpenter_tpu_torch.controllers.nodeclass import (
    AutoplacementController, NodeClassHashController,
    NodeClassStatusController, NodeClassTerminationController,
)
from karpenter_tpu_torch.controllers.preemption import PreemptionController
from karpenter_tpu_torch.core.leaderelection import AlwaysLeader
from karpenter_tpu_torch.core.kubelet import FakeKubelet
from karpenter_tpu_torch.recovery import (
    CrashInjector, IntentJournal, Reconciler, SimulatedCrash, crashpoints,
)
from karpenter_tpu_torch.apis.nodeclass import (
    DynamicPoolConfig, HealthCheck, LoadBalancerIntegration,
    LoadBalancerTarget,
)
from karpenter_tpu_torch.cloud.fake_iks import FakeIKS
from karpenter_tpu_torch.cloud.loadbalancer import (
    FakeLoadBalancers, LoadBalancerProvider,
)
from karpenter_tpu_torch.cloud.stub import StubCloudServer
from karpenter_tpu_torch.cloud.vpc import VPCCloudClient
from karpenter_tpu_torch.controllers.iks import PoolCleanupController
from karpenter_tpu_torch.controllers.loadbalancer import (
    LBMembershipSweeper, LoadBalancerController,
)
from karpenter_tpu_torch.core.factory import ProviderFactory
from karpenter_tpu_torch.whatif.service import WhatIfController
from karpenter_tpu_torch.core.workerpool import (
    ANNOTATION_POOL_ID, WorkerPoolActuator,
)

# Published H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM
# rate, and the float32 rate outside the tensor cores, used for the
# scan's scalar integer/float operations.
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# scalar operations per (group, open node) and per (group, offering) in
# the FFD step: four floor divisions with their guards and mins, the
# compat read, the cap/rem clamps, the scan/take arithmetic or the
# rank / fit divide and compare
OPS_PER_NODE = 16
OPS_PER_OFFERING = 16

HEADLINE = dict(pods=10_000, types=500, seed=42)
# BASELINE config #5 as bench.py runs it: clusters x build_workload(pods,
# types, seed=seed0 + c)
FLEET = dict(clusters=8, pods=10_000, types=500, seed0=100)
# the window stream: `distinct` headline-size windows (seeds seed0...)
# cycled to `windows`, through solve_stream(depth, batch)
STREAM = dict(windows=64, distinct=16, depth=32, batch=16, seed0=42)
# the zone-candidate window: the headline pods plus `apps` co-scheduled
# apps of `pods` pods, each with a self PodAffinityTerm on the zone key
ZONE = dict(apps=3, pods=200)
# the routes the default dispatch takes on its own, at the headline size:
# the flat regime (bench.py::build_hetero_workload, plain and with 30%
# hard constraints and 15% soft preferences), the affinity plane
# (bench.py::_affinity_bench_pods, RandomState(19)) and the stochastic
# plane (bench.py::run_stochastic's menu, seed 13, overcommit 0.05)
FLAT_WINDOWS = (dict(seed=7),
                dict(seed=11, constrained_frac=0.3, pref_frac=0.15))
AFFINITY = dict(tag="aff", rng_seed=19)
STOCHASTIC = dict(seed=13, overcommit=0.05)
ROUTE_WARM = 20
# bench.py::run_resident / run_serving's churn streams at the headline
# size: 1-5 departures and 1-5 arrivals of 500m/1Gi pods per window
RESIDENT = dict(seed=77, windows=10, rng="bench-resident", tag="rw")
SERVING = dict(seed=78, windows=8, rng="bench-serving", tag="sw", depth=2)
# bench.py::run_whatif (10k pods x 500 types, K = 64 from the menu seeded
# 5), run_gang (64 gangs x 16 members, 500 accelerator types, seed 17)
# and run_preempt (10k pending, 2000 claims, 500 types, seed 31)
WHATIF = dict(pods=10_000, types=500, K=64, menu_seed=5, iters=6)
GANG = dict(gangs=64, members=16, types=500, seed=17, iters=10)
PREEMPT = dict(pending=10_000, claims=2000, types=500, seed=31, iters=5)
# the sharded service: the headline window through make_solver(sharded=2)
# (20 warm windows) and ShardedSolveService(4); bench.py::run_sharded's
# churn (pods of 100-900m / 256-2048 Mi, per round 1-15 departures and
# 8-24 arrivals) at 10k pods x 500 types, 4 rounds, 4 seeds, and its
# hash-skewed stream (24 hot sizes on shard 0, 2-5 pods each, seed 7, 4
# windows); the serving loop over seed 0's stream at capacity 2
SHARDED = dict(shards=2, warm=20, wide=4, pods=10_000, types=500, rounds=4,
               seeds=4, seed0=1000, hot=24, hot_seed=7, hot_windows=4,
               tput_windows=10, capacity=2)
# bench.py::run_repack's fleet (2000 bx2-16x64 claims at 0.8 $/h, 2 pods
# each of 100-1000m / 256-2048 Mi, seed 13, 500 types) and
# _run_repack_defrag's torus case (two gx3-64x512 nodes, gpu=2
# singletons 3 and 1, a parked 2x2x2 gang)
REPACK = dict(claims=2000, types=500, pods_per_claim=2, seed=13, iters=8)
KERNELS = {
    "ffd_scan": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/ffd_scan.cu",
        replaces="karpenter_tpu/solver/pallas_kernel.py:253"),
    "ffd_scan_fleet": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/ffd_scan.cu",
        replaces="karpenter_tpu/solver/pallas_kernel.py:304"),
    "segment_sum": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/segment_sum.cu",
        replaces="karpenter_tpu/solver/flat.py:231"),
    "ffd_scan_pref": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/ffd_scan.cu",
        replaces="karpenter_tpu/solver/jax_backend.py:958"),
    "presence_sum": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/presence_sum.cu",
        replaces="karpenter_tpu/solver/jax_backend.py:281"),
    "cost_sum": dict(
        route="cuda", source="karpenter_tpu_torch/csrc/cost_sum.cu",
        replaces="karpenter_tpu/solver/jax_backend.py:746"),
}
# the module, not the ``encode`` function the solver package re-exports
encode_mod = importlib.import_module("karpenter_tpu_torch.solver.encode")


def say(*parts) -> None:
    print(*parts, flush=True)


COUNTERS = (ffd_kernel.LAUNCHES, segment_sum.LAUNCHES, presence_sum.LAUNCHES,
            cost_sum.LAUNCHES)


def reset_launches() -> None:
    for counts in COUNTERS:
        for name in counts:
            counts[name] = 0


def launch_counts() -> dict:
    return {k: v for counts in COUNTERS for k, v in counts.items()}


def require_no_launches(launches: dict, path: str) -> None:
    if any(launches.values()):
        raise AssertionError(f"the {path} launched a kernel of another "
                             f"route: {launches}")


def require_launches(launches: dict, names, path: str) -> None:
    for name in names:
        if launches.get(name, 0) < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"{path}: {launches}")


def first_diff(label: str, got, want) -> None:
    """Raise naming the first differing cell of (node_off, assign,
    unplaced) when any differs."""
    for name, a, b in zip(("node_off", "assign", "unplaced"), got, want):
        bad = torch.nonzero(a != b)
        if bad.numel():
            raise AssertionError(f"{label}: {name} differs at "
                                 f"{bad[0].tolist()} ({bad.shape[0]} "
                                 f"cells)")


def max_abs_err(got, want) -> int:
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               if a.numel() else 0 for a, b in zip(got, want))


def words_equal(label: str, card: np.ndarray, plain: np.ndarray,
                cost_word: int) -> tuple[float, float]:
    """A packed result row against its plain CPU twin: every word equal,
    the float cost word (at ``cost_word``) included."""
    if card.shape != plain.shape:
        raise AssertionError(f"{label}: result lengths {card.shape} vs "
                             f"{plain.shape}")
    bad = np.nonzero(card != plain)[0]
    if bad.size:
        raise AssertionError(f"{label}: packed result differs from the CPU "
                             f"in {bad.size} words, first at {bad[0]} "
                             f"(cost word at {cost_word})")
    c_card = float(card[cost_word:cost_word + 1].view(np.float32)[0])
    c_cpu = float(plain[cost_word:cost_word + 1].view(np.float32)[0])
    return c_card, c_cpu


def plan_view(plan):
    return ([(n.offering_index, n.pod_names) for n in plan.nodes],
            plan.unplaced_pods)


def plans_equal(label: str, got, want) -> None:
    if plan_view(got) != plan_view(want):
        raise AssertionError(f"{label}: plan differs from the reference "
                             f"plan")
    if got.total_cost_per_hour != want.total_cost_per_hour:
        raise AssertionError(f"{label}: cost {got.total_cost_per_hour} vs "
                             f"{want.total_cost_per_hour}")


def clean_and_placed(label: str, plan, pods, catalog, nodepool=None,
                     placed: int | None = None) -> None:
    """validate_plan clean, and every pod placed (or, with ``placed``,
    exactly that many: a window whose reference leaves pods unplaced)."""
    errors = validate_plan(plan, pods, catalog, nodepool)
    if errors:
        raise AssertionError(f"{label}: validate_plan: {errors[:5]}")
    want = len(pods) if placed is None else placed
    if plan.placed_count != want or \
            plan.placed_count + len(plan.unplaced_pods) != len(pods):
        raise AssertionError(f"{label}: placed {plan.placed_count} of "
                             f"{len(pods)}, want {want}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warm: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls,
    bracketed by CUDA events after ``warm`` untimed calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def paired_ms(fns: dict, reps: int, rounds: int = 5) -> dict:
    """Median over ``rounds`` of each callable's :func:`cuda_ms` (``reps``
    back-to-back calls), the callables taken in turns, the order reversed
    every other round: a comparison that the host's drift within the
    process does not tilt."""
    for fn in fns.values():
        cuda_ms(fn, 2)
    runs = {name: [] for name in fns}
    for r in range(rounds):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for name in order:
            runs[name].append(cuda_ms(fns[name], reps, warm=0))
    return {name: float(np.median(v)) for name, v in runs.items()}


# -- phase 3: kernel against its plain version -------------------------------


def scan_inputs(seed: int, G: int, O: int, alloc_np=None, rank_np=None,
                case: str = ""):
    """FFD inputs at [G, O] from a seed: request rows from the headline
    size classes (zero-request dimensions in the "zero_req" case), group
    counts, caps (cap = 1 rows in the "cap1" case), label-like compat
    rows ANDed with the resource fit."""
    rng = np.random.RandomState(seed)
    if alloc_np is None:
        alloc_np = np.zeros((O, 4), np.int32)
        live = O - O // 8                       # padded tail stays zero
        alloc_np[:live, 0] = rng.choice([1800, 3800, 7800, 15800, 63800],
                                        live)
        alloc_np[:live, 1] = rng.choice([1548, 5644, 13836, 62988], live)
        alloc_np[:live, 3] = rng.choice([30, 60, 110], live)
        rank_np = np.zeros(O, np.float32)
        rank_np[:live] = (rng.rand(live) * 5 + 0.05).astype(np.float32)
        rank_np[1:live:9] = rank_np[0]          # price ties
    sizes = np.array([(250, 512), (500, 1024), (1000, 4096), (2000, 8192),
                      (4000, 16384), (8000, 32768)], np.int32)
    meta = np.zeros((G, 8), np.int32)
    meta[:, :2] = sizes[rng.randint(len(sizes), size=G)]
    meta[:, 3] = 1
    meta[:, 4] = rng.randint(0, 400 if G <= 64 else 30, G)
    meta[:, 5] = FIT_BIG
    if case == "zero_req":
        meta[rng.rand(G) < 0.5, 0] = 0
        meta[rng.rand(G) < 0.5, 1] = 0
    if case == "cap1":
        meta[rng.rand(G) < 0.5, 5] = 1
    labels = rng.rand(6, O) < np.array([1.0, 0.5, 0.33, 0.33, 0.33, 0.6]
                                       )[:, None]
    lbl = labels[rng.randint(6, size=G)]
    fit = (alloc_np[None, :, :] >= meta[:, None, :4]).all(axis=2)
    compat = (lbl & fit).astype(np.int32)
    if case == "unplaceable":
        compat[0] = 0
        meta[0, 4] = 37
    if case == "no_request":
        # groups that request nothing: every compatible open node fits
        # FIT_BIG of them, and the fill's int32 prefix sums wrap
        free = rng.rand(G) < 0.35
        free[0] = False
        meta[free, :4] = 0
    return meta, compat, alloc_np, rank_np


def new_tally(pref: bool = True) -> dict:
    """Over the kernel checks: the steps of each branch of the chain (from
    the plain version's outputs) and the checked scans of each
    instantiation of the chain kernel; ``pref`` holds the same for the
    scans with a rank row per group."""
    tally = {"branches": {"opens_nothing": 0, "uncapped": 0, "capped": 0,
                          "summed_takes": 0},
             "variants": {}}
    if pref:
        tally["pref"] = new_tally(pref=False)
    return tally


def add_to_tally(tally: dict, label: str, meta, compat, alloc, want,
                 N: int, group_rank: bool = False) -> None:
    for k, v in ffd_kernel.chain_branches(meta, compat, alloc,
                                          *want).items():
        tally["branches"][k] += v
    variant = ffd_kernel.scan_variant(compat.shape[-1], N, group_rank)
    tally["variants"].setdefault(variant, []).append(label)


def check_scan(dev, label: str, N: int, inputs,
               tally: dict) -> tuple[int, dict]:
    """Kernel vs plain version on the card; returns (max |diff|, info)."""
    meta, compat, alloc, rank = (
        x.contiguous() if isinstance(x, torch.Tensor)
        else torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        for x in inputs)
    got = ffd_kernel.ffd_scan(meta[None], compat[None], alloc, rank, N)
    want = ffd_kernel.ffd_scan_reference(meta[None], compat[None], alloc,
                                         rank, N)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    node_off, _, unplaced = (x.cpu().numpy()[0] for x in want)
    info = {"nodes_open": int((node_off >= 0).sum()),
            "unplaced": int(unplaced.sum())}
    if err:
        first_diff(f"ffd_scan {label}", got, want)
    add_to_tally(tally, label, meta[None], compat[None], alloc, want, N,
                 group_rank=rank.dim() == 2)
    return err, info


def phase_kernel_checks(dev, catalog, tally: dict) -> dict:
    O_h = 3072
    alloc_h = np.zeros((O_h, 4), np.int32)
    alloc_h[:catalog.num_offerings] = catalog.offering_alloc()
    rank_h = np.zeros(O_h, np.float32)
    rank_h[:catalog.num_offerings] = catalog.offering_rank_price()
    cases = []
    for seed in range(8):
        cases.append(("headline G=64 O=3072 N=512", 512,
                      scan_inputs(seed, 64, O_h, alloc_h, rank_h)))
    for seed in range(8):
        cases.append(("largest G=2048 O=4096 N=4096", 4096,
                      scan_inputs(100 + seed, 2048, 4096)))
    for case in ("unplaceable", "cap1", "zero_req", "no_request"):
        for seed in range(2):
            cases.append((f"edge {case} G=64 O=3072 N=512", 512,
                          scan_inputs(200 + seed, 64, O_h, alloc_h, rank_h,
                                      case=case)))
    for seed in range(2):
        # N exhausted: far more pods than 64 slots hold
        cases.append(("edge exhausted G=64 O=3072 N=64", 64,
                      scan_inputs(300 + seed, 64, O_h, alloc_h, rank_h)))
    worst = 0
    summary: dict[str, dict] = {}
    for label, N, inputs in cases:
        err, info = check_scan(dev, label, N, inputs, tally)
        worst = max(worst, err)
        s = summary.setdefault(label, {"runs": 0, "nodes_open": [],
                                       "unplaced": []})
        s["runs"] += 1
        s["nodes_open"].append(info["nodes_open"])
        s["unplaced"].append(info["unplaced"])
        if label.startswith("edge unplaceable") and info["unplaced"] < 37:
            raise AssertionError("unplaceable group was placed")
        if label.startswith("edge exhausted") and not (
                info["nodes_open"] == N and info["unplaced"] > 0):
            raise AssertionError(f"exhaustion case did not exhaust: {info}")
    for label, s in summary.items():
        say(f"kernel check ffd_scan {label}: {s['runs']} runs exact "
            f"(nodes open {s['nodes_open']}, pods unplaced "
            f"{s['unplaced']})")
    return {"max_abs_err": worst, "cases": summary}


def check_fleet_scan(dev, label: str, N: int, meta, compat, alloc, rank,
                     tally: dict) -> tuple[int, dict]:
    """``ffd_scan_fleet`` against its plain version on the card (numpy or
    tensor inputs, [C, ...]); returns (max |diff|, info)."""
    meta, compat, alloc, rank = (
        x if isinstance(x, torch.Tensor)
        else torch.from_numpy(np.ascontiguousarray(x)).to(dev)
        for x in (meta, compat, alloc, rank))
    got = ffd_kernel.ffd_scan_fleet(meta, compat, alloc, rank, N)
    want = ffd_kernel.ffd_scan_fleet_reference(meta, compat, alloc, rank, N)
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    if err:
        first_diff(f"ffd_scan_fleet {label}", got, want)
    add_to_tally(tally, label, meta, compat, alloc, want, N,
                 group_rank=rank.dim() == 3)
    node_off, _, unplaced = (x.cpu().numpy() for x in want)
    return err, {"nodes_open": (node_off >= 0).sum(axis=1).tolist(),
                 "unplaced": unplaced.sum(axis=1).tolist()}


def stacked_scan_inputs(seeds, G: int, O: int, alloc_np=None, rank_np=None):
    """[C, ...] FFD inputs, one seed per problem; each problem draws its
    own catalog unless one is given."""
    probs = [scan_inputs(s, G, O, alloc_np, rank_np) for s in seeds]
    return tuple(np.stack([p[i] for p in probs]) for i in range(4))


def phase_fleet_kernel_checks(dev, catalog, tally: dict) -> dict:
    O_h = 3072
    alloc_h = np.zeros((O_h, 4), np.int32)
    alloc_h[:catalog.num_offerings] = catalog.offering_alloc()
    rank_h = np.zeros(O_h, np.float32)
    rank_h[:catalog.num_offerings] = catalog.offering_rank_price()
    worst = 0
    summary = {}

    # C = 8, eight distinct catalogs at the headline shape: the headline
    # catalog with its offerings shuffled and its prices scaled per problem
    probs = []
    live = catalog.num_offerings
    for c in range(8):
        rng = np.random.RandomState(400 + c)
        perm = rng.permutation(live)
        a_c, r_c = alloc_h.copy(), rank_h.copy()
        a_c[:live], r_c[:live] = alloc_h[perm], rank_h[perm] * np.float32(
            0.8 + 0.4 * rng.rand())
        probs.append(scan_inputs(400 + c, 64, O_h, a_c, r_c))
    meta, compat, alloc, rank = (np.stack([p[i] for p in probs])
                                 for i in range(4))
    if len({a.tobytes() + r.tobytes() for a, r in zip(alloc, rank)}) != 8:
        raise AssertionError("the eight catalogs are not distinct")
    err, info = check_fleet_scan(dev, "C=8 distinct catalogs", 512, meta,
                                 compat, alloc, rank, tally)
    worst = max(worst, err)
    summary["C=8 distinct catalogs G=64 O=3072 N=512"] = info

    # C = 16, the headline catalog expanded over the problems (stride 0):
    # equal to the plain version and to each problem launched on its own
    meta, compat, _, _ = stacked_scan_inputs(range(500, 516), 64, O_h,
                                             alloc_h, rank_h)
    a1 = torch.from_numpy(alloc_h).to(dev)
    r1 = torch.from_numpy(rank_h).to(dev)
    C = meta.shape[0]
    a_exp, r_exp = a1.expand(C, O_h, 4), r1.expand(C, O_h)
    err, info = check_fleet_scan(dev, "C=16 expanded catalog", 512, meta,
                                 compat, a_exp, r_exp, tally)
    worst = max(worst, err)
    m_d = torch.from_numpy(meta).to(dev)
    c_d = torch.from_numpy(compat).to(dev)
    together = ffd_kernel.ffd_scan_fleet(m_d, c_d, a_exp, r_exp, 512)
    for c in range(C):
        one = ffd_kernel.ffd_scan_fleet(m_d[c:c + 1], c_d[c:c + 1],
                                        a1.expand(1, O_h, 4),
                                        r1.expand(1, O_h), 512)
        e = max_abs_err([x[c:c + 1] for x in together], one)
        if e:
            first_diff(f"ffd_scan_fleet C=16 problem {c} alone",
                       [x[c:c + 1] for x in together], one)
    torch.cuda.synchronize()
    summary["C=16 expanded headline catalog G=64 O=3072 N=512 (and one "
            "by one)"] = info

    # distinct catalogs at the largest shape
    meta, compat, alloc, rank = stacked_scan_inputs((600, 601), 2048, 4096)
    err, info = check_fleet_scan(dev, "largest", 4096, meta, compat, alloc,
                                 rank, tally)
    worst = max(worst, err)
    summary["C=2 distinct catalogs G=2048 O=4096 N=4096"] = info
    for label, info in summary.items():
        say(f"kernel check ffd_scan_fleet {label}: exact (nodes open "
            f"{info['nodes_open']}, pods unplaced {info['unplaced']})")
    return {"max_abs_err": worst, "cases": summary}


def ulp_tie_inputs(seed: int, G: int, O: int):
    """``scan_inputs`` with a rank tie that only rounding makes: the
    first group (3 pods, an empty window, so rem = 3) fits two large
    offerings whose ranks are one ulp apart, the higher at index 0, and
    that divide by 3 to the same float but not by their full fit.  The
    capped sweep must take index 0."""
    meta, compat, alloc, rank = scan_inputs(seed, G, O)
    rng = np.random.RandomState(seed)
    three = np.float32(3)
    while True:
        lo = np.float32(rng.rand() * 5 + 0.05)
        hi = np.nextafter(lo, np.float32(np.inf), dtype=np.float32)
        if hi / three == lo / three and hi / np.float32(110) != \
                lo / np.float32(110):
            break
    rank[:2] = (hi, lo)
    rank[2:] = np.maximum(rank[2:], hi * 2)
    alloc[:2] = (63800, 62988, 0, 110)
    meta[0, :6] = (500, 512, 0, 1, 3, FIT_BIG)
    compat[0, :2] = 1
    return meta, compat, alloc, rank


def phase_design_checks(dev, tally: dict) -> dict:
    """The shapes the kernel's design has to get right, each against the
    plain version: ragged O (int32 and uint8 compat; one problem and a
    fleet of three catalogs), N = 8192 at O = 4096 and 5000 (the
    instantiations that read the catalog, or rows and catalog, from
    global memory), G = 0 and G below the ring depth, and the ulp tie."""
    worst = 0
    lines = []

    def one(label, N, inputs, u8=False):
        nonlocal worst
        meta, compat, alloc, rank = inputs
        if u8:
            compat = compat.astype(np.uint8)
        err, info = check_scan(dev, label, N, (meta, compat, alloc, rank),
                               tally)
        worst = max(worst, err)
        lines.append((label, info))
        return info

    for O in (1, 129, 3000):
        for u8 in (False, True):
            one(f"ragged O={O} G=64 N=512 {'uint8' if u8 else 'int32'}",
                512, scan_inputs(700 + O, 64, O), u8)
        meta, compat, alloc, rank = stacked_scan_inputs(
            (710 + O, 711 + O, 712 + O), 64, O)
        for u8 in (False, True):
            label = (f"ragged fleet C=3 O={O} G=64 N=512 "
                     f"{'uint8' if u8 else 'int32'}")
            err, info = check_fleet_scan(
                dev, label, 512, meta,
                compat.astype(np.uint8) if u8 else compat, alloc, rank, tally)
            worst = max(worst, err)
            lines.append((label, info))
    for O in (4096, 5000):
        one(f"N=8192 O={O} G=64", 8192, scan_inputs(720 + O, 64, O))
    for G in (0, 1, 2, 3):
        info = one(f"short G={G} O=3072 N=512", 512,
                   scan_inputs(730 + G, G, 3072))
        if G == 0 and info["nodes_open"]:
            raise AssertionError("G=0 opened nodes")
    tie = ulp_tie_inputs(740, 64, 3072)
    one("ulp tie G=64 O=3072 N=512", 512, tie)
    got = ffd_kernel.ffd_scan(*(torch.from_numpy(x).to(dev)[None]
                                for x in tie[:2]),
                              *(torch.from_numpy(x).to(dev)
                                for x in tie[2:]), 512)
    if int(got[0][0, 0]) != 0:
        raise AssertionError("ulp tie: the first node is not offering 0")
    for label, info in lines:
        say(f"kernel check {label}: exact ({info})")
    return {"max_abs_err": worst, "cases": dict(lines)}


def group_rank(rank_np: np.ndarray, G: int, seed: int) -> np.ndarray:
    """A rank row per group, formed as the pref scan forms it
    (rank * (1 + lambda * miss), lambda 0.5): fractional misses, and some
    groups with no preference (the shared row itself)."""
    rng = np.random.RandomState(seed)
    miss = rng.choice(np.float32([0, 1 / 3, 2 / 3, 1]),
                      size=(G, rank_np.shape[0]))
    miss[rng.rand(G) < 0.3] = 0
    return rank_np[None, :] * (np.float32(1) + np.float32(0.5) * miss)


# (O, N) -> the chain instantiation the per-group form takes there: its
# ring slots hold the group's rank row too where that fits, with the
# catalog or without it, else the rows or nothing (csrc/ffd_scan.cu)
PREF_VARIANTS = {(3072, 512): 3, (4096, 4096): 4, (4096, 8192): 1,
                 (5000, 8192): 0}


def phase_pref_kernel_checks(dev, catalog, tally: dict) -> dict:
    """``ffd_scan`` with a rank row per group against its plain version,
    at one shape per instantiation the per-group form takes
    (``PREF_VARIANTS``: rows, catalog and rank rows staged at the
    headline shape, with its cap = 1 edge; rows and rank rows at N = 4096
    and O = 4096; rows only at N = 8192 and O = 4096; neither at N = 8192
    and O = 5000), each as one problem and as a fleet of three catalogs with
    [C, G, O] ranks; and windows shorter than the ring (G = 1, 2) or not
    a whole number of its slots (G = 7, 63), single and fleet."""
    for (O, N), v in PREF_VARIANTS.items():
        got = ffd_kernel.scan_variant(O, N, group_rank=True)
        if got != ffd_kernel.VARIANTS[v]:
            raise AssertionError(f"per-group form at O={O} N={N}: '{got}', "
                                 f"want '{ffd_kernel.VARIANTS[v]}'")
    O_h = 3072
    alloc_h = np.zeros((O_h, 4), np.int32)
    alloc_h[:catalog.num_offerings] = catalog.offering_alloc()
    rank_h = np.zeros(O_h, np.float32)
    rank_h[:catalog.num_offerings] = catalog.offering_rank_price()
    cases = []
    for seed in range(4):
        for case in ("", "cap1"):
            cases.append((f"pref G=64 O=3072 N=512 {case}".strip(), 512,
                          scan_inputs(800 + seed, 64, O_h, alloc_h, rank_h,
                                      case=case)))
    for O, N in PREF_VARIANTS:
        if O != O_h:
            cases.append((f"pref N={N} O={O} G=64", N,
                          scan_inputs(820 + O + N, 64, O)))
    for G in (1, 2, 7, 63):
        cases.append((f"pref short G={G} O=3072 N=512", 512,
                      scan_inputs(840 + G, G, O_h, alloc_h, rank_h)))
    worst = 0
    for k, (label, N, (meta, compat, alloc, rank)) in enumerate(cases):
        err, info = check_scan(dev, label, N, (
            meta, compat, alloc, group_rank(rank, meta.shape[0], k)),
            tally["pref"])
        worst = max(worst, err)
        say(f"kernel check ffd_scan, a rank row per group, {label}: exact "
            f"({info}, '{ffd_kernel.scan_variant(compat.shape[-1], N, True)}"
            f"')")
    fleets = [(f"pref fleet C=3 G=64 O={O} N={N}", 64, O, N)
              for O, N in PREF_VARIANTS]
    fleets += [(f"pref fleet short C=3 G={G} O=3072 N=512", G, O_h, 512)
               for G in (1, 7)]
    for k, (label, G, O, N) in enumerate(fleets):
        meta, compat, alloc, rank = stacked_scan_inputs(
            range(860 + 3 * k, 863 + 3 * k), G, O)
        ranks = np.stack([group_rank(r, G, 50 + 3 * k + c)
                          for c, r in enumerate(rank)])
        err, info = check_fleet_scan(dev, label, N, meta, compat, alloc,
                                     ranks, tally["pref"])
        worst = max(worst, err)
        say(f"kernel check ffd_scan_fleet, a rank row per group, {label}: "
            f"exact ({info})")
    return {"max_abs_err": worst, "cases": len(cases) + len(fleets)}


def require_design_coverage(tally: dict) -> dict:
    """Every instantiation of the chain kernel ran in the checks, and
    the uncapped branch, the capped branch and the summed takes of its
    step; with a rank row per group, every instantiation and the
    uncapped and capped branches."""
    out = {}
    for form, t, need, variants in (
            ("shared rank", tally, ("uncapped", "capped", "summed_takes"),
             ffd_kernel.SHARED_ROW_VARIANTS),
            ("rank row per group", tally["pref"], ("uncapped", "capped"),
             ffd_kernel.GROUP_RANK_VARIANTS)):
        b, v = t["branches"], t["variants"]
        say(f"chain branches over the kernel checks, {form} (host count "
            f"from the plain outputs): {b}")
        for variant, labels in v.items():
            say(f"chain instantiation '{variant}', {form}: {len(labels)} "
                f"checked scans, e.g. {labels[0]!r}")
        if min(b[k] for k in need) <= 0:
            raise AssertionError(f"a branch of the chain never ran ({form}):"
                                 f" {b}")
        missing = set(variants) - set(v)
        if missing:
            raise AssertionError(f"instantiations never checked ({form}): "
                                 f"{missing}")
        out[form] = {"branches": dict(b),
                     "variants": {k: len(x) for k, x in v.items()}}
    return out


# -- phase 4: the main path ---------------------------------------------------


def phase_main_path(dev, pods, catalog, tally: dict):
    solver = TorchSolver(device=dev)
    request = SolveRequest(pods, catalog)
    reset_launches()
    t0 = time.perf_counter()
    plan = solver.solve(request)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    stats = dict(solver.last_stats)
    require_launches(launches, ["ffd_scan", "cost_sum"], "main path")
    if stats["path"] != solver.path:          # "ffd-cuda" on the card
        raise AssertionError(f"main path took {stats['path']!r}")
    clean_and_placed("main path", plan, pods, catalog)
    say(f"main path: {len(plan.nodes)} nodes, {plan.placed_count} pods "
        f"placed, {len(plan.unplaced_pods)} unplaced, cost "
        f"{plan.total_cost_per_hour:.4f} $/h, path {stats['path']}, "
        f"G={stats['G']} O={stats['O']} N={stats['N']}, launches "
        f"{launches}, validate_plan clean, cold solve {cold_s * 1e3:.3f} ms")

    # the card's packed result against the plain solve on the CPU
    problem = encode_mod.encode(pods, catalog)
    prep = solver._prepare(problem)
    card = solver.dispatch_packed(prep).cpu().numpy()
    cpu_cat = [t.cpu() for t in solver.device_offerings(catalog,
                                                        prep.O_pad)]
    plain = tp.solve_packed_torch(
        torch.from_numpy(prep.packed.copy()), *cpu_cat, G=prep.G_pad,
        O=prep.O_pad, U=prep.U_pad, N=prep.N, right_size=True,
        compact=prep.K, dense16=prep.dense16, coo16=prep.coo16).numpy()
    c_card, c_cpu = words_equal("main path", card, plain,
                                prep.N + prep.G_pad)
    say(f"main path result buffer: {card.shape[0]} words equal to the "
        f"plain CPU solve (cost {c_card} vs {c_cpu})")
    # the kernel on the window's own unpacked tensors, against its plain
    # version on the card
    off_alloc, _, off_rank = solver.device_offerings(catalog, prep.O_pad)
    packed = torch.from_numpy(prep.packed).to(dev)
    meta, compat_i, _ = tp.unpack_problem(packed, off_alloc, prep.G_pad,
                                          prep.O_pad, prep.U_pad)
    err, info = check_scan(dev, "main-path window", prep.N,
                           (meta, compat_i, off_alloc, off_rank), tally)
    say(f"kernel check ffd_scan on the main-path window G={prep.G_pad} "
        f"O={prep.O_pad} N={prep.N}: exact ({info})")
    return solver, request, problem, plan, launches, stats, cold_s, err


def build_fleet():
    """BASELINE config #5 as bench.py builds it: FLEET["clusters"]
    clusters, each ``build_workload(pods, types, seed=seed0 + c)`` with
    its own catalog, padded to common buckets and stacked.  Returns the
    stacked problem, the per-cluster (pods, catalog, problem), and the
    node axis sized by ``estimate_nodes`` with its cap."""
    encode = encode_mod.encode
    clusters = []
    for c in range(FLEET["clusters"]):
        pods, catalog = workload.build_workload(
            FLEET["pods"], FLEET["types"], seed=FLEET["seed0"] + c)
        clusters.append((pods, catalog, encode(pods, catalog)))
    G = max(bucket(p.num_groups, GROUP_BUCKETS) for _, _, p in clusters)
    O = max(bucket(cat.num_offerings, OFFERING_BUCKETS)
            for _, cat, _ in clusters)
    per = [(_pad2(p.group_req, G), _pad1(p.group_count, G),
            _pad1(p.group_cap, G), _pad2(p.compat, G, O),
            _pad2(cat.offering_alloc().astype(np.int32), O),
            _pad1(cat.off_price.astype(np.float32), O),
            _pad1(cat.offering_rank_price(), O))
           for _, cat, p in clusters]
    stacked = FleetProblem(*[np.stack([x[i] for x in per])
                             for i in range(7)])
    N_cap = bucket(FLEET["pods"], NODE_BUCKETS)
    N = max(encode_mod.estimate_nodes(p, N_cap, NODE_BUCKETS)
            for _, _, p in clusters)
    return stacked, clusters, N, N_cap


def phase_fleet(dev) -> dict:
    """(b) The fleet through ``fleet_solve_packed`` on the card; every
    cluster's plan decodes and validates clean; the card's [C, Lo]
    result equals the plain CPU fleet program word for word."""
    t0 = time.perf_counter()
    stacked, clusters, N, N_cap = build_fleet()
    build_s = time.perf_counter() - t0
    C, G, O = stacked.compat.shape
    dev_catalog = fleet_device_catalog(stacked, dev)
    packed = fleet_pack_inputs(stacked)
    reset_launches()
    t0 = time.perf_counter()
    while True:
        out = fleet_solve_packed(stacked, num_nodes=N, device=dev,
                                 device_catalog=dev_catalog,
                                 packed_inputs=packed)
        if (out[2] == 0).all() or N >= N_cap:
            break
        N = min(N_cap, bucket(N * 4, NODE_BUCKETS))    # escalate, as bench
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    require_launches(launches, ["ffd_scan_fleet", "cost_sum"], "fleet path")
    node_off, assign, unplaced, cost = out
    if unplaced.sum():
        raise AssertionError(f"fleet left {int(unplaced.sum())} pods "
                             f"unplaced at N={N}")
    nodes = []
    for c, (pods, catalog, problem) in enumerate(clusters):
        plan = encode_mod.decode_plan(problem, node_off[c], assign[c],
                                      unplaced[c], float(cost[c]), "torch")
        clean_and_placed(f"fleet cluster {c}", plan, pods, catalog)
        nodes.append(len(plan.nodes))

    ins, U = packed
    kw = dict(C=C, G=G, O=O, U=U, N=N)
    card = tp.fleet_packed_torch(torch.from_numpy(ins).to(dev),
                                 *dev_catalog, **kw).cpu().numpy()
    plain = tp.fleet_packed_torch(torch.from_numpy(ins),
                                  *(t.cpu() for t in dev_catalog),
                                  **kw).numpy()
    for c in range(C):
        words_equal(f"fleet cluster {c}", card[c], plain[c], N + G)
    say(f"fleet path: {C} clusters x {FLEET['pods']} pods (each its own "
        f"catalog, G={G} O={O} U={U} N={N}), every pod placed, nodes per "
        f"cluster {nodes}, total cost {float(cost.sum()):.4f} $/h, "
        f"validate_plan clean per cluster, launches {launches}; [C, Lo] = "
        f"{list(card.shape)} equal to the plain CPU fleet program word for "
        f"word (cost words included); build+encode {build_s:.3f} s, cold "
        f"fleet solve {cold_s * 1e3:.3f} ms")
    return {"stacked": stacked, "N": N, "U": U, "packed": packed,
            "dev_catalog": dev_catalog, "launches": launches,
            "nodes": nodes, "cold_s": cold_s}


def stream_windows(catalog):
    """STREAM["distinct"] headline-size windows (seeds seed0...) encoded
    against one catalog, so that they can share a batch."""
    out = []
    for i in range(STREAM["distinct"]):
        pods, _ = workload.build_workload(
            HEADLINE["pods"], HEADLINE["types"], seed=STREAM["seed0"] + i)
        out.append((pods, encode_mod.encode(pods, catalog)))
    return out


def phase_stream(dev, catalog) -> dict:
    """(c) ``solve_stream`` of STREAM["windows"] windows at depth 32,
    batch 16: each plan equal to its window's single-window plan, clean,
    every pod placed."""
    windows = stream_windows(catalog)
    solver = TorchSolver(device=dev)
    singles = [solver.solve_encoded(p) for _, p in windows]
    n = STREAM["windows"]
    order = [i % len(windows) for i in range(n)]
    reset_launches()
    t0 = time.perf_counter()
    plans = list(solver.solve_stream((windows[i][1] for i in order),
                                     depth=STREAM["depth"],
                                     batch=STREAM["batch"]))
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    stats = dict(solver.last_stats)
    require_launches(launches, ["ffd_scan_fleet", "cost_sum"],
                     "stream path")
    if stats["path"] != solver.path + "-batch" or len(plans) != n:
        raise AssertionError(f"stream: path {stats['path']!r}, "
                             f"{len(plans)} plans of {n}")
    for k, (i, plan) in enumerate(zip(order, plans)):
        plans_equal(f"stream window {k}", plan, singles[i])
        clean_and_placed(f"stream window {k}", plan, windows[i][0], catalog)
    say(f"stream path: {n} windows ({len(windows)} distinct, seeds "
        f"{STREAM['seed0']}..{STREAM['seed0'] + len(windows) - 1}) at depth "
        f"{STREAM['depth']}, batch {STREAM['batch']}: every plan equal to "
        f"its single-window plan, validate_plan clean, every pod placed; "
        f"path {stats['path']}, batch {stats['batch']} (padded "
        f"{stats['batch_pad']}), launches {launches}, first run "
        f"{wall_s * 1e3:.3f} ms")
    return {"solver": solver, "windows": windows, "order": order,
            "launches": launches, "first_wall_s": wall_s}


def zone_window(pods):
    """The headline pods plus ZONE["apps"] co-scheduled apps, each pod
    with a self PodAffinityTerm on the zone key."""
    extra = []
    for a in range(ZONE["apps"]):
        app = (("app", f"za{a}"),)
        extra += [pod_api.PodSpec(
            f"za{a}-{i}", requests=pod_api.ResourceRequests(1000, 2048, 0, 1),
            affinity=(pod_api.PodAffinityTerm(app, LABEL_ZONE),),
            labels=app) for i in range(ZONE["pods"])]
    return list(pods) + extra


def phase_zone(dev, pods, catalog) -> dict:
    """(d) A zone-candidate window: the plan equals the CPU solver's, is
    clean, places every pod, and its candidate rounds ran as batches."""
    zpods = zone_window(pods)
    request = SolveRequest(zpods, catalog)
    solver = TorchSolver(device=dev)
    reset_launches()
    t0 = time.perf_counter()
    plan = solver.solve(request)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    stats = dict(solver.last_stats)
    require_launches(launches, ["ffd_scan", "ffd_scan_fleet", "cost_sum"],
                     "zone-candidate path")
    if stats["path"] != solver.path + "-batch":
        raise AssertionError(f"zone-candidate rounds took {stats['path']!r}"
                             f", not solve_encoded_batch")
    plans_equal("zone-candidate window", plan,
                TorchSolver(device="cpu").solve(request))
    clean_and_placed("zone-candidate window", plan, zpods, catalog)
    say(f"zone-candidate path: {len(zpods)} pods ({ZONE['apps']} apps x "
        f"{ZONE['pods']} zone-affine pods), {len(plan.nodes)} nodes, cost "
        f"{plan.total_cost_per_hour:.4f} $/h, equal to the CPU solver's "
        f"plan, validate_plan clean; last candidate round a batch of "
        f"{stats['batch']} (padded {stats['batch_pad']}), launches "
        f"{launches}, solve {wall_s * 1e3:.3f} ms")
    return {"launches": launches, "wall_s": wall_s,
            "last_batch": stats["batch"]}


# -- phase 4 (e-g): the routes the default dispatch takes on its own --------


def warm_walls(solver, request, n: int = ROUTE_WARM) -> list[float]:
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        solver.solve(request)
        walls.append(time.perf_counter() - t0)
    return walls


def route_run(dev, label: str, route: str, request, need=()):
    """The window through ``TorchSolver(device=dev).solve`` with the launch
    counts reset just before and read just after, and once through the
    CPU solver: (solver, plan, cpu plan, launches, stats, cold s, cpu s).
    The card's plan must equal the CPU's and name the route and the
    card; the kernels in ``need`` must have run, and no other."""
    solver = TorchSolver(device=dev)
    reset_launches()
    t0 = time.perf_counter()
    plan = solver.solve(request)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    stats = dict(solver.last_stats)
    if need:
        require_launches(launches, need, label)
    require_no_launches({k: v for k, v in launches.items() if k not in need},
                        label)
    if stats["path"] != f"{route}-cuda":
        raise AssertionError(f"{label} took {stats['path']!r}")
    t0 = time.perf_counter()
    cpu_plan = TorchSolver(device="cpu").solve(request)
    cpu_s = time.perf_counter() - t0
    plans_equal(label, plan, cpu_plan)
    return solver, plan, cpu_plan, launches, stats, cold_s, cpu_s


def top_device_ops(run, n: int = 8) -> list | None:
    """The ``n`` PyTorch ops of one call of ``run`` with the most device
    time of their own, from ``torch.profiler``: [(op, calls, device
    ms)], or None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages() if e.key.startswith("aten::")]
    rows.sort(key=lambda r: -r[2])
    if not rows or rows[0][2] <= 0:
        return None
    return rows[:n]


def route_timings(dev, card: str, label: str, solver, request, program,
                  reps: int, spans: int, tag: str) -> dict:
    """p50 warm wall over ROUTE_WARM windows, the device program's CUDA
    event time (``program`` run back to back), kernels per window and
    device busy share from ``torch.profiler``, and the ops of one window
    with the most device time."""
    walls = warm_walls(solver, request)
    p50 = float(np.percentile(walls, 50)) * 1e3
    dev_ms = cuda_ms(program, reps, warm=1)
    prof = profile_spans(lambda: solver.solve(request), spans, tag)
    top = top_device_ops(lambda: solver.solve(request))
    say(f"timing [{card}]: {label}: p50 wall of {ROUTE_WARM} warm windows "
        f"{p50:.4f} ms (min {min(walls) * 1e3:.4f}, max "
        f"{max(walls) * 1e3:.4f}); device program back to back {dev_ms:.4f}"
        f" ms (CUDA events, {reps} runs)")
    if prof is None:
        say(f"profile [{card}]: {label}: torch.profiler recorded no device "
            f"events; kernels per window not measured")
    else:
        say(f"profile [{card}]: {label}: {prof['spans']} warm windows under "
            f"torch.profiler: {prof['kernels_per_span']:.1f} kernels per "
            f"window; device busy {prof['device_busy_ms']:.4f} ms of a "
            f"{prof['profiled_span_ms']:.4f} ms profiled window (busy share "
            f"{prof['device_busy_share']:.4f})")
    if top is None:
        say(f"profile [{card}]: {label}: device time per op not measured")
    else:
        say(f"profile [{card}]: {label}: ops with the most device time in "
            f"one window: " + ", ".join(f"{k} x{c} {ms:.4f} ms"
                                        for k, c, ms in top))
    return {"p50_wall_ms": p50, "walls_ms": [w * 1e3 for w in walls],
            "device_program_ms": dev_ms, "profile": prof,
            "top_device_ops": top}


def flat_inputs(tmpl, dev):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (tmpl.item_req, tmpl.item_gid, tmpl.item_live,
                      tmpl.rows, tmpl.item_row, tmpl.miss_rows)]


def flat_program(tmpl, inputs, catalog_t, N: int):
    """``flat_solve_torch`` of a template on given inputs (the catalog
    tensors: off_alloc, off_price, off_rank)."""
    off_alloc, off_price, off_rank = catalog_t
    item_req, item_gid, item_live, rows, item_row, miss_rows = inputs
    return flat_mod.flat_solve_torch(
        item_req, item_gid, item_live, rows, item_row, off_alloc, off_rank,
        miss_rows, off_price, I=tmpl.I_pad, O=tmpl.O_pad, G=tmpl.G_pad, N=N,
        K=tmpl.K, U=tmpl.U_pad, slim=tmpl.slim)


def phase_flat(dev, card: str) -> dict:
    """(e) The flat regime: both FLAT_WINDOWS through ``solve`` on the
    card (segment_sum launched, no FFD kernel), each plan equal to the
    CPU solver's, clean, every pod placed; the card's raw result equal to
    the plain CPU program word for word.  Then the segment-sum kernel
    against its plain version on every call the program made."""
    windows, calls = [], []
    for w in FLAT_WINDOWS:
        label = f"flat window (seed {w['seed']}" + (
            f", {w['constrained_frac']:.0%} constrained, "
            f"{w['pref_frac']:.0%} preferences)" if len(w) > 1 else ")")
        pods, catalog = workload.build_hetero_workload(
            HEADLINE["pods"], HEADLINE["types"], **w)
        request = SolveRequest(pods, catalog)
        solver, plan, cpu_plan, launches, stats, cold_s, cpu_s = route_run(
            dev, label, "flat", request, need=("segment_sum", "cost_sum"))
        clean_and_placed(label, plan, pods, catalog)
        problem = encode_mod.encode(pods, catalog)
        tmpl = flat_mod.flat_template(solver, problem)
        dev_cat = solver.device_offerings(catalog, tmpl.O_pad)
        cpu_cat = [t.cpu() for t in dev_cat]
        dev_in = flat_inputs(tmpl, dev)
        card_out, info = flat_program(tmpl, dev_in, dev_cat, stats["N"])
        plain_out, _ = flat_program(tmpl, flat_inputs(tmpl, "cpu"), cpu_cat,
                                    stats["N"])
        cost_word = (stats["N"] // 2 + tmpl.G_pad // 2) if tmpl.slim \
            else stats["N"] + tmpl.G_pad
        c_card, c_cpu = words_equal(label, card_out.cpu().numpy(),
                                    plain_out.numpy(), cost_word)
        say(f"{label}: G={problem.num_groups} (padded {stats['G']}) "
            f"I={stats['I']} O={stats['O']} U={stats['U']} N={stats['N']} "
            f"K={stats['K']} slim={stats['slim']}: {len(plan.nodes)} nodes, "
            f"{plan.placed_count} pods placed, cost "
            f"{plan.total_cost_per_hour:.4f} $/h, path {stats['path']}, "
            f"launches {launches}, {stats['rounds']} rounds, "
            f"{stats['host_syncs']} host syncs per window, "
            f"{stats['escalations']} escalations; plan equal to the CPU "
            f"solver's, validate_plan clean; result buffer "
            f"{card_out.shape[0]} words equal to the plain CPU program "
            f"(cost {c_card} vs {c_cpu}); cold solve {cold_s * 1e3:.3f} ms, "
            f"CPU solve {cpu_s * 1e3:.3f} ms")
        # every segment sum of one program run, for the kernel check
        orig = flat_mod.segment_sum
        before = len(calls)

        def record(v, s, S, orig=orig):
            calls.append((v.clone(), s.clone(), S))
            return orig(v, s, S)

        flat_mod.segment_sum = record
        try:
            flat_program(tmpl, dev_in, dev_cat, stats["N"])
        finally:
            flat_mod.segment_sum = orig
        say(f"{label}: {len(calls) - before} segment_sum calls in one "
            f"window (" + ", ".join(f"[{v.shape[0]}, {v.shape[1]}] -> {S}"
                                    for v, _, S in calls[before:]) + ")")
        t = route_timings(
            dev, card, label, solver, request,
            lambda: flat_program(tmpl, dev_in, dev_cat, stats["N"]), 10, 5,
            "flat_window")
        t.update(segment_sum_calls=len(calls) - before,
                 host_syncs=stats["host_syncs"], rounds=stats["rounds"],
                 cold_ms=cold_s * 1e3, cpu_solve_ms=cpu_s * 1e3,
                 launches=launches, nodes=len(plan.nodes),
                 shape={k: stats[k] for k in ("G", "I", "O", "U", "N", "K")},
                 groups=problem.num_groups, cost=plan.total_cost_per_hour)
        windows.append(t)
    return {"windows": windows, "segment_sum": segment_sum_checks(calls,
                                                                  card),
            "launches": {k: sum(w["launches"][k] for w in windows)
                         for k in windows[0]["launches"]}}


def segment_sum_checks(calls, card: str) -> dict:
    """``segment_sum`` against its plain version (index-order adds on the
    CPU) on every call the flat program made, bit for bit.  On every call
    the wrapper's time back to back beside ``index_add_`` (the PyTorch
    call for the same sums, in atomic order; medians of rounds taken in
    turns) and the kernel's device time alone, with the call's kept rows
    and longest segment (the chain of dependent adds that sets the
    kernel's time); on the largest call also the device kernels per call
    (``torch.profiler``, exact), the plain version and the bound."""
    err = 0.0
    rows = []
    for v, s, S in calls:
        got = segment_sum.segment_sum(v, s, S)
        want = segment_sum.segment_sum_reference(v, s, S)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            diff = (got - want).abs()
            raise AssertionError(f"segment_sum differs from its plain "
                                 f"version on [{v.shape[0]}, {v.shape[1]}] "
                                 f"-> {S}: max |diff| {float(diff.max())}")
        err = max(err, float((got - want).abs().max()))
        keep = (s >= 0) & (s < S)
        kept = int(keep.sum())
        longest = int(torch.bincount(s[keep].long()).max()) if kept else 0
        call = lambda v=v, s=s, S=S: segment_sum.segment_sum(  # noqa: E731
            v, s, S)
        # index_add_ takes no id outside its rows: dropped ids go to a
        # spare row S (mapped before the timing), as the flat program's
        # sentinel did
        idx = torch.where(keep, s, S).long()
        paired = paired_ms({"kernel": call, "index_add_": lambda v=v, S=S,
                            idx=idx: torch.zeros(
                                (S + 1, v.shape[1]),
                                device=v.device).index_add_(0, idx, v)}, 50)
        rows.append({"shape": [v.shape[0], v.shape[1], S], "kept_rows": kept,
                     "longest_segment": longest, "ms": paired["kernel"],
                     "library_ms": paired["index_add_"],
                     "device_ms": kernel_device_ms(call,
                                                   "segment_sum_kernel")})
    say(f"timing [{card}]: segment_sum on each call of the flat program "
        f"(wrapper back to back / index_add_ in turns / kernel device time "
        f"alone): " + "; ".join(
            f"[{r['shape'][0]}, {r['shape'][1]}] -> {r['shape'][2]}, "
            f"{r['kept_rows']} rows kept, longest segment "
            f"{r['longest_segment']}: {r['ms']:.4f} / {r['library_ms']:.4f}"
            f" / {r['device_ms']:.4f} ms" for r in rows))
    at = max(range(len(calls)),
             key=lambda i: (calls[i][0].shape[0], calls[i][2]))
    v, s, S = calls[at]
    big = rows[at]
    call = lambda: segment_sum.segment_sum(v, s, S)  # noqa: E731
    ms, lib_ms, device_ms = big["ms"], big["library_ms"], big["device_ms"]
    per_call = kernels_per_call(call, "segment_sum_call",
                                segment_sum.LAUNCHES, "segment_sum")
    if per_call > 2:
        raise AssertionError(f"segment_sum issues {per_call} device "
                             f"kernels per call (at most 2)")
    plain_ms = cuda_ms(lambda: segment_sum.segment_sum_reference(v, s, S), 5,
                       warm=1)
    # what this call's data needs: every id, the rows that are kept, the
    # output; one add per kept value
    kept = big["kept_rows"]
    nbytes = s.numel() * s.element_size() + kept * v.shape[1] * 4 \
        + S * v.shape[1] * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = kept * v.shape[1] / SCALAR_OPS_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    say(f"kernel check segment_sum: {len(calls)} calls of the flat program, "
        f"exact against the plain version; timing [{card}]: "
        f"[{v.shape[0]}, {v.shape[1]}] -> {S} segments ({kept} rows kept, "
        f"longest segment {big['longest_segment']}): wrapper {ms:.4f} ms "
        f"back to back, kernel device time alone {device_ms:.4f} ms, "
        f"{per_call} device kernels per call, plain version "
        f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms (wrapper / index_add_ "
        f"x{ms / lib_ms:.3f}), bound {bound_ms:.6f} ms ({bound_by}: "
        f"{nbytes} bytes)")
    return {"calls": len(calls), "max_abs_err": err, "ms": ms,
            "device_ms": device_ms, "kernels_per_call": per_call,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes, "kept_rows": kept,
            "longest_segment": big["longest_segment"],
            "shape": [v.shape[0], v.shape[1], S], "by_call": rows}


def packed_route_check(dev, label: str, solver, problem, program_of):
    """The card's packed result of a window against the CPU solver's on
    the same template, word for word (the cost word too); returns the device
    program (a zero-argument callable on the card's tensors) for timing,
    and the prepared shapes."""
    prep = solver._prepare(problem)
    card = solver.dispatch_packed(prep).cpu().numpy()
    cpu_solver = TorchSolver(device="cpu")
    cpu_prep = cpu_solver._prepare(problem)
    plain = cpu_solver.dispatch_packed(cpu_prep).numpy()
    c_card, c_cpu = words_equal(label, card, plain, prep.N + prep.G_pad)
    say(f"{label}: result buffer {card.shape[0]} words equal to the plain "
        f"CPU program (cost {c_card} vs {c_cpu})")
    return program_of(prep), prep, card


def phase_affinity(dev, card: str) -> dict:
    """(f) The affinity plane: the bench's 10k-pod window through
    ``solve`` on the card (the affinity scan, no hand kernel), the plan
    equal to the CPU solver's, clean under validate_plan and
    validate_affinity_plan, with the CPU's placed count; the raw result
    equal to the plain CPU program word for word."""
    label = "affinity window"
    catalog = workload.build_catalog(HEADLINE["types"])
    pods = workload.affinity_bench_pods(
        AFFINITY["tag"], HEADLINE["pods"],
        np.random.RandomState(AFFINITY["rng_seed"]))
    request = SolveRequest(pods, catalog)
    solver, plan, cpu_plan, launches, stats, cold_s, cpu_s = route_run(
        dev, label, "affinity", request, need=("cost_sum",))
    clean_and_placed(label, plan, pods, catalog,
                     placed=cpu_plan.placed_count)
    errors = validate_affinity_plan(plan, pods)
    if errors:
        raise AssertionError(f"{label}: validate_affinity_plan: "
                             f"{errors[:5]}")
    problem = encode_mod.encode(pods, catalog)
    if problem.aff is None or not problem.aff.device_armed:
        raise AssertionError(f"{label} does not arm the affinity lane")

    def program_of(prep):
        off_alloc, off_price, off_rank = solver.device_offerings(
            catalog, prep.O_pad)
        packed = torch.from_numpy(prep.packed).to(dev)
        aff = torch.from_numpy(prep.aff).to(dev)
        return lambda: solve_packed_affinity(
            packed, aff, off_alloc, off_price, off_rank, G=prep.G_pad,
            O=prep.O_pad, U=prep.U_pad, N=prep.N)

    program, prep, _ = packed_route_check(dev, label, solver, problem,
                                          program_of)
    say(f"{label}: G={problem.num_groups} (padded {prep.G_pad}) "
        f"O={prep.O_pad} N={prep.N}, {problem.aff.edge_count} edges: "
        f"{len(plan.nodes)} nodes, {plan.placed_count} placed, "
        f"{len(plan.unplaced_pods)} unplaced (as on the CPU), cost "
        f"{plan.total_cost_per_hour:.4f} $/h, path {stats['path']}, launches "
        f"{launches}; plan equal to the CPU solver's, validate_plan and "
        f"validate_affinity_plan clean; cold solve {cold_s * 1e3:.3f} ms, "
        f"CPU solve {cpu_s * 1e3:.3f} ms")
    t = route_timings(dev, card, label, solver, request, program, 3, 2,
                      "affinity_window")
    t.update(cold_ms=cold_s * 1e3, cpu_solve_ms=cpu_s * 1e3,
             launches=launches, nodes=len(plan.nodes),
             placed=plan.placed_count, unplaced=len(plan.unplaced_pods),
             shape={"G": prep.G_pad, "O": prep.O_pad, "N": prep.N},
             groups=problem.num_groups, cost=plan.total_cost_per_hour)
    return t


def phase_stochastic(dev, card: str) -> dict:
    """(g) The stochastic plane: run_stochastic's 10k-pod menu on an
    overcommitting pool through ``solve`` on the card (the chance scan,
    no hand kernel), the plan equal to the CPU solver's, clean under the
    chance rule, every pod placed; the raw result equal to the plain CPU
    program word for word."""
    label = "stochastic window"
    catalog = workload.build_catalog(HEADLINE["types"])
    pods = workload.stochastic_pods(HEADLINE["pods"],
                                    seed=STOCHASTIC["seed"])
    pool = NodePool(name="default", overcommit=STOCHASTIC["overcommit"])
    request = SolveRequest(pods, catalog, pool)
    solver, plan, cpu_plan, launches, stats, cold_s, cpu_s = route_run(
        dev, label, "stochastic", request, need=("cost_sum",))
    clean_and_placed(label, plan, pods, catalog, pool)
    problem = encode_mod.encode(pods, catalog, pool)

    def program_of(prep):
        off_alloc, off_price, off_rank = solver.device_offerings(
            catalog, prep.O_pad)
        packed = torch.from_numpy(prep.packed).to(dev)
        sto = torch.from_numpy(prep.sto).to(dev)
        kd, kc = solver._fit_grids(prep, sto, off_alloc)
        return lambda: solve_packed_stochastic(
            packed, sto, kd, kc, off_alloc, off_price, off_rank,
            G=prep.G_pad, O=prep.O_pad, U=prep.U_pad, N=prep.N,
            z_bp=prep.z_bp)

    program, prep, _ = packed_route_check(dev, label, solver, problem,
                                          program_of)
    say(f"{label}: G={problem.num_groups} (padded {prep.G_pad}) "
        f"O={prep.O_pad} N={prep.N}, z_bp={prep.z_bp}: {len(plan.nodes)} "
        f"nodes, {plan.placed_count} pods placed, cost "
        f"{plan.total_cost_per_hour:.4f} $/h, path {stats['path']}, launches "
        f"{launches}; plan equal to the CPU solver's, validate_plan (chance "
        f"rule) clean; cold solve {cold_s * 1e3:.3f} ms, CPU solve "
        f"{cpu_s * 1e3:.3f} ms")
    t = route_timings(dev, card, label, solver, request, program, 3, 2,
                      "stochastic_window")
    t.update(cold_ms=cold_s * 1e3, cpu_solve_ms=cpu_s * 1e3,
             launches=launches, nodes=len(plan.nodes),
             placed=plan.placed_count,
             shape={"G": prep.G_pad, "O": prep.O_pad, "N": prep.N},
             groups=problem.num_groups, cost=plan.total_cost_per_hour)
    return t


# -- phase 4 (h-k): soft preferences, the resident store, the serving loop --


def fractional_groups_per_node(prep, out_np: np.ndarray) -> int:
    """Most groups with a fractional miss (0 < miss < 1 somewhere) that
    one open node of a pref window's result holds."""
    _, assign, _, _ = unpack_result(out_np, prep.G_pad, prep.N, prep.K,
                                    prep.dense16, prep.coo16)
    idx = prep.pref_idx
    rows = prep.pref_rows[np.clip(idx, 0, None)]
    frac = (idx >= 0) & ((rows > 0) & (rows < 1)).any(axis=1)
    return int(((assign > 0) & frac[:, None]).sum(axis=0).max())


def phase_pref(dev, card: str, tally: dict) -> dict:
    """(h) The pref window: the headline pods with soft preferences
    (``workload.with_preferences``) through ``solve`` on the card, the FFD
    kernel with a rank row per group; the plan equal to the CPU solver's
    and clean, the raw result equal to the plain CPU program word for
    word, a node holding three or more groups with fractional misses;
    the kernel on the window's tensors against its plain version; the
    route's timings, the kernel beside its shared-rank form and the pref
    right-size beside the plain one."""
    label = "pref window"
    pods, catalog = workload.build_workload(
        HEADLINE["pods"], HEADLINE["types"], seed=HEADLINE["seed"])
    pods = workload.with_preferences(pods)
    request = SolveRequest(pods, catalog)
    problem = encode_mod.encode(pods, catalog)
    gate = SolverOptions().flat_min_groups
    if problem.pref_rows is None or problem.num_groups >= gate:
        raise AssertionError(f"{label}: G={problem.num_groups} (flat gate "
                             f"{gate}), preferences "
                             f"{problem.pref_rows is not None}")
    solver, plan, cpu_plan, launches, stats, cold_s, cpu_s = route_run(
        dev, label, "pref", request,
        need=("ffd_scan_pref", "presence_sum", "cost_sum"))
    clean_and_placed(label, plan, pods, catalog)
    lam_bp = int(solver.options.preference_lambda * 10000)

    def tensors(prep):
        off_alloc, off_price, off_rank = solver.device_offerings(
            catalog, prep.O_pad)
        return (torch.from_numpy(prep.packed).to(dev),
                torch.from_numpy(prep.pref_rows).to(dev),
                torch.from_numpy(prep.pref_idx).to(dev), off_alloc,
                off_price, off_rank)

    def program_of(prep):
        args = tensors(prep)
        return lambda: tp.solve_packed_pref_torch(
            *args, G=prep.G_pad, O=prep.O_pad, U=prep.U_pad, N=prep.N,
            P=prep.pref_rows.shape[0], lam_bp=lam_bp)

    program, prep, card_out = packed_route_check(dev, label, solver,
                                                 problem, program_of)
    shared = fractional_groups_per_node(prep, card_out)
    if shared < 3:
        raise AssertionError(f"{label}: no node holds three groups with "
                             f"fractional misses (at most {shared})")
    G, O, U, N = prep.G_pad, prep.O_pad, prep.U_pad, prep.N
    packed, pref_rows, pref_idx, off_alloc, off_price, off_rank = \
        tensors(prep)
    meta, compat_i, _ = tp.unpack_problem(packed, off_alloc, G, O, U)
    lam = lam_bp / 10000.0
    miss_g, rank_g = tp.pref_rank_rows(pref_rows, pref_idx, off_rank, lam)
    err, info = check_scan(dev, label, N, (meta, compat_i, off_alloc,
                                           rank_g), tally["pref"])
    say(f"{label}: G={problem.num_groups} (padded {G}) O={O} U={U} N={N} "
        f"P={prep.pref_rows.shape[0]}: {len(plan.nodes)} nodes, "
        f"{plan.placed_count} pods placed, cost "
        f"{plan.total_cost_per_hour:.4f} $/h, path {stats['path']}, "
        f"launches {launches}; up to {shared} groups with fractional misses "
        f"on one node; plan equal to the CPU solver's, validate_plan clean; "
        f"kernel check on the window's tensors exact ({info}); cold solve "
        f"{cold_s * 1e3:.3f} ms, CPU solve {cpu_s * 1e3:.3f} ms")

    # the kernel with its rank rows beside the same scan on the shared
    # row, in turns; the capped sweeps of each (the steps that read the
    # rank row on the chain) from the plain outputs
    m3, c3 = meta[None].contiguous(), compat_i[None].contiguous()
    out_pref = ffd_kernel.ffd_scan(m3, c3, off_alloc, rank_g, N)
    out_shared = ffd_kernel.ffd_scan(m3, c3, off_alloc, off_rank, N)
    node_off, assign, _ = (x[0] for x in out_pref)
    branches = ffd_kernel.chain_branches(m3, c3, off_alloc, *out_pref)
    shared_branches = ffd_kernel.chain_branches(m3, c3, off_alloc,
                                                *out_shared)
    variant = ffd_kernel.scan_variant(O, N, group_rank=True)
    turns = paired_ms({
        "pref": lambda: ffd_kernel.ffd_scan(m3, c3, off_alloc, rank_g, N),
        "shared": lambda: ffd_kernel.ffd_scan(m3, c3, off_alloc, off_rank,
                                              N)}, 20)
    ms, shared_ms = turns["pref"], turns["shared"]
    capped = branches["capped"]
    extra_us = (ms - shared_ms) * 1e3 / capped if capped else None
    plain_ms = cuda_ms(lambda: ffd_kernel.ffd_scan_reference(
        m3, c3, off_alloc, rank_g, N), 3, warm=1)
    bound_ms, bound_by, nbytes, ops = scan_bound_ms(
        m3, c3, off_alloc, rank_g, N, assign.cpu().numpy()[None],
        node_off.cpu().numpy()[None])
    rs_pref_ms = cuda_ms(lambda: tp.cost_word(tp.finish_solve(
        meta, compat_i, node_off, assign, off_alloc, off_rank, True,
        miss_g=miss_g, pref_lambda=lam), off_price), 20)
    rs_ms = cuda_ms(lambda: tp.cost_word(tp.finish_solve(
        meta, compat_i, node_off, assign, off_alloc, off_rank, True),
        off_price), 20)
    rank_ms = cuda_ms(lambda: tp.pref_rank_rows(pref_rows, pref_idx,
                                                off_rank, lam), 50)
    extra_txt = "no capped step" if extra_us is None \
        else f"{extra_us:.4f} us per capped step"
    say(f"ffd_scan_pref on the pref window: chain instantiation "
        f"'{variant}'; chain branches (host count from the outputs) "
        f"{branches}, {capped} capped sweeps; the shared-row scan's "
        f"{shared_branches}")
    say(f"timing [{card}]: ffd_scan_pref on the pref window G={G} O={O} "
        f"N={N}: kernel {ms:.4f} ms ({ms / G * 1e3:.4f} us per group step), "
        f"the same scan on the shared rank row {shared_ms:.4f} ms (x"
        f"{ms / shared_ms:.4f}, medians of 5 rounds of 20 in turns; "
        f"{extra_txt} over the shared row), plain PyTorch version "
        f"{plain_ms:.4f} ms, "
        f"bound {bound_ms:.6f} ms ({bound_by}: {nbytes} bytes, {ops} scalar "
        f"ops); forming rank_g {rank_ms:.4f} ms; right-size + cost with "
        f"preferences {rs_pref_ms:.4f} ms against {rs_ms:.4f} ms without; "
        f"no single PyTorch call computes the scan (library_ms null)")
    psum = presence_sum_checks(dev, card, (assign > 0).to(torch.float32),
                               miss_g)
    t = route_timings(dev, card, label, solver, request, program, 10, 5,
                      "pref_window")
    t.update(cold_ms=cold_s * 1e3, cpu_solve_ms=cpu_s * 1e3,
             launches=launches, nodes=len(plan.nodes),
             shape={"G": G, "O": O, "U": U, "N": N,
                    "P": prep.pref_rows.shape[0]},
             groups=problem.num_groups, cost=plan.total_cost_per_hour,
             fractional_groups_per_node=shared)
    return {"route": t, "max_abs_err": err,
            "ffd_scan_pref": {"ms": ms, "shared_rank_ms": shared_ms,
                              "ratio_to_shared": ms / shared_ms,
                              "capped_steps": capped,
                              "branches": branches,
                              "shared_branches": shared_branches,
                              "us_per_capped_step": extra_us,
                              "variant": variant,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "bound_by": bound_by, "bytes": nbytes,
                              "ops": ops, "library_ms": None,
                              "us_per_step": ms / G * 1e3},
            "presence_sum": psum,
            "right_size_pref_ms": rs_pref_ms, "right_size_ms": rs_ms,
            "rank_rows_ms": rank_ms}


def presence_cases(dev, present, miss) -> list:
    """(label, present, miss): the pref window's own tensors, then seeded
    ones: fractional misses, 2% presence, ragged O, G not a multiple of
    32, a node holding every group, an all-closed node axis, one node,
    and G at the kernel's maximum (with a node holding all of them)."""
    cases = [("pref window", present, miss)]
    top = presence_sum._bound()[1]
    for G, N, O, edge in ((512, 512, 3072, ""), (64, 64, 129, ""),
                          (341, 384, 1, ""), (77, 200, 3071, ""),
                          (341, 64, 3072, "full node"),
                          (512, 512, 3072, "all closed"),
                          (45, 1, 256, ""), (top, 40, 132, "full node")):
        rng = np.random.RandomState(G + N + O)
        p = (rng.rand(G, N) < 0.02).astype(np.float32)
        if edge == "full node":
            p[:, N // 2] = 1
        if edge == "all closed":
            p[:] = 0
        m = rng.choice(np.float32([0, 1 / 3, 2 / 3, 1, 0.1]), size=(G, O))
        cases.append((f"seeded G={G} N={N} O={O} {edge}".strip(),
                      torch.from_numpy(p).to(dev),
                      torch.from_numpy(m).to(dev)))
    return cases


def presence_bound_ms(present, miss) -> tuple[float, str, int, int, int]:
    """The presence sum's least time on the card for this call's data:
    the flags read once, the miss rows of the groups present on some
    node read once, the [N, O] output written once; against the adds
    (present pairs x O) at the float32 scalar rate.  Also returns the
    earlier count of whole tensors (every miss row read)."""
    G, N = present.shape
    O = miss.shape[1]
    on = present != 0
    rows = int(on.any(1).sum())
    nbytes = 4 * (G * N + rows * O + N * O)
    adds = int(on.sum()) * O
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = adds / SCALAR_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, adds, 4 * (G * N + G * O + N * O))


def presence_sum_checks(dev, card: str, present, miss) -> dict:
    """``presence_sum`` against its plain version (one ordered
    ``addcmul_`` per group) bit for bit on every ``presence_cases`` case;
    on the pref window, in turns, its time beside ``torch.matmul`` (the
    same sums in another order), the plain version, the device time
    alone, the device kernels per call (at most 2) and the bound as the
    data needs it."""
    cases = presence_cases(dev, present, miss)
    for label, p, m in cases:
        got = presence_sum.presence_sum(p, m)
        want = presence_sum.presence_sum_reference(p, m)
        torch.cuda.synchronize()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            raise AssertionError(f"presence_sum differs from its plain "
                                 f"version on {label}: max |diff| "
                                 f"{float((got - want).abs().max())}")
    call = lambda: presence_sum.presence_sum(present, miss)  # noqa: E731
    turns = paired_ms({"presence_sum": call,
                       "torch.matmul": lambda: present.t() @ miss}, 50)
    ms, lib_ms = turns["presence_sum"], turns["torch.matmul"]
    device_ms = kernel_device_ms(call, "presence_sum_kernel")
    per_call = kernels_per_call(call, "presence_sum_call",
                                presence_sum.LAUNCHES, "presence_sum")
    if per_call > 2:
        raise AssertionError(f"presence_sum: {per_call} device kernels per "
                             f"call, more than 2")
    plain_ms = cuda_ms(lambda: presence_sum.presence_sum_reference(
        present, miss), 5, warm=1)
    bound_ms, bound_by, nbytes, adds, whole = presence_bound_ms(present,
                                                                miss)
    G, N = present.shape
    O = miss.shape[1]
    counts = (present != 0).sum(0)
    say(f"kernel check presence_sum: {len(cases)} cases exact against the "
        f"plain version ({', '.join(c[0] for c in cases)})")
    say(f"timing [{card}]: presence_sum on the pref window's [G={G}, N={N}] "
        f"x [G, O={O}] ({int(counts.sum())} present pairs, "
        f"{int((counts > 0).sum())} nodes holding a group, at most "
        f"{int(counts.max())} on one): kernel {ms:.4f} ms back to back "
        f"(medians of 5 rounds of 50 in turns), device time alone "
        f"{device_ms:.4f} ms, {per_call} device kernels per call; "
        f"torch.matmul {lib_ms:.4f} ms "
        f"(presence_sum / torch.matmul x{ms / lib_ms:.4f}); plain version "
        f"({G} ordered addcmul_) {plain_ms:.4f} ms; bound {bound_ms:.6f} ms "
        f"({bound_by}: {nbytes} bytes as the data needs them, {whole} as "
        f"whole tensors, {adds} adds)")
    return {"max_abs_err": 0.0, "cases": len(cases), "ms": ms,
            "device_ms": device_ms, "kernels_per_call": per_call,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "whole_tensor_bytes": whole, "ops": adds,
            "present_pairs": int(counts.sum()),
            "max_groups_per_node": int(counts.max())}


def churn_stream(cfg: dict):
    """bench.py's resident / serving churn at the headline size: the
    seed's 10k-pod window, then per window 1-5 departures and 1-5
    arrivals of 500m/1Gi pods from ``random.Random(cfg["rng"])``."""
    pods, catalog = workload.build_workload(
        HEADLINE["pods"], HEADLINE["types"], seed=cfg["seed"])
    rng = random.Random(cfg["rng"])
    seqs, cur = [], list(pods)
    for w in range(cfg["windows"]):
        if w:
            for _ in range(rng.randrange(1, 6)):
                cur.pop(rng.randrange(len(cur)))
            cur.extend(pod_api.PodSpec(
                f"{cfg['tag']}{w}n{i}",
                requests=pod_api.ResourceRequests(500, 1024, 0, 1))
                for i in range(rng.randrange(1, 6)))
        seqs.append(list(cur))
    return seqs, catalog


def p50_ms(xs) -> float:
    return float(np.percentile(xs, 50)) * 1e3


def fmt_ms(xs) -> str:
    return "/".join(f"{x:.4f}" for x in xs)


def phase_resident(dev, card: str) -> dict:
    """(i) The resident stream: resident on and off alternately (the
    order flips each window), every plan equal, the device state equal
    to the mirror and to the window's packed buffer after every window;
    the last window re-solved for a hit; rebuild, delta and hit seen.
    The counts are zeroed before each resident solve and read after it:
    one ``ffd_scan`` per dispatch and no other kernel.  Each resident
    dispatch's raw result is held word for word against the classic
    dispatch of the same prepared window.  Each window is encoded before
    its timed solves, so both arms' walls read the encode memo, not the
    encode."""
    seqs, catalog = churn_stream(RESIDENT)
    on = TorchSolver(SolverOptions(resident="on"), device=dev)
    off = TorchSolver(SolverOptions(resident="off"), device=dev)
    walls = {"on": [], "off": []}
    modes, h2d, words = [], [], []
    kept = []                       # (prep, device result) per dispatch
    dispatch_solve = on.resident.dispatch_solve

    def keep(prep, packed, catalog_t, right_size):
        out = dispatch_solve(prep, packed, catalog_t, right_size)
        kept.append((prep, out))
        return out

    on.resident.dispatch_solve = keep
    launches: dict = {}
    for w, pods_w in enumerate(seqs + seqs[-1:]):
        request = SolveRequest(pods_w, catalog)
        problem = encode_mod.encode(pods_w, catalog)
        plans = {}
        for arm in (("off", "on") if w % 2 == 0 else ("on", "off")):
            solver = on if arm == "on" else off
            if arm == "on":
                kept.clear()
                reset_launches()
            t0 = time.perf_counter()
            plans[arm] = solver.solve(request)
            walls[arm].append(time.perf_counter() - t0)
            if arm == "on":
                got = {k: v for k, v in launch_counts().items() if v}
        plans_equal(f"resident window {w}", plans["on"], plans["off"])
        st = on.last_stats
        if st["path"] != "resident-cuda":
            raise AssertionError(f"resident window {w} took {st['path']!r}")
        dispatches = 1 + st["escalations"] + st["coo_growths"]
        if got != {"ffd_scan": dispatches, "cost_sum": dispatches} \
                or len(kept) != dispatches:
            raise AssertionError(f"resident window {w}: {len(kept)} resident "
                                 f"dispatches launched {got}, want one "
                                 f"ffd_scan and one cost_sum each of "
                                 f"{dispatches}")
        for name, n in got.items():
            launches[name] = launches.get(name, 0) + n
        prep, out = kept[-1]
        classic = prep.clone()
        classic.resident = False
        words_equal(f"resident window {w}", out.cpu().numpy(),
                    off.dispatch_packed(classic).cpu().numpy(),
                    prep.N + prep.G_pad)
        modes.append(st["resident_mode"])
        h2d.append(st["h2d_bytes"])
        words.append(st["delta_words"])
        snap = on.resident.snapshot_state()
        want = resident_delta.pack_window(problem)[0]
        if not (np.array_equal(snap["mirror"], snap["device"])
                and np.array_equal(snap["device"], want)):
            raise AssertionError(f"resident window {w}: device state != "
                                 f"mirror != packed window")
    if not {"rebuild", "delta", "hit"} <= set(modes) or modes[-1] != "hit":
        raise AssertionError(f"resident modes {modes}")
    warm = slice(1, len(seqs))
    out = {"modes": modes, "h2d_bytes": h2d, "delta_words": words,
           "full_packed_bytes": int(want.nbytes),
           "on_p50_ms": p50_ms(walls["on"][warm]),
           "off_p50_ms": p50_ms(walls["off"][warm]),
           "on_walls_ms": [x * 1e3 for x in walls["on"]],
           "off_walls_ms": [x * 1e3 for x in walls["off"]],
           "warm_h2d_p50_bytes": float(np.percentile(h2d[warm], 50)),
           "warm_delta_words_p50": float(np.percentile(words[warm], 50)),
           "launches": launches, "stats": on.resident.stats()}
    say(f"resident path: {len(seqs)} windows of {RESIDENT['seed']}'s "
        f"10k-pod churn (+1 repeat), resident on/off alternately: every "
        f"plan equal, every resident raw result equal to the classic raw "
        f"result word for word, device state == mirror == packed window "
        f"after every window; modes {modes}; launches of the resident "
        f"solves alone {launches}")
    say(f"timing [{card}]: resident stream warm p50 wall: on "
        f"{out['on_p50_ms']:.4f} ms, off {out['off_p50_ms']:.4f} ms; H2D "
        f"per warm window p50 {out['warm_h2d_p50_bytes']:.0f} B (full "
        f"packed buffer {out['full_packed_bytes']} B), delta words p50 "
        f"{out['warm_delta_words_p50']:.0f}")
    return out


def phase_serving(dev, card: str) -> dict:
    """(j) The serving stream: a cold pass and a warm pass of
    ``serve``-style submits at depth 2; every window on the ring, none
    backpressured, ``ring_state_violations`` empty, every plan equal to
    the classic plan and every raw ring result equal to the classic raw
    result word for word; then the port's 8-seed parity checks."""
    from karpenter_tpu_torch.serving.ring import OutputRing
    from karpenter_tpu_torch.serving.validate import (
        plan_parity_violations, raw_parity_violations,
        ring_state_violations,
    )

    seqs, catalog = churn_stream(SERVING)
    problems = [encode_mod.encode(p, catalog) for p in seqs]
    on = TorchSolver(SolverOptions(serving="on"), device=dev)
    off = TorchSolver(SolverOptions(serving="off"), device=dev)
    loop = on.serving
    slots = {}

    class KeepingRing(OutputRing):
        """The loop's output ring, keeping every slot it hands out."""

        def take(self, seq):
            slot = slots[seq] = super().take(seq)
            return slot

    loop.output = KeepingRing(loop.capacity)
    reset_launches()
    cold = list(loop.serve(iter(problems), depth=SERVING["depth"]))
    kick_s, plans = [], []
    pending = deque()
    t0 = time.perf_counter()
    for problem in problems:
        t1 = time.perf_counter()
        pending.append(loop.submit(problem))
        kick_s.append(time.perf_counter() - t1)
        while len(pending) >= SERVING["depth"]:
            plans.append(pending.popleft().result())
    while pending:
        plans.append(pending.popleft().result())
    ring_ms = (time.perf_counter() - t0) * 1e3 / len(problems)
    launches = launch_counts()
    require_launches(launches, ["ffd_scan", "cost_sum"], "serving path")
    st = loop.stats()
    n = 2 * len(problems)
    if (st["ring_windows"], st["classic_windows"], st["backpressured"]) \
            != (n, 0, 0):
        raise AssertionError(f"serving: not every window rode the ring: "
                             f"{st}")
    violations = ring_state_violations(loop, catalog)
    if violations:
        raise AssertionError(f"serving ring state: {violations}")
    classic_s = []
    first = len(problems)
    for k, (problem, plan, cplan) in enumerate(zip(problems, plans, cold)):
        t1 = time.perf_counter()
        classic = off.solve_encoded(problem)
        classic_s.append(time.perf_counter() - t1)
        plans_equal(f"serving window {k} (warm)", plan, classic)
        plans_equal(f"serving window {k} (cold)", cplan, classic)
        prep = off._prepare(problem)
        raw = off.dispatch_packed(prep).cpu().numpy()
        for seq in (k, first + k):
            words_equal(f"serving window {k} slot {seq}",
                        slots[seq].host.numpy(), raw, prep.N + prep.G_pad)
    modes = [slots[s].mode for s in sorted(slots)]
    parity = raw_parity_violations(seeds=8, device=dev) \
        + plan_parity_violations(seeds=8, device=dev)
    if parity:
        raise AssertionError(f"serving parity checks: {parity[:3]}")
    out = {"kick_p50_ms": p50_ms(kick_s), "ring_p50_ms": ring_ms,
           "classic_p50_ms": p50_ms(classic_s),
           "overlap_fraction": loop.overlap_fraction, "modes": modes,
           "kick_ms": [x * 1e3 for x in kick_s],
           "classic_ms": [x * 1e3 for x in classic_s], "stats": st,
           "launches": launches}
    say(f"serving path: {len(problems)} windows of {SERVING['seed']}'s "
        f"10k-pod churn, a cold and a warm pass at depth {SERVING['depth']}:"
        f" {st['ring_windows']} ring windows, 0 classic, 0 backpressured, "
        f"ring state clean, every plan equal to the classic plan, every raw "
        f"ring result equal to the classic raw result word for word; modes "
        f"{modes}; the port's 8-seed raw and plan parity checks clean; "
        f"launches {launches}")
    say(f"timing [{card}]: serving warm pass: kick p50 "
        f"{out['kick_p50_ms']:.4f} ms, amortized ring p50 {ring_ms:.4f} ms "
        f"per window, classic p50 {out['classic_p50_ms']:.4f} ms, overlap "
        f"fraction {loop.overlap_fraction:.4f}")
    return out


def phase_fleet_resident(dev, fleet: dict) -> dict:
    """(k) The fleet with ``resident_buf``: window 0 rebuilds, window 1
    (the same window) is a hit, window 2 (one cluster churned) a delta;
    each equal to the fleet without the buffer."""
    import copy

    stacked, N = fleet["stacked"], fleet["N"]
    kw = dict(num_nodes=N, device=dev, device_catalog=fleet["dev_catalog"])
    churned = copy.deepcopy(stacked)
    churned.group_count[3, 0] = max(0, int(churned.group_count[3, 0]) - 3)
    buf = ResidentBuffer("fleet")
    reset_launches()
    runs = []
    for label, problem in (("rebuild", stacked), ("hit", stacked),
                           ("delta", churned)):
        t0 = time.perf_counter()
        got = fleet_solve_packed(problem, resident_buf=buf, **kw)
        runs.append((label, time.perf_counter() - t0, problem, got))
    launches = launch_counts()
    require_launches(launches, ["ffd_scan_fleet", "cost_sum"],
                     "fleet resident path")
    for label, _, problem, got in runs:
        want = fleet_solve_packed(problem, **kw)
        for name, a, b in zip(("node_off", "assign", "unplaced", "cost"),
                              got, want):
            if not np.array_equal(a, b):
                raise AssertionError(f"fleet resident {label}: {name} "
                                     f"differs from the plain fleet")
    if buf.stats != {"rebuild": 1, "hit": 1, "delta": 1}:
        raise AssertionError(f"fleet resident ladder {buf.stats}")
    say(f"fleet resident path: rebuild, hit, delta ({buf.stats}) each equal "
        f"to the fleet without the buffer; walls "
        + ", ".join(f"{lb} {s * 1e3:.3f} ms" for lb, s, _, _ in runs)
        + f"; launches {launches}")
    return {"stats": dict(buf.stats), "launches": launches,
            "walls_ms": {lb: s * 1e3 for lb, s, _, _ in runs}}


# -- phase 3 (cost sum) and phase 4 (l-n): the what-if, gang and preempt planes


def node_rows(N: int, C: int, device) -> torch.Tensor:
    """node_off int32 [N] (C = 1) or [C, N] opening node n on offering n:
    the cost word of it over a masked price row is that row's sum."""
    idx = torch.arange(N, dtype=torch.int32, device=device)
    return idx if C == 1 else idx.expand(C, N).contiguous()


def check_masked_sum(label: str, prices: torch.Tensor) -> float:
    """The cost word over a masked price row (every node open on its own
    offering) against the plain order-fixed sum of that row on the same
    card tensor, bit for bit; returns max |diff| (0.0)."""
    C = prices.shape[0] if prices.dim() == 2 else 1
    got = cost_sum.cost_word(node_rows(prices.shape[-1], C, prices.device),
                             prices)
    want = cost_sum.cost_sum_reference(prices)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"cost_word differs from the plain sum of the "
                             f"masked row on {label}: max |diff| "
                             f"{float((got - want).abs().max())}")
    return float((got - want).abs().max()) if got.numel() else 0.0


def phase_cost_sum_checks(dev) -> dict:
    """The cost-word kernel bit for bit against its plain version: C in
    {1, 8, 64}, every N in NODE_BUCKETS and three ragged lengths; masked
    price rows (30-70% of the nodes open, small totals and rows near
    2^24) summed as they lie, then node offerings gathered from one
    price row per problem, one shared row and one row."""
    rng = np.random.RandomState(7)
    cases = 0
    for C in (1, 8, 64):
        for N in NODE_BUCKETS + (33, 1000, 4097):
            for scale in (4.0, 2.0 ** 25 / N):
                prices = (rng.rand(C, N) * scale).astype(np.float32)
                closed = rng.rand(C, N) >= rng.uniform(0.3, 0.7, (C, 1))
                prices[closed] = 0
                x = torch.from_numpy(prices).to(dev)
                check_masked_sum(f"C={C} N={N}", x if C > 1 else x[0])
                cases += 1
    say(f"kernel check cost_word on masked rows: {cases} cases (C in 1, 8, "
        f"64; N in {list(NODE_BUCKETS)} and 33, 1000, 4097; 30-70% open, "
        f"totals small and near 2^24) bit for bit against the plain sum")
    words = 0
    O = 3072
    for C in (1, 8, 64):
        for N in NODE_BUCKETS + (33, 1000, 4097):
            node = rng.randint(0, O, size=(C, N)).astype(np.int32)
            node[rng.rand(C, N) >= rng.uniform(0.3, 0.7, (C, 1))] = -1
            price = torch.from_numpy(
                (rng.rand(C, O) * 2.0 ** 27 / N).astype(np.float32)).to(dev)
            no = torch.from_numpy(node).to(dev)
            for args in ((no, price), (no, price[0]), (no[0], price[0])):
                got = cost_sum.cost_word(*args)
                want = cost_sum.cost_word_reference(*args)
                torch.cuda.synchronize()
                if not torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)):
                    raise AssertionError(
                        f"cost_word differs from its plain version at C={C} "
                        f"N={N}, price {tuple(args[1].shape)}")
                words += 1
    say(f"kernel check cost_word: {words} cases (C in 1, 8, 64; the same "
        f"N; a price row per problem, one shared row, one row; 30-70% "
        f"open, totals past 2^24) bit for bit against the plain version")
    # the short rows (30-32 nodes sum in 8 lanes) and the band whose last
    # level holds 30-32 window sums, prices over six decades so another
    # order of the adds gives another word
    lane_rows = 0
    O = 512
    price = torch.from_numpy((rng.rand(O) * 10.0 ** rng.uniform(
        -3, 3, O)).astype(np.float32)).to(dev)
    for C in (1, 4, 8):
        for N in list(range(1, 65)) + list(range(929, 1025)):
            node = torch.from_numpy(rng.randint(-1, O, size=(C, N)).astype(
                np.int32)).to(dev)
            got = cost_sum.cost_word(node, price)
            want = cost_sum.cost_word_reference(node, price)
            torch.cuda.synchronize()
            if not torch.equal(got.view(torch.int32),
                               want.view(torch.int32)):
                raise AssertionError(f"cost_word differs from its plain "
                                     f"version at C={C} N={N}")
            lane_rows += 1
    say(f"kernel check cost_word on short and lane rows: {lane_rows} cases "
        f"(C in 1, 4, 8; every N in 1-64 and 929-1024; prices over six "
        f"decades) bit for bit against the plain version")
    return {"max_abs_err": 0.0, "cases": cases, "cost_word_cases": words,
            "lane_row_cases": lane_rows}


def kernel_device_ms(fn, kernel: str, reps: int = 50,
                     tries: int = 5) -> float:
    """Mean device time of the one CUDA kernel (name holding ``kernel``)
    that each call of ``fn`` launches, from a ``torch.profiler`` trace of
    ``reps`` calls, each a range on the host, after ``reps`` calls
    outside any range (the trace drops the device records of the first
    launches it sees).  A device record counts only when its launch
    record lies inside a call's range (joined by correlation id, as
    ``profile_spans`` does; a record the trace repeats counts once), and
    every call must have exactly one: a trace that falls short is taken
    again, up to ``tries`` times; then the call raises, naming the calls
    without a record.  Back-to-back CUDA events time a tiny kernel's
    host issue instead; this reads the kernel alone."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    tag = f"{kernel}_call"
    fn()
    why = ""
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            for _ in range(reps):
                with record_function(tag):
                    fn()
            torch.cuda.synchronize()
        events = prof.events()
        ranges = sorted((e.time_range.start, e.time_range.end)
                        for e in events
                        if e.name == tag and e.device_type == DeviceType.CPU)
        call_of = {}                    # launch correlation id -> call
        for e in events:
            if e.device_type == DeviceType.CPU and _is_launch(e):
                for i, (lo, hi) in enumerate(ranges):
                    if lo <= e.time_range.start <= hi:
                        call_of[e.id] = i
        kernels = {e.id: e for e in events
                   if e.device_type == DeviceType.CUDA and kernel in e.name
                   and e.id in call_of}
        calls = sorted(call_of[i] for i in kernels)
        if len(ranges) == reps and calls == list(range(reps)):
            return sum(e.time_range.end - e.time_range.start
                       for e in kernels.values()) / reps / 1e3
        more = sorted({c for c in calls if calls.count(c) > 1})
        why = (f"{len(ranges)} call ranges; {len(kernels)} {kernel} records "
               f"joined to a launch inside them; calls without one: "
               f"{sorted(set(range(len(ranges))) - set(calls))}; calls "
               f"with more: {more}")
    raise AssertionError(f"{kernel}: device time not read from "
                         f"torch.profiler in {tries} traces of {reps} "
                         f"calls: {why}")


def cost_word_bound_ms(node_off: torch.Tensor, off_price: torch.Tensor
                       ) -> tuple[float, str, int, int]:
    """The cost word's least time on the card for this call's data: the
    C x N node offerings read once, each price word an open node needs
    read once (the distinct open offerings of each price row; of the one
    shared row when the rows share it), C words written; against the
    C x N adds of the windows at the float32 scalar rate."""
    C = 1 if node_off.dim() == 1 else node_off.shape[0]
    N, O = node_off.shape[-1], off_price.shape[-1]
    rows = node_off.reshape(C, N).long()
    is_open = rows >= 0
    off = rows.clamp(max=O - 1)
    if off_price.dim() == 2:
        off = off + O * torch.arange(C, device=off.device)[:, None]
    prices = int(torch.unique(off[is_open]).numel())
    nbytes = 4 * (C * N + prices + C)
    adds = C * N
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = adds / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, adds


def cost_sum_timing(label: str, node_off: torch.Tensor,
                    off_price: torch.Tensor, card: str) -> dict:
    """The cost word of ``node_off`` [N] or [C, N] over ``off_price``:
    ``cost_word`` (one fused launch) bit for bit against its plain
    version and against the plain sum of the masked row; then, back to
    back (the wrapper's host issue; medians of 5 rounds taken in turns)
    ``cost_word``, ``torch.sum`` on the premasked row (the same sum in
    another order) and the chain the paths ran before this kernel took
    the gather in (clamp, gather, ``where``, then one order-fixed sum
    launch over the masked row); the device time alone (profiler), the
    plain version, the bound, and the device kernels per call of
    ``cost_word`` (exact) and of the chain."""
    prices = cost_sum.masked_prices(node_off, off_price)
    err = check_masked_sum(label, prices)
    word = cost_sum.cost_word(node_off, off_price)
    plain = cost_sum.cost_word_reference(node_off, off_price)
    torch.cuda.synchronize()
    if not torch.equal(word.view(torch.int32), plain.view(torch.int32)):
        raise AssertionError(f"cost_word differs from its plain version on "
                             f"{label}")
    C = 1 if node_off.dim() == 1 else node_off.shape[0]
    N = node_off.shape[-1]
    every = node_rows(N, C, node_off.device)
    call = lambda: cost_sum.cost_word(node_off, off_price)  # noqa: E731
    chain = lambda: cost_sum.cost_word(  # noqa: E731
        every, cost_sum.masked_prices(node_off, off_price))
    paired = paired_ms({"cost_word": call,
                        "torch.sum": lambda: prices.sum(dim=-1),
                        "chain": chain}, 100)
    ms, lib_ms, chain_ms = (paired["cost_word"], paired["torch.sum"],
                            paired["chain"])
    device_ms = kernel_device_ms(call, "cost_word_kernel")
    per_call = kernels_per_call(call, "cost_word_call", cost_sum.LAUNCHES,
                                "cost_sum")
    chain_per_call = kernels_per_call(chain, "cost_chain_call",
                                      cost_sum.LAUNCHES, "cost_sum")
    plain_ms = cuda_ms(lambda: cost_sum.cost_word_reference(
        node_off, off_price), 20)
    bound_ms, bound_by, nbytes, adds = cost_word_bound_ms(node_off,
                                                          off_price)
    say(f"timing [{card}]: cost word on {label} [C={C}, N={N}, O="
        f"{off_price.shape[-1]}, {'shared' if off_price.dim() == 1 else 'a'}"
        f" price row{'' if off_price.dim() == 1 else ' per problem'}]: "
        f"cost_word {ms:.4f} ms back to back, device time alone "
        f"{device_ms:.4f} ms, {per_call} device kernels per call; the "
        f"earlier chain (clamp, gather, where, one sum launch) "
        f"{chain_ms:.4f} ms, {chain_per_call} device kernels per call; "
        f"plain version {plain_ms:.4f} ms; torch.sum on the premasked "
        f"row {lib_ms:.4f} ms (cost_word / torch.sum "
        f"x{ms / lib_ms:.3f}); bound {bound_ms:.7f} ms ({bound_by}: "
        f"{nbytes} bytes, {adds} adds); bit-exact against the plain "
        f"version and the plain sum of the masked row")
    return {"ms": ms, "device_ms": device_ms, "kernels_per_call": per_call,
            "chain_ms": chain_ms, "chain_kernels_per_call": chain_per_call,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": adds, "max_abs_err": err, "shape": [C, N]}


def whatif_menu(baseline, catalog, k: int, rng) -> list:
    """``bench.run_whatif``'s menu: the baseline, then arrival waves on 8
    groups alone, with a spot storm, with a zone blackout, with a quota
    clamp."""
    G = baseline.problem.num_groups
    menu = [whatif.Scenario("baseline")]
    storm = whatif_scenario.spot_storm_mask(catalog)
    while len(menu) < k:
        i = len(menu)
        gis = rng.choice(G, size=min(8, G), replace=False)
        wave = whatif.ArrivalWave(tuple(
            (int(g), int(rng.randint(1, 48))) for g in sorted(gis)))
        kind = i % 4
        if kind == 0:
            perts: tuple = (wave,)
        elif kind == 1:
            perts = (wave, storm)
        elif kind == 2:
            zone = catalog.zones[int(rng.randint(len(catalog.zones)))]
            perts = (wave, whatif_scenario.zone_blackout_mask(catalog, zone))
        else:
            perts = (wave, whatif_scenario.quota_clamp(
                baseline, int(rng.randint(2, 8))))
        menu.append(whatif.Scenario(f"s{i}", perts))
    return menu[:k]


def stacked_scan_tensors(dev, baseline, menu, ct):
    """(metas, compats) of a lowered menu on the card: the stacked delta
    apply and the unpack of every row, as the stacked solve forms them."""
    st = whatif.lower_scenarios(baseline, menu)
    bufs = whatif_kernels.apply_deltas(
        torch.from_numpy(baseline.packed).to(dev),
        torch.from_numpy(st.didx).to(dev), torch.from_numpy(st.dval).to(dev))
    G, O, U = baseline.G_pad, baseline.O_pad, baseline.U_pad
    metas, compats, _ = torch.func.vmap(
        lambda p: tp.unpack_problem(p, ct[0], G, O, U))(bufs)
    return metas.contiguous(), compats.contiguous()


def phase_whatif(dev, card: str) -> dict:
    """(l) ``bench.run_whatif``: 10k pods x 500 types, K = 64 scenarios
    in one stacked plan on the card."""
    pods, catalog = workload.build_workload(WHATIF["pods"], WHATIF["types"])
    t0 = time.perf_counter()
    baseline = whatif.build_baseline(pods, catalog)
    build_s = time.perf_counter() - t0
    menu = whatif_menu(baseline, catalog, WHATIF["K"],
                       np.random.RandomState(WHATIF["menu_seed"]))
    K = len(menu)
    planner = whatif.WhatIfPlanner(max_k=K, device=dev)
    reset_launches()
    t0 = time.perf_counter()
    plan = planner.plan(baseline, menu)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    if {k: v for k, v in launches.items() if v} != \
            {"ffd_scan_fleet": 1, "cost_sum": 1} or plan.dispatches != 1:
        raise AssertionError(f"the stacked what-if plan of {K} scenarios "
                             f"took {plan.dispatches} solves and launched "
                             f"{launches}, want one ffd_scan_fleet and one "
                             f"cost_sum")
    G, N = baseline.G_pad, plan.N
    if plan.outcomes[0].unplaced:
        raise AssertionError(f"what-if baseline scenario left "
                             f"{plan.outcomes[0].unplaced} pods unplaced")

    # every scenario's words: a fresh single-window solve of its
    # perturbed buffer on the card (the cost word included), and the
    # numpy oracle up to the cost word
    ct = planner._catalog_tensors(catalog, baseline.O_pad)
    bufs = [whatif_scenario.perturbed_buffer(baseline, s) for s in menu]
    kw = dict(G=G, O=baseline.O_pad, U=baseline.U_pad, N=N,
              compact=plan.K_coo, coo16=plan.coo16)

    def sequential():
        return [tp.solve_packed_torch(torch.from_numpy(b).to(dev), *ct,
                                      **kw).cpu().numpy() for b in bufs]

    for k, single in enumerate(sequential()):
        words_equal(f"what-if scenario {menu[k].name}", plan.raw[k], single,
                    N + G)
    t0 = time.perf_counter()
    host = planner.plan_host(baseline, menu)
    host_s = time.perf_counter() - t0
    for k in range(K):
        if not whatif_oracle.words_equal_except_cost(plan.raw[k],
                                                     host.raw[k], G, N):
            raise AssertionError(f"what-if scenario {menu[k].name}: the "
                                 f"card's words differ from the numpy "
                                 f"oracle's")
    violations = whatif.validate_whatif(plan)
    if violations:
        raise AssertionError(f"validate_whatif: {violations[:3]}")

    # the fleet kernel at the stacked shapes: C = K and C = WHATIF_MAX_K
    # (the largest chunk), against its plain version on the card
    scan = {}
    alloc, _, rank = ct
    for C in (K, whatif.WHATIF_MAX_K):
        big = menu if C == K else whatif_menu(
            baseline, catalog, C, np.random.RandomState(WHATIF["menu_seed"]))
        metas, compats = stacked_scan_tensors(dev, baseline, big, ct)
        allocs, ranks = alloc.expand(C, *alloc.shape), rank.expand(C, -1)
        got = ffd_kernel.ffd_scan_fleet(metas, compats, allocs, ranks, N)
        want = ffd_kernel.ffd_scan_fleet_reference(metas, compats, allocs,
                                                   ranks, N)
        torch.cuda.synchronize()
        if max_abs_err(got, want):
            first_diff(f"ffd_scan_fleet what-if C={C}", got, want)
        scan[C] = cuda_ms(lambda: ffd_kernel.ffd_scan_fleet(
            metas, compats, allocs, ranks, N), 20)
    # the cost sum on the stacked plan's own masked prices
    metas, compats = stacked_scan_tensors(dev, baseline, menu, ct)
    node_off, assign, _ = ffd_kernel.ffd_scan_fleet(
        metas, compats, alloc.expand(K, *alloc.shape), rank.expand(K, -1), N)
    node_off = torch.func.vmap(lambda m, c, no, a: tp.finish_solve(
        m, c, no, a, ct[0], ct[2], True))(metas, compats, node_off, assign)
    cs = cost_sum_timing("the stacked what-if plan", node_off, ct[1], card)

    walls = []
    for _ in range(WHATIF["iters"]):
        t0 = time.perf_counter()
        planner.plan(baseline, menu)
        walls.append(time.perf_counter() - t0)
    sequential()
    t0 = time.perf_counter()
    sequential()
    seq_s = time.perf_counter() - t0
    stacked_ms = p50_ms(walls)
    outcomes = plan.outcomes
    say(f"what-if path: {K} scenarios of {WHATIF['pods']} pods x "
        f"{WHATIF['types']} types (G={G} O={baseline.O_pad} "
        f"U={baseline.U_pad} N={N}, delta rung {plan.stacked.D}), one "
        f"stacked plan: launches {launches}; every scenario's words equal "
        f"to a single-window solve_packed_torch of its perturbed buffer on "
        f"the card (cost words included) and to the numpy oracle up to "
        f"the cost word; validate_whatif clean; baseline {outcomes[0].pods} "
        f"pods all placed; placed min/max over scenarios "
        f"{min(o.placed for o in outcomes)}/{max(o.placed for o in outcomes)}"
        f"; ffd_scan_fleet exact against its plain version at C={K} and "
        f"C={whatif.WHATIF_MAX_K}")
    say(f"timing [{card}]: what-if stacked plan warm p50 {stacked_ms:.4f} "
        f"ms (cold {cold_s * 1e3:.3f} ms, baseline build {build_s:.3f} s); "
        f"{K} sequential single-window solves {seq_s * 1e3:.3f} ms; "
        f"plan_host (numpy oracle) {host_s * 1e3:.3f} ms; ffd_scan_fleet at "
        f"C={K} {scan[K]:.4f} ms, at C={whatif.WHATIF_MAX_K} "
        f"{scan[whatif.WHATIF_MAX_K]:.4f} ms")
    return {"launches": launches, "K": K, "N": N, "G": G,
            "O": baseline.O_pad, "U": baseline.U_pad, "D": plan.stacked.D,
            "stacked_p50_ms": stacked_ms, "walls_ms": [w * 1e3 for w in walls],
            "cold_ms": cold_s * 1e3, "sequential_ms": seq_s * 1e3,
            "plan_host_ms": host_s * 1e3, "baseline_build_s": build_s,
            "ffd_scan_fleet_ms": {str(c): v for c, v in scan.items()},
            "cost_sum": cs,
            "outcomes": [o.to_dict() for o in outcomes[:4]]}


def gang_pods(cfg: dict) -> list:
    """``bench.run_gang``'s gangs: ``gangs`` jobs of ``members`` replicas,
    slice shapes 4x4 / 2x2x2 / 2x2 / none."""
    rng = np.random.RandomState(cfg["seed"])
    shapes = ["4x4", "2x2x2", "2x2", ""]
    pods = []
    for g in range(cfg["gangs"]):
        shape = shapes[int(rng.randint(len(shapes)))]
        gang = PodGroup(name=f"job-{g:03d}", min_member=cfg["members"],
                        slice_shape=shape or None)
        for m in range(cfg["members"]):
            pods.append(pod_api.PodSpec(
                f"job-{g:03d}-{m}", requests=pod_api.ResourceRequests(
                    int(rng.randint(100, 500)), int(rng.randint(256, 1024)),
                    0, 1), gang=gang))
    return pods


def gang_fingerprint(plan):
    return (plan.placements, plan.unplaced, plan.total_cost_per_hour,
            [(n.offering_index, [(a.gang, a.placement_mask, a.pod_names,
                                  a.rank_chips, a.max_hop)
                                 for a in n.assignments])
             for n in plan.nodes])


def timed_p50(fn, iters: int) -> float:
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        walls.append(time.perf_counter() - t0)
    return p50_ms(walls)


def phase_gang(dev, card: str) -> dict:
    """(m) ``bench.run_gang``: 64 gangs x 16 members over 500 accelerator
    types, the torch grid on the card against the numpy grid."""
    catalog = workload.build_catalog(GANG["types"], workload.ACCEL_FAMILIES)
    pods = gang_pods(GANG)
    problem = encode_gangs(pods, catalog)
    on = GangPlanner(GangOptions(use_device="on"), device=dev)
    reset_launches()
    t0 = time.perf_counter()
    plan = on.plan(problem)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    require_no_launches(launches, "gang path")
    steps = on.device_steps
    off = GangPlanner(GangOptions(use_device="off"), device="cpu")
    ref = off.plan(problem)
    if steps < 1 or gang_fingerprint(plan) != gang_fingerprint(ref):
        raise AssertionError(f"gang plan on the card ({steps} torch grid "
                             f"steps) differs from the numpy grid's")
    errors = validate_gang_plan(plan, pods, catalog)
    if errors:
        raise AssertionError(f"validate_gang_plan: {errors[:3]}")
    placed = {pn for n in plan.nodes for pn in n.pod_names}
    partial = sum(1 for g in problem.gangs
                  if 0 < sum(pn in placed for pn in g.pod_names)
                  < len(g.pod_names))
    if partial:
        raise AssertionError(f"gang plan has {partial} partial gangs")
    on_ms = timed_p50(lambda: on.plan(problem), GANG["iters"])
    off_ms = timed_p50(lambda: off.plan(problem), GANG["iters"])
    say(f"gang path: {problem.num_gangs} gangs x {GANG['members']} members "
        f"over {GANG['types']} accelerator types: {len(plan.placed_gangs)} "
        f"placed on {len(plan.nodes)} nodes, {len(plan.unplaced_gangs)} "
        f"unplaced, 0 partial; {steps} torch grid steps on the card, plan "
        f"equal to the numpy grid's; validate_gang_plan clean; launches "
        f"{launches} (the grid is PyTorch ops)")
    say(f"timing [{card}]: gang plan warm p50 {on_ms:.4f} ms on the card "
        f"(cold {cold_s * 1e3:.3f} ms), numpy grid {off_ms:.4f} ms")
    return {"launches": launches, "gangs": problem.num_gangs,
            "placed_gangs": len(plan.placed_gangs), "nodes": len(plan.nodes),
            "device_steps": steps, "partial": partial,
            "card_p50_ms": on_ms, "numpy_p50_ms": off_ms,
            "cold_ms": cold_s * 1e3}


def preempt_cluster(cfg: dict):
    """``bench.run_preempt``'s overload: ``claims`` nodes, each ~96% full
    with three low-priority victims, and ``pending`` pods of mixed sizes
    and priorities.  Returns (catalog, cluster, pending pods)."""
    catalog = workload.build_catalog(cfg["types"])
    rng = np.random.RandomState(cfg["seed"])
    alloc = catalog.type_alloc
    hostable = [t for t in range(catalog.num_types)
                if alloc[t, 0] >= 2000 and alloc[t, 1] >= 4096]
    cluster = ClusterState()
    for i in range(cfg["claims"]):
        t = hostable[rng.randint(len(hostable))]
        cluster.add_nodeclaim(NodeClaim(
            name=f"pc{i}", instance_type=catalog.type_names[t],
            zone=catalog.zones[rng.randint(len(catalog.zones))],
            node_name=f"node-pc{i}", launched=True))
        for j in range(3):
            name = f"v{i}-{j}"
            cluster.add_pod(pod_api.PodSpec(
                name, requests=pod_api.ResourceRequests(
                    int(alloc[t, 0] * 0.32), int(alloc[t, 1] * 0.32), 0, 1),
                priority=int(rng.choice([0, 0, 0, 100]))))
            cluster.bind_pod(f"default/{name}", f"node-pc{i}")
    return catalog, cluster, preempt_pending(rng, cfg["pending"])


def preempt_pending(rng, count: int) -> list:
    """``bench.run_preempt``'s pending pods: mixed sizes and priorities."""
    sizes = [(500, 1024), (1000, 2048), (2000, 4096)]
    prios = [0, 0, 100, 100, 100, 1000]
    pending = []
    for k in range(count):
        cpu, mem = sizes[rng.randint(len(sizes))]
        pending.append(pod_api.PodSpec(
            f"p{k}", requests=pod_api.ResourceRequests(cpu, mem, 0, 1),
            priority=prios[rng.randint(len(prios))]))
    return pending


def preempt_fingerprint(plan):
    return ([(e.claim_name, e.pod_key, e.victim_priority,
              e.beneficiary_priority) for e in plan.evictions],
            plan.placements, plan.unplaced, plan.eviction_weight)


def phase_preempt(dev, card: str) -> dict:
    """(n) ``bench.run_preempt``: 10k pending pods against 2000 full
    claims, the torch fit grid on the card against the numpy grid."""
    catalog, cluster, pending = preempt_cluster(PREEMPT)
    problem = encode_mod.encode(pending, catalog)
    t0 = time.perf_counter()
    victims = encode_victims(cluster, catalog)
    victims_ms = (time.perf_counter() - t0) * 1e3
    compat = group_node_compat(problem, victims)
    budget = PREEMPT["claims"] * 3
    on = PreemptionPlanner(PlannerOptions(use_device="on",
                                          max_evictions=budget), device=dev)
    reset_launches()
    t0 = time.perf_counter()
    plan = on.plan(problem, victims, compat)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    require_no_launches(launches, "preemption path")
    steps = on.device_steps
    off = PreemptionPlanner(PlannerOptions(use_device="off",
                                           max_evictions=budget),
                            device="cpu")
    ref = off.plan(problem, victims, compat)
    if steps < 1 or preempt_fingerprint(plan) != preempt_fingerprint(ref):
        raise AssertionError(f"preemption plan on the card ({steps} torch "
                             f"grid steps) differs from the numpy grid's")
    errors = validate_preemption_plan(plan, pending, cluster, catalog)
    if errors:
        raise AssertionError(f"validate_preemption_plan: {errors[:3]}")
    if not plan.evictions or not plan.placements:
        raise AssertionError("the overload window evicted or placed nothing")
    on_ms = timed_p50(lambda: on.plan(problem, victims, compat),
                      PREEMPT["iters"])
    off_ms = timed_p50(lambda: off.plan(problem, victims, compat),
                       PREEMPT["iters"])
    say(f"preemption path: {PREEMPT['pending']} pending x "
        f"{victims.num_nodes} claims ({victims.num_victims} victims, "
        f"{problem.num_groups} groups): {plan.eviction_count} evictions, "
        f"{plan.placed_count} placed, {len(plan.unplaced)} unplaced; "
        f"{steps} torch grid steps on the card, plan equal to the numpy "
        f"grid's; validate_preemption_plan clean; launches {launches} "
        f"(the grid is PyTorch ops)")
    say(f"timing [{card}]: preemption plan warm p50 {on_ms:.4f} ms on the "
        f"card (cold {cold_s * 1e3:.3f} ms), numpy grid {off_ms:.4f} ms; "
        f"encode_victims {victims_ms:.3f} ms")
    return {"launches": launches, "evictions": plan.eviction_count,
            "placed": plan.placed_count, "unplaced": len(plan.unplaced),
            "device_steps": steps, "card_p50_ms": on_ms,
            "numpy_p50_ms": off_ms, "cold_ms": cold_s * 1e3,
            "encode_victims_ms": victims_ms}


# -- phase 4 (o-r): the sharded service, its serving loop, the repack plane --


def keep_kicks(svc) -> list:
    """Keep every kick of a sharded service (its window and its pinned
    result buffer, read after the fetch)."""
    kicks = []
    kick = svc._kick_window

    def keep(*args, **kwargs):
        out = kick(*args, **kwargs)
        kicks.append(out)
        return out

    svc._kick_window = keep
    return kicks


def single_rows(window, catalog_t, device) -> list:
    """``solve_packed_torch`` of each shard's buffer on ``device``."""
    kw = dict(G=window.G_pad, O=window.O_pad, U=window.U_pad, N=window.N)
    ct = [t.to(device) for t in catalog_t]
    return [tp.solve_packed_torch(torch.from_numpy(window.stacked[s])
                                  .to(device), *ct, **kw).cpu().numpy()
            for s in range(window.num_shards)]


def rows_equal_singles(label: str, kick, catalog_t, device) -> None:
    """A kicked window's raw rows, fetched, against the single solves of
    its shards' buffers on ``device`` (the cost words included)."""
    w = kick.window
    rows = kick.host.numpy()
    for s, single in enumerate(single_rows(w, catalog_t, device)):
        words_equal(f"{label} shard {s}", rows[s], single, w.N + w.G_pad)


def shard_scan_check(dev, label: str, window, ct, card: str) -> dict:
    """The fleet kernel on a sharded window's own unpacked tensors (C =
    S, the catalog expanded with stride 0), exact against its plain
    version on the card, with both timed and the bound."""
    alloc, _, rank = ct
    S, N = window.num_shards, window.N
    metas, compats, _ = torch.func.vmap(lambda p: tp.unpack_problem(
        p, alloc, window.G_pad, window.O_pad, window.U_pad))(
        torch.from_numpy(window.stacked).to(dev))
    metas, compats = metas.contiguous(), compats.contiguous()
    allocs, ranks = alloc.expand(S, *alloc.shape), rank.expand(S, -1)
    got = ffd_kernel.ffd_scan_fleet(metas, compats, allocs, ranks, N)
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    want = ffd_kernel.ffd_scan_fleet_reference(metas, compats, allocs,
                                               ranks, N)
    stop.record()
    stop.synchronize()
    plain_ms = start.elapsed_time(stop)
    err = max_abs_err(got, want)
    if err:
        first_diff(f"ffd_scan_fleet {label}", got, want)
    ms = cuda_ms(lambda: ffd_kernel.ffd_scan_fleet(metas, compats, allocs,
                                                   ranks, N), 10)
    bound_ms, bound_by, nbytes, ops = scan_bound_ms(
        metas, compats, allocs, ranks, N, got[1].cpu().numpy(),
        got[0].cpu().numpy())
    G, O = compats.shape[1:]
    say(f"kernel check ffd_scan_fleet on the {label} (C={S} stride 0, "
        f"G={G} O={O} N={N}): exact against its plain version; timing "
        f"[{card}]: kernel {ms:.4f} ms ({ms / G * 1e3:.4f} us per group "
        f"step), plain PyTorch version {plain_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}: {nbytes} bytes, {ops} scalar "
        f"ops)")
    return {"C": S, "G": G, "O": O, "N": N, "ms": ms, "plain_ms": plain_ms,
            "us_per_step": ms / G * 1e3, "bound_ms": bound_ms,
            "bound_by": bound_by, "max_abs_err": err}


def require_window_launches(launches: dict, label: str,
                            windows: int = 1) -> None:
    """Exactly one ``ffd_scan_fleet`` and one ``cost_sum`` launch per
    sharded window, and no other kernel."""
    got = {k: v for k, v in launches.items() if v}
    if got != {"ffd_scan_fleet": windows, "cost_sum": windows}:
        raise AssertionError(f"{label}: {windows} sharded window(s) "
                             f"launched {got}, want one ffd_scan_fleet and "
                             f"one cost_sum each")


def phase_sharded(dev, card: str, pods, catalog) -> dict:
    """(o) The headline window through ``make_solver(SolverOptions(
    sharded=2))``: one ``ffd_scan_fleet`` and one ``cost_sum`` launch per
    window, each shard's raw row equal to the plain CPU solve of its
    buffer, the plan equal to the CPU sharded solver's and clean; warm
    p50 of 20 windows beside ``TorchSolver``'s; then the same window
    through ``ShardedSolveService(4)``."""
    from karpenter_tpu_torch import make_solver
    from karpenter_tpu_torch.sharded.service import ShardedSolveService
    from karpenter_tpu_torch.sharded.solver import ShardedSolver

    S = SHARDED["shards"]
    solver = make_solver(SolverOptions(sharded=S), device=dev)
    if type(solver.primary) is not ShardedSolver \
            or solver.service.num_shards != S:
        raise AssertionError(f"make_solver(sharded={S}) gave {solver!r}")
    # the service behind the plane's degraded wrapper
    kicks = keep_kicks(solver.service.primary)
    request = SolveRequest(pods, catalog)
    reset_launches()
    t0 = time.perf_counter()
    plan = solver.solve(request)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    require_window_launches(launches, "sharded window")
    window = kicks[-1].window
    cpu_ct = [t.cpu() for t in solver.service._catalog_tensors(
        catalog, window.O_pad)]
    rows_equal_singles("sharded window", kicks[-1], cpu_ct, "cpu")
    plans_equal("sharded window", plan, ShardedSolver(
        S, device="cpu").solve(request))
    scan = shard_scan_check(dev, "sharded headline window", window,
                            solver.service._catalog_tensors(
                                catalog, window.O_pad), card)
    clean_and_placed("sharded window", plan, pods, catalog,
                     placed=plan.placed_count)
    walls = []
    for _ in range(SHARDED["warm"]):
        reset_launches()
        t0 = time.perf_counter()
        solver.solve(request)
        walls.append(time.perf_counter() - t0)
        require_window_launches(launch_counts(), "warm sharded window")
    mode = solver.last_stats["resident_mode"]
    if mode != "hit":
        raise AssertionError(f"warm sharded window took mode {mode!r}")
    single = TorchSolver(device=dev)
    single.solve(request)
    torch_walls = warm_walls(single, request, SHARDED["warm"])

    wide = ShardedSolveService(SHARDED["wide"], device=dev)
    wkicks = keep_kicks(wide)
    reset_launches()
    t0 = time.perf_counter()
    wplan = wide.solve_window(catalog, pods=pods)
    wide_cold_s = time.perf_counter() - t0
    wl = launch_counts()
    require_window_launches(wl, f"ShardedSolveService({SHARDED['wide']})")
    rows_equal_singles(f"{SHARDED['wide']}-shard window", wkicks[-1],
                       cpu_ct, "cpu")
    merged = wplan.merged()
    clean_and_placed(f"{SHARDED['wide']}-shard window", merged, pods,
                     catalog, placed=merged.placed_count)
    wide_walls = []
    for _ in range(SHARDED["warm"] // 2):
        t0 = time.perf_counter()
        wide.solve_window(catalog, pods=pods)
        wide_walls.append(time.perf_counter() - t0)
    out = {"launches": {k: launches.get(k, 0) + wl.get(k, 0)
                        for k in set(launches) | set(wl)},
           "p50_ms": p50_ms(walls), "torch_p50_ms": p50_ms(torch_walls),
           "cold_ms": cold_s * 1e3, "walls_ms": [x * 1e3 for x in walls],
           "shapes": window.shapes, "shard_pods": window.shard_pods,
           "nodes": len(plan.nodes), "placed": plan.placed_count,
           "cost": plan.total_cost_per_hour, "scan": scan,
           "wide": {"shards": SHARDED["wide"],
                    "shapes": wkicks[-1].window.shapes,
                    "shard_pods": wkicks[-1].window.shard_pods,
                    "cold_ms": wide_cold_s * 1e3,
                    "p50_ms": p50_ms(wide_walls),
                    "placed": merged.placed_count}}
    say(f"sharded window: the headline through make_solver(sharded={S}) "
        f"(G, O, U, N = {window.shapes}, pods per shard "
        f"{window.shard_pods}): {len(plan.nodes)} nodes, "
        f"{plan.placed_count} placed, cost {plan.total_cost_per_hour:.4f} "
        f"$/h; one ffd_scan_fleet and one cost_sum per window over "
        f"{1 + SHARDED['warm']} windows; every shard row equal to the plain "
        f"CPU solve of its buffer word for word; plan equal to the CPU "
        f"sharded solver's and clean; ShardedSolveService({SHARDED['wide']}"
        f"): pods per shard {out['wide']['shard_pods']}, rows equal, "
        f"{merged.placed_count} placed, clean")
    say(f"timing [{card}]: sharded window warm p50 {out['p50_ms']:.4f} ms "
        f"(cold {out['cold_ms']:.3f} ms) against TorchSolver "
        f"{out['torch_p50_ms']:.4f} ms on the same window; "
        f"{SHARDED['wide']} shards {out['wide']['p50_ms']:.4f} ms (cold "
        f"{out['wide']['cold_ms']:.3f} ms)")
    return out


def sharded_stream_pods(rng, n: int, tag: str) -> list:
    """``bench.py::run_sharded``'s pods: 100-900m CPU, 256-2048 Mi."""
    return [pod_api.PodSpec(f"{tag}{rng.randint(1 << 30)}-{i}",
                            requests=pod_api.ResourceRequests(
                                int(rng.randint(100, 900)),
                                int(rng.randint(256, 2048)), 0, 1))
            for i in range(n)]


def sharded_churn(seed: int) -> list:
    """One seed's churn: ``rounds`` windows of SHARDED["pods"] pods, each
    round dropping 1-15 pods and adding 8-24."""
    rng = np.random.RandomState(seed)
    pods = sharded_stream_pods(rng, SHARDED["pods"], "s")
    seqs = []
    for _ in range(SHARDED["rounds"]):
        seqs.append(list(pods))
        pods = pods[int(rng.randint(1, 16)):] \
            + sharded_stream_pods(rng, int(rng.randint(8, 24)), "s")
    return seqs


def phase_sharded_churn(dev, card: str, catalog) -> dict:
    """(p) ``bench.py::run_sharded`` at 10k pods x 500 types: 4 seeds of
    4 churn rounds through one ``ShardedSolveService(2)`` each, every
    window's rows equal to single solves of its shards' buffers on the
    card, its resident mode and delta words; the hash-skewed stream's
    decisions against ``rebalance_oracle``; aggregate and single-shard
    pods/s."""
    from karpenter_tpu_torch.resident.kernels import new_state
    from karpenter_tpu_torch.sharded.kernels import (
        rebalance_oracle, solve_shards,
    )
    from karpenter_tpu_torch.sharded.router import craft_hot_requests
    from karpenter_tpu_torch.sharded.service import ShardedSolveService
    from karpenter_tpu_torch.sharded.validate import (
        partition_violations, rebalance_violations, state_violations,
    )

    S = SHARDED["shards"]
    launches: dict = {}
    modes, words, walls, shapes = [], [], [], set()
    windows = 0
    for k in range(SHARDED["seeds"]):
        svc = ShardedSolveService(S, device=dev)
        kicks = keep_kicks(svc)
        for r, pods in enumerate(sharded_churn(SHARDED["seed0"] + k)):
            reset_launches()
            t0 = time.perf_counter()
            svc.solve_window(catalog, pods=pods)
            walls.append(time.perf_counter() - t0)
            got = launch_counts()
            require_window_launches(got, f"churn seed {k} round {r}")
            for name, n in got.items():
                launches[name] = launches.get(name, 0) + n
            kick = kicks[-1]
            rows_equal_singles(f"churn seed {k} round {r}", kick,
                               svc._catalog_tensors(catalog,
                                                    kick.window.O_pad), dev)
            modes.append(kick.delta.mode)
            words.append(kick.delta.words)
            shapes.add(kick.window.shapes)
            errors = state_violations(svc, pods, catalog) \
                + partition_violations(svc, pods)
            if errors:
                raise AssertionError(f"churn seed {k} round {r}: "
                                     f"{errors[:3]}")
            windows += 1
    if "rebuild" not in modes or "delta" not in modes:
        raise AssertionError(f"sharded churn modes {modes}")

    # the hash-skewed stream: must migrate, every decision the oracle's
    rng = np.random.RandomState(SHARDED["hot_seed"])
    skewed = [pod_api.PodSpec(f"hot{made}-{i}",
                              requests=pod_api.ResourceRequests(
                                  hcpu, hmem, 0, 1))
              for made, (hcpu, hmem) in enumerate(
                  craft_hot_requests(S, 0, count=SHARDED["hot"]))
              for i in range(int(rng.randint(2, 6)))]
    hot = ShardedSolveService(S, device=dev)
    hot.admit(skewed)
    migrations, decisions = 0, []
    for _ in range(SHARDED["hot_windows"]):
        hot.solve_window(catalog)
        dec = hot.rebalance()
        bad = rebalance_violations(hot, dec)
        if bad or tuple(int(v) for v in dec.tile[0, :4]) \
                != rebalance_oracle(dec.pressure):
            raise AssertionError(f"rebalance decision: {bad}")
        migrations += len(dec.moved_keys)
        decisions.append((dec.donor, dec.receiver, dec.amount, dec.skew,
                          len(dec.moved_keys)))
    if migrations <= 0:
        raise AssertionError("the hash-skewed stream migrated nothing")

    # throughput: the stacked solve of one window against shard 0 alone
    pods = sharded_stream_pods(np.random.RandomState(11), SHARDED["pods"],
                               "t")
    svc = ShardedSolveService(S, device=dev)
    kicks = keep_kicks(svc)
    svc.solve_window(catalog, pods=pods)
    w = kicks[-1].window
    ct = svc._catalog_tensors(catalog, w.O_pad)
    L = w.stacked.shape[1]
    didx = torch.full((S, 64), L, dtype=torch.int32, device=dev)
    dval = torch.zeros((S, 64), dtype=torch.int32, device=dev)
    kw = dict(G=w.G_pad, O=w.O_pad, U=w.U_pad, N=w.N)
    scan = shard_scan_check(dev, "10k-pod churn window", w, ct, card)

    def agg_once():
        _, out = solve_shards(new_state(w.stacked, dev), didx, dval,
                              *ct, **kw)
        out.cpu()

    def single_once():
        tp.solve_packed_torch(torch.from_numpy(w.stacked[0]).to(dev), *ct,
                              **kw).cpu()

    agg_once()
    single_once()
    agg_s, single_s = [], []
    for _ in range(SHARDED["tput_windows"]):
        t0 = time.perf_counter()
        agg_once()
        agg_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        single_once()
        single_s.append(time.perf_counter() - t0)
    agg_rate = len(pods) / (p50_ms(agg_s) / 1e3)
    single_rate = w.shard_pods[0] / (p50_ms(single_s) / 1e3)
    warm = [x for x, m in zip(walls, modes) if m != "rebuild"]
    out = {"launches": launches, "windows": windows, "modes": modes,
           "delta_words": words, "shapes": sorted(shapes),
           "window_p50_ms": p50_ms(walls),
           "warm_window_p50_ms": p50_ms(warm) if warm else None,
           "migrations": migrations, "decisions": decisions,
           "agg_pods_per_s": agg_rate, "single_pods_per_s": single_rate,
           "linearity": agg_rate / (S * single_rate),
           "agg_p50_ms": p50_ms(agg_s), "single_p50_ms": p50_ms(single_s),
           "tput_shapes": w.shapes, "tput_shard_pods": w.shard_pods,
           "scan": scan}
    say(f"sharded churn: {SHARDED['seeds']} seeds x {SHARDED['rounds']} "
        f"rounds of {SHARDED['pods']} pods x {SHARDED['types']} types "
        f"(shapes {sorted(shapes)}): every window one ffd_scan_fleet and "
        f"one cost_sum, every shard row equal to a single solve of its "
        f"buffer on the card word for word, state and partition checks "
        f"clean; modes {modes}; delta words {words}; hash-skewed stream: "
        f"{migrations} migrations, decisions {decisions}, each equal to "
        f"rebalance_oracle")
    say(f"timing [{card}]: sharded churn window p50 {out['window_p50_ms']:.4f}"
        f" ms (warm {out['warm_window_p50_ms']} ms); stacked solve "
        f"{out['agg_p50_ms']:.4f} ms for {len(pods)} pods = "
        f"{agg_rate:.1f} pods/s, shard 0 alone {out['single_p50_ms']:.4f} "
        f"ms for {w.shard_pods[0]} pods = {single_rate:.1f} pods/s, ratio "
        f"{out['linearity']:.4f} of {S} x single (one card: not gated)")
    return out


class GcCount:
    """Python garbage collections (count and seconds) while it is on."""

    def __init__(self):
        self.n, self.s, self._t0 = 0, 0.0, 0.0

    def _callback(self, phase, info):
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.n += 1
            self.s += time.perf_counter() - self._t0

    def __enter__(self):
        gc.callbacks.append(self._callback)
        return self

    def __exit__(self, *exc):
        gc.callbacks.remove(self._callback)

    def read(self) -> dict:
        return {"collections": self.n, "seconds": self.s}


def host_profile(fn, top: int = 16) -> list:
    """``cProfile`` of ``fn()``: the port's ``top`` functions by
    cumulative seconds, as ``[file:line(function), seconds]``."""
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    rows = sorted(((v[3], f"{k[0].rsplit('karpenter_tpu_torch/', 1)[-1]}:"
                          f"{k[1]}({k[2]})")
                   for k, v in pstats.Stats(prof).stats.items()
                   if "karpenter_tpu_torch" in k[0]), reverse=True)
    return [[name, t] for t, name in rows[:top]]


def phase_sharded_serving(dev, card: str, catalog) -> dict:
    """(q) Seed 0's churn stream through ``ShardedServingLoop(capacity=
    2)``: every plan equal to ``solve_window``'s on a second service, the
    overlap fraction, and the port's sharded parity checks.  Both timed
    passes follow an untimed one over the same windows; each reads the
    wall of every submit, result or window and the garbage collections
    inside it.  Then a ``cProfile`` of one more service's warm windows
    says where the host's time goes."""
    from karpenter_tpu_torch.serving.service import ShardedServingLoop
    from karpenter_tpu_torch.serving.validate import (
        sharded_parity_violations,
    )
    from karpenter_tpu_torch.sharded.service import ShardedSolveService

    S = SHARDED["shards"]
    seqs = sharded_churn(SHARDED["seed0"])
    # one untimed pass first, so that both timed passes read the encode
    # memo and the pods' cached signatures
    warm = ShardedSolveService(S, device=dev)
    for pods in seqs:
        warm.solve_window(catalog, pods=pods)
    loop = ShardedServingLoop(ShardedSolveService(S, device=dev),
                              capacity=SHARDED["capacity"])
    reset_launches()
    submit_ms, result_ms = [], []
    with GcCount() as loop_gc:
        t0 = time.perf_counter()
        handles = []
        for pods in seqs:
            t1 = time.perf_counter()
            handles.append(loop.submit(catalog, pods=pods))
            submit_ms.append((time.perf_counter() - t1) * 1e3)
        plans = []
        for h in handles:
            t1 = time.perf_counter()
            plans.append(h.result())
            result_ms.append((time.perf_counter() - t1) * 1e3)
        served_ms = (time.perf_counter() - t0) * 1e3 / len(seqs)
    launches = launch_counts()
    require_window_launches(launches, "sharded serving loop", len(seqs))
    classic = ShardedSolveService(S, device=dev)
    walls = []
    with GcCount() as classic_gc:
        for r, (pods, plan) in enumerate(zip(seqs, plans)):
            t0 = time.perf_counter()
            want = classic.solve_window(catalog, pods=pods)
            walls.append(time.perf_counter() - t0)
            for s, (a, b) in enumerate(zip(plan.plans, want.plans)):
                plans_equal(f"sharded serving round {r} shard {s}", a, b)
    # profiled before the parity checks, whose windows would evict these
    # windows' shard problems from the encode memo (8 entries)
    profiled = ShardedSolveService(S, device=dev)
    profiled.solve_window(catalog, pods=seqs[0])

    def warm_windows():
        for pods in seqs[1:]:
            profiled.solve_window(catalog, pods=pods)

    profile = host_profile(warm_windows)
    parity = sharded_parity_violations(seeds=4, device=dev)
    if parity:
        raise AssertionError(f"sharded serving parity: {parity[:3]}")
    st = loop.stats()
    out = {"launches": launches, "stats": st,
           "overlap_fraction": loop.overlap_fraction,
           "served_ms_per_window": served_ms,
           "submit_ms": submit_ms, "result_ms": result_ms,
           "served_gc": loop_gc.read(),
           "classic_mean_ms": sum(walls) * 1e3 / len(walls),
           "classic_p50_ms": p50_ms(walls),
           "classic_ms": [x * 1e3 for x in walls],
           "classic_gc": classic_gc.read(),
           "profile_windows": len(seqs) - 1,
           "profile_cumulative_s": profile}
    say(f"sharded serving: {len(seqs)} windows of seed "
        f"{SHARDED['seed0']}'s churn through ShardedServingLoop(capacity="
        f"{SHARDED['capacity']}): every plan equal to solve_window's, "
        f"launches {launches}, {st}; the port's 4-seed sharded parity "
        f"checks clean")
    say(f"timing [{card}]: sharded serving {served_ms:.4f} ms per window "
        f"(amortized; submits {fmt_ms(submit_ms)}, results "
        f"{fmt_ms(result_ms)} ms; {loop_gc.n} collections, "
        f"{loop_gc.s * 1e3:.4f} ms) against solve_window "
        f"{out['classic_mean_ms']:.4f} ms per window (amortized; windows "
        f"{fmt_ms(out['classic_ms'])} ms, p50 {out['classic_p50_ms']:.4f} "
        f"ms; {classic_gc.n} collections, {classic_gc.s * 1e3:.4f} ms); "
        f"overlap fraction {loop.overlap_fraction:.4f}")
    say(f"host profile [{card}]: {len(seqs) - 1} warm solve_window calls, "
        f"cumulative seconds: " + "; ".join(
            f"{name} {t:.4f}" for name, t in profile))
    return out


def repack_fleet(cfg: dict):
    """``bench.py::run_repack``'s fleet: (catalog, cluster)."""
    catalog = workload.build_catalog(cfg["types"])
    rng = np.random.RandomState(cfg["seed"])
    cluster = ClusterState()
    pod_i = 0
    for i in range(cfg["claims"]):
        cluster.add_nodeclaim(NodeClaim(
            name=f"rc{i}", instance_type="bx2-16x64", zone="us-south-1",
            node_name=f"node-rc{i}", hourly_price=0.8, launched=True,
            initialized=True))
        for _ in range(cfg["pods_per_claim"]):
            name = f"rp{pod_i}"
            pod_i += 1
            cluster.add_pod(pod_api.PodSpec(name, requests=pod_api.
                                            ResourceRequests(
                                                int(rng.randint(100, 1000)),
                                                int(rng.randint(256, 2048)),
                                                0, 1)))
            cluster.bind_pod(f"default/{name}", f"node-rc{i}")
    return catalog, cluster


def defrag_fleet():
    """``bench.py::_run_repack_defrag``'s torus case: (catalog,
    cluster)."""
    catalog = workload.build_catalog(24, ("gx3", "bx2", "cx2"))
    cluster = ClusterState()
    pk = 0
    for i in range(2):
        cluster.add_nodeclaim(NodeClaim(
            name=f"dz{i}", instance_type="gx3-64x512", zone="us-south-1",
            node_name=f"node-dz{i}", hourly_price=3.0, launched=True,
            initialized=True))
        for _ in range(3 if i == 0 else 1):
            cluster.add_pod(pod_api.PodSpec(
                f"dsg{pk}", requests=pod_api.ResourceRequests(500, 1024, 2,
                                                              1)))
            cluster.bind_pod(f"default/dsg{pk}", f"node-dz{i}")
            pk += 1
    gang = PodGroup(name="bench-parked", min_member=4, slice_shape="2x2x2",
                    deadline_seconds=1e9)
    for j in range(4):
        cluster.add_pod(pod_api.PodSpec(
            f"dgm{j}", requests=pod_api.ResourceRequests(250, 512, 0, 1),
            gang=gang))
    return catalog, cluster


def repack_fingerprint(plan):
    return ([(m.pod_key, m.src_claim, m.dst_claim, m.kind)
             for m in plan.migrations], plan.drained,
            [(r.claim_name, r.shape, r.pre_mask, r.post_mask)
             for r in plan.reopened], plan.proposed_cost)


def phase_repack(dev, card: str) -> dict:
    """(r) ``bench.py::run_repack``'s fleet through the repack planner:
    the torch grid on the card reading the resident occupancy rows, and
    the numpy grid; equal plans, ``validate_repack_plan`` clean; then the
    torus-defrag case on both routes."""
    from karpenter_tpu_torch.repack import (
        RepackOptions, RepackPlanner, encode_repack,
    )
    from karpenter_tpu_torch.resident.store import (
        OccupancySnapshot, ResidentStore,
    )
    from karpenter_tpu_torch.solver.validate import validate_repack_plan

    catalog, cluster = repack_fleet(REPACK)
    store = ResidentStore(device=dev)
    t0 = time.perf_counter()
    prob = encode_repack(cluster, catalog,
                         snapshot=OccupancySnapshot(cluster), store=store)
    encode_ms = (time.perf_counter() - t0) * 1e3
    if prob.rows_dev is None or prob.rows_dev.device.type != "cuda":
        raise AssertionError("the repack problem did not take the resident "
                             "occupancy rows on the card")
    t0 = time.perf_counter()
    fresh = encode_repack(cluster, catalog)
    fresh_ms = (time.perf_counter() - t0) * 1e3
    on = RepackPlanner(RepackOptions(use_device="on"), device=dev)
    off = RepackPlanner(RepackOptions(use_device="off"), device="cpu")
    reset_launches()
    t0 = time.perf_counter()
    plan = on.plan(prob)
    cold_s = time.perf_counter() - t0
    launches = launch_counts()
    require_no_launches(launches, "repack path")
    ref = off.plan(fresh)
    if on.device_steps != 1 or plan.backend != "device" \
            or repack_fingerprint(plan) != repack_fingerprint(ref):
        raise AssertionError(f"repack plan on the card ({on.device_steps} "
                             f"torch grids, backend {plan.backend}) differs "
                             f"from the numpy grid's")
    errors = validate_repack_plan(plan, cluster, catalog)
    if errors:
        raise AssertionError(f"validate_repack_plan: {errors[:3]}")
    if not plan.migrations or plan.savings <= 0:
        raise AssertionError("the oversized fleet repacked nothing")
    on_ms = timed_p50(lambda: on.plan(prob), REPACK["iters"])
    off_ms = timed_p50(lambda: off.plan(fresh), REPACK["iters"])

    dcat, dcl = defrag_fleet()
    dprob = encode_repack(dcl, dcat)
    dplans = [RepackPlanner(RepackOptions(use_device=u), device=d).plan(
        dprob) for u, d in (("on", dev), ("off", "cpu"))]
    if repack_fingerprint(dplans[0]) != repack_fingerprint(dplans[1]) \
            or dplans[0].slices_reopened < 1 \
            or validate_repack_plan(dplans[0], dcl, dcat):
        raise AssertionError(f"torus defrag: reopened "
                             f"{[p.slices_reopened for p in dplans]}")
    out = {"launches": launches, "migrations": plan.migration_count,
           "drained": len(plan.drained), "savings": plan.savings,
           "savings_fraction": plan.savings_fraction,
           "card_p50_ms": on_ms, "numpy_p50_ms": off_ms,
           "cold_ms": cold_s * 1e3, "encode_store_ms": encode_ms,
           "encode_fresh_ms": fresh_ms,
           "defrag": {"slices_reopened": dplans[0].slices_reopened,
                      "migrations": dplans[0].migration_count}}
    say(f"repack path: {REPACK['claims']} claims x {REPACK['types']} types "
        f"({REPACK['pods_per_claim']} pods each): {plan.migration_count} "
        f"migrations, {len(plan.drained)} drained, savings "
        f"{plan.savings:.4f} $/h ({plan.savings_fraction:.4f}); the torch "
        f"grid on the card read the resident occupancy rows, plan equal to "
        f"the numpy grid's on a fresh encode; validate_repack_plan clean; "
        f"launches {launches} (the grid is PyTorch ops); torus defrag: "
        f"{dplans[0].slices_reopened} slice(s) reopened by "
        f"{dplans[0].migration_count} migrations, equal on both routes, "
        f"clean")
    say(f"timing [{card}]: repack plan warm p50 {on_ms:.4f} ms with the "
        f"grid on the card (cold {cold_s * 1e3:.3f} ms), numpy grid "
        f"{off_ms:.4f} ms; encode through the store {encode_ms:.3f} ms, "
        f"fresh {fresh_ms:.3f} ms")
    return out


# -- (t) the host greedy oracles on the card's plans ---------------------------

# the oracle phase: timing repeats and headline windows recorded (the
# repack oracle's python loop is quadratic in claims: 1.010 s at 400
# claims and 25.891 s at run_repack's 2000 on the host of an NVIDIA H100
# 80GB HBM3 machine, 700.00 W)
ORACLES = dict(python_iters=5, native_iters=10, rounds=10,
               telemetry_windows=20, record_reps=300)


def greedy_gate(label: str, plan, greedy, pods, catalog) -> tuple:
    """The card's plan against the greedy oracle's, as bench.py and the
    reference's test_parity_with_oracle_mixed hold them: both clean, the
    card placing at least the oracle's pods at no more than its cost
    (+1e-6).  Returns (cost ratio, placed, oracle placed)."""
    for who, p in (("card", plan), ("greedy", greedy)):
        errors = validate_plan(p, pods, catalog)
        if errors:
            raise AssertionError(f"{label}: the {who} plan: validate_plan "
                                 f"{errors[:3]}")
    if plan.placed_count < greedy.placed_count:
        raise AssertionError(f"{label}: the card places "
                             f"{plan.placed_count} pods, the greedy oracle "
                             f"{greedy.placed_count}")
    if plan.total_cost_per_hour > greedy.total_cost_per_hour + 1e-6:
        raise AssertionError(f"{label}: the card's cost "
                             f"{plan.total_cost_per_hour} exceeds the greedy "
                             f"oracle's {greedy.total_cost_per_hour}")
    return (plan.total_cost_per_hour / max(greedy.total_cost_per_hour, 1e-9),
            plan.placed_count, greedy.placed_count)


def reasons_clean(label: str, problem, plan) -> None:
    errors = check_plan_reasons(problem, plan)
    if errors:
        raise AssertionError(f"{label}: check_plan_reasons: {errors[:3]}")


def verdict(naive_ms: float, card_ms: float, placed_ok: bool,
            cost_ratio: float) -> tuple[float, str]:
    """bench.py's ``vs_baseline`` and its verdict name (bench.py:279-288)."""
    if not naive_ms:
        return 0.0, "no-native-baseline"
    if not placed_ok:
        return 0.0, "places-fewer-than-baseline"
    if cost_ratio > 1.0 + 1e-6:
        return 0.0, "cost-exceeds-baseline"
    ratio = naive_ms / card_ms
    return ratio, "below-baseline" if ratio < 1.0 else "ok"


def route_oracle(dev, label: str, solver, problem, host_fn) -> dict:
    """The card's packed result of a route window against its numpy
    oracle: node_off, assign, unplaced and reason words equal; the cost
    word equal to the oracle's plan priced in the reference's order."""
    prep = solver._prepare(problem)
    out = solver.dispatch_packed(prep).cpu().numpy()
    G, N, g = prep.G_pad, prep.N, problem.num_groups
    node_off, assign, unplaced, cost = unpack_result(
        out, G, N, prep.K, prep.dense16, prep.coo16)
    words = unpack_reason_words(out, G, N, prep.K, prep.dense16, prep.coo16)
    t0 = time.perf_counter()
    h_off, h_assign, h_unp, _, h_words = host_fn(prep)
    host_s = time.perf_counter() - t0
    for name, a, b in (("node_off", node_off, h_off),
                       ("assign", assign[:g], h_assign),
                       ("unplaced", unplaced[:g], h_unp),
                       ("words", words[:g], h_words)):
        if not np.array_equal(a, b):
            raise AssertionError(f"{label}: the card's {name} differs from "
                                 f"the host oracle's")
    price = torch.from_numpy(np.asarray(problem.catalog.off_price,
                                        dtype=np.float32))
    want = cost_sum.cost_word_reference(torch.from_numpy(
        np.ascontiguousarray(h_off, dtype=np.int32)), price)
    if np.float32(cost).view(np.int32) != want.numpy().view(np.int32):
        raise AssertionError(f"{label}: cost word {cost} vs the oracle's "
                             f"plan priced in the reference's order "
                             f"{float(want)}")
    say(f"{label}: the card's packed result equals the host oracle's "
        f"(node_off, assign, unplaced, words; G={g}, N={N}) and its cost "
        f"word {cost!r} the oracle's plan priced in the reference's order; "
        f"oracle {host_s * 1e3:.3f} ms")
    return {"oracle_ms": host_s * 1e3, "cost": float(cost), "N": N}


def headline_oracle(dev, card: str, solver, request) -> dict:
    """The headline through the card and both greedy paths, the per-pod
    loop beside the card in turns, and the telemetry ring."""
    pods, catalog = request.pods, request.catalog
    problem = encode_mod.encode(pods, catalog)
    plan = solver.solve(request)
    reasons_clean("headline", problem, plan)
    py = GreedySolver(SolverOptions(backend="greedy", use_native="off"))
    nat = GreedySolver(SolverOptions(backend="greedy"))
    gplan, nplan = py.solve(request), nat.solve(request)
    if (gplan.backend, nplan.backend) != ("greedy", "greedy-native") \
            or plan_view(gplan) != plan_view(nplan):
        raise AssertionError(f"headline: the greedy's python plan "
                             f"({gplan.backend}) and native plan "
                             f"({nplan.backend}) differ")
    ratio, placed, g_placed = greedy_gate("headline", plan, gplan, pods,
                                          catalog)
    py_ms = timed_p50(lambda: py.solve(request), ORACLES["python_iters"])
    nat_ms = timed_p50(lambda: nat.solve(request), ORACLES["native_iters"])
    expanded = expand_per_pod(problem)
    if solve_per_pod_native(problem, expanded=expanded) is None:
        raise AssertionError("solve_per_pod_native: no native library")
    card_w, naive_w = [], []
    for _ in range(ORACLES["rounds"]):
        t0 = time.perf_counter()
        solver.solve(request)
        t1 = time.perf_counter()
        solve_per_pod_native(problem, expanded=expanded)
        card_w.append(t1 - t0)
        naive_w.append(time.perf_counter() - t1)
    card_ms, naive_ms = p50_ms(card_w), p50_ms(naive_w)
    vs, gate = verdict(naive_ms, card_ms, placed >= g_placed, ratio)
    say(f"headline oracle: the card's plan clean, {placed} placed (greedy "
        f"{g_placed}), cost {plan.total_cost_per_hour:.6f} $/h against "
        f"the greedy's {gplan.total_cost_per_hour:.6f} (ratio "
        f"{ratio:.6f}); python and native greedy plans equal; "
        f"check_plan_reasons clean")
    say(f"timing [{card}]: host greedy p50 {py_ms:.4f} ms (python loop), "
        f"{nat_ms:.4f} ms (native, per group); solve_per_pod_native p50 "
        f"{naive_ms:.4f} ms (expand_per_pod hoisted, {len(expanded[0])} "
        f"rows) beside the card's warm p50 {card_ms:.4f} ms in "
        f"{ORACLES['rounds']} rounds of turns: vs_baseline {vs:.4f} "
        f"({gate}); printed, not gated")

    # the telemetry ring: one entry per solved window, none lost
    obs.reset_recorder()
    metrics.SOLVE_QUALITY_WINDOWS.reset()
    for _ in range(ORACLES["telemetry_windows"]):
        solver.solve(request)
    ring = obs.get_recorder().telemetry()
    recorded = metrics.SOLVE_QUALITY_WINDOWS.get("scan")
    if len(ring) != ORACLES["telemetry_windows"] \
            or recorded != ORACLES["telemetry_windows"] \
            or {e["plane"] for e in ring} != {"scan"}:
        raise AssertionError(f"telemetry: {len(ring)} ring entries and "
                             f"solve_quality_windows_total{{plane=scan}} "
                             f"{recorded} after "
                             f"{ORACLES['telemetry_windows']} windows")
    summary = telemetry_words.summary()["planes"]["scan"]
    prep = solver._prepare(problem)
    out = solver.dispatch_packed(prep).cpu().numpy()
    args = (out, prep.G_pad, prep.N, prep.K)
    # (the ring keeps its last entries only: these evict the windows')
    kw = dict(dense16=prep.dense16, coo16=prep.coo16, plane="probe")
    t0 = time.perf_counter()
    for _ in range(ORACLES["record_reps"]):
        telemetry_words.decode_and_record(*args, **kw)
    record_us = (time.perf_counter() - t0) / ORACLES["record_reps"] * 1e6
    say(f"telemetry: {len(ring)} ring entries and "
        f"solve_quality_windows_total{{plane=\"scan\"}} {recorded} after "
        f"{ORACLES['telemetry_windows']} headline windows; summary "
        f"{json.dumps(summary)}")
    say(f"timing [{card}]: decode_and_record {record_us:.3f} us of host "
        f"time a window ({ORACLES['record_reps']} calls on the headline's "
        f"result)")
    obs.reset_recorder()
    return {"cost_ratio": ratio, "placed": placed, "greedy_placed": g_placed,
            "greedy_python_p50_ms": py_ms, "greedy_native_p50_ms": nat_ms,
            "per_pod_native_p50_ms": naive_ms, "card_p50_ms": card_ms,
            "vs_baseline": vs, "verdict": gate,
            "telemetry_ring": len(ring), "telemetry_windows": recorded,
            "record_us": record_us, "telemetry_summary": summary}


def phase_oracles(dev, card: str, solver, request) -> dict:
    """(t) The host greedy oracles against the card's plans (see the
    module docstring); no kernel launches are counted here, every path
    having been driven already."""
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    lib = native.load()
    if lib is None:
        raise AssertionError("the native per-pod twin did not build from "
                             "csrc/ffd_host.cpp; the baseline is unmeasured")
    say(f"native: {native.library_path().name} built from "
        f"{native.SOURCE.name} and loaded in "
        f"{(time.perf_counter() - t0) * 1e3:.3f} ms")
    out = {"headline": headline_oracle(dev, card, solver, request)}

    # the flat window, the oracle uncapped (bench.py:256)
    pods, catalog = workload.build_hetero_workload(
        HEADLINE["pods"], HEADLINE["types"], **FLAT_WINDOWS[0])
    req = SolveRequest(pods, catalog)
    card_solver = TorchSolver(device=dev)
    plan = card_solver.solve(req)
    if card_solver.last_stats["path"] != f"flat-{dev.type}":
        raise AssertionError(f"flat oracle window took "
                             f"{card_solver.last_stats['path']!r}")
    t0 = time.perf_counter()
    greedy = GreedySolver(SolverOptions(backend="greedy", max_nodes=32768)
                          ).solve(req)
    g_ms = (time.perf_counter() - t0) * 1e3
    ratio, placed, g_placed = greedy_gate("flat", plan, greedy, pods,
                                          catalog)
    reasons_clean("flat", encode_mod.encode(pods, catalog), plan)
    say(f"flat oracle (seed {FLAT_WINDOWS[0]['seed']}): the card's plan "
        f"clean, {placed} placed (greedy {g_placed}, {greedy.backend}, "
        f"max_nodes 32768, {g_ms:.3f} ms), cost ratio {ratio:.6f}; "
        f"check_plan_reasons clean")
    out["flat"] = {"cost_ratio": ratio, "placed": placed,
                   "greedy_placed": g_placed, "greedy_ms": g_ms}

    # the pref plan's reasons
    pods, catalog = workload.build_workload(
        HEADLINE["pods"], HEADLINE["types"], seed=HEADLINE["seed"])
    pods = workload.with_preferences(pods)
    reasons_clean("pref", encode_mod.encode(pods, catalog),
                  TorchSolver(device=dev).solve(SolveRequest(pods, catalog)))

    # the routes against their numpy oracles
    catalog = workload.build_catalog(HEADLINE["types"])
    pool = NodePool(name="default", overcommit=STOCHASTIC["overcommit"])
    pods = workload.stochastic_pods(HEADLINE["pods"],
                                    seed=STOCHASTIC["seed"])
    problem = encode_mod.encode(pods, catalog, pool)
    card_solver = TorchSolver(device=dev)
    reasons_clean("stochastic", problem, card_solver.solve(
        SolveRequest(pods, catalog, pool)))
    out["stochastic"] = route_oracle(
        dev, "stochastic oracle", card_solver, problem,
        lambda prep: solve_stochastic_host(problem, prep.N, prep.z_bp,
                                           right_size=True))
    pods = workload.affinity_bench_pods(
        AFFINITY["tag"], HEADLINE["pods"],
        np.random.RandomState(AFFINITY["rng_seed"]))
    problem = encode_mod.encode(pods, catalog)
    card_solver = TorchSolver(device=dev)
    reasons_clean("affinity", problem, card_solver.solve(
        SolveRequest(pods, catalog)))
    out["affinity"] = route_oracle(
        dev, "affinity oracle", card_solver, problem,
        lambda prep: solve_affinity_host(problem, prep.N, right_size=True))

    # the planes: the torch grids on the card against the greedy planners
    gcat = workload.build_catalog(GANG["types"], workload.ACCEL_FAMILIES)
    gprob = encode_gangs(gang_pods(GANG), gcat)
    gplan = GangPlanner(GangOptions(use_device="on"), device=dev).plan(gprob)
    t0 = time.perf_counter()
    gref = GreedyGangPlanner().plan(gprob)
    gang_ms = (time.perf_counter() - t0) * 1e3
    if gang_fingerprint(gplan) != gang_fingerprint(gref):
        raise AssertionError("gang: the card's plan differs from "
                             "GreedyGangPlanner's")
    pcat, cluster, pending = preempt_cluster(PREEMPT)
    pprob = encode_mod.encode(pending, pcat)
    victims = encode_victims(cluster, pcat)
    compat = group_node_compat(pprob, victims)
    budget = PREEMPT["claims"] * 3
    pplan = PreemptionPlanner(PlannerOptions(use_device="on",
                                             max_evictions=budget),
                              device=dev).plan(pprob, victims, compat)
    t0 = time.perf_counter()
    pref_plan = GreedyPreemptionPlanner(PlannerOptions(
        max_evictions=budget)).plan(pprob, victims, compat)
    preempt_ms = (time.perf_counter() - t0) * 1e3
    if preempt_fingerprint(pplan) != preempt_fingerprint(pref_plan):
        raise AssertionError("preemption: the card's plan differs from "
                             "GreedyPreemptionPlanner's")
    rcat, rcl = repack_fleet(REPACK)
    rprob = encode_repack(rcl, rcat)
    rplan = RepackPlanner(RepackOptions(use_device="on"),
                          device=dev).plan(rprob)
    t0 = time.perf_counter()
    rref = GreedyRepacker().plan(rprob)
    repack_ms = (time.perf_counter() - t0) * 1e3
    dcat, dcl = defrag_fleet()
    dprob = encode_repack(dcl, dcat)
    dplan = RepackPlanner(RepackOptions(use_device="on"),
                          device=dev).plan(dprob)
    if repack_fingerprint(rplan) != repack_fingerprint(rref) \
            or repack_fingerprint(dplan) != repack_fingerprint(
                GreedyRepacker().plan(dprob)) or not rplan.migrations:
        raise AssertionError("repack: the card's plan differs from "
                             "GreedyRepacker's")
    say(f"plane oracles: gang ({gprob.num_gangs} gangs), preemption "
        f"({PREEMPT['pending']} pending x {PREEMPT['claims']} claims, "
        f"{pplan.eviction_count} evictions) and repack ({REPACK['claims']} "
        f"claims, {rplan.migration_count} migrations; the torus defrag "
        f"case too) "
        f"plans on the card equal to GreedyGangPlanner's, "
        f"GreedyPreemptionPlanner's and GreedyRepacker's; oracles "
        f"{gang_ms:.3f} / {preempt_ms:.3f} / {repack_ms:.3f} ms")
    out["planes"] = {"gang_oracle_ms": gang_ms,
                     "preempt_oracle_ms": preempt_ms,
                     "repack_oracle_ms": repack_ms}
    # the planes' problems and greedy plans, for phase (u)'s wrappers
    out["cases"] = {"gang": (gprob, gref),
                    "preempt": (pprob, victims, compat, PlannerOptions(
                        max_evictions=budget), pref_plan),
                    "defrag": (dprob, GreedyRepacker().plan(dprob))}
    out["host_s"] = time.perf_counter() - t_phase
    say(f"oracle phase: {out['host_s']:.3f} s")
    return out


# -- (v) the catalog intake -----------------------------------------------------

# the intake's catalog (the fake cloud's 500 profiles), the blackout
# (the zone whose offerings of phase (v1)'s plan go dark, for ttl s on
# an injected clock) and the spot risk (interrupted / exposed per spot
# pair of the plan)
INTAKE = dict(types=500, zone="us-south-1", ttl=600.0, interrupted=3,
              exposure=4, max_open=16384,
              # (v2): the reference's max_pods (the window fires at its
              # count, 10,000), idle and max past any stall: a collection
              # of the process's heap between two of the 10,000 adds must
              # not fire the window early (as (x2)'s, CONTROLLERS)
              window=dict(idle_seconds=60.0, max_seconds=60.0,
                          max_pods=10_000))


def intake_nodeclass():
    """The default NodeClass the provisioner lists the catalog under: a
    region, a profile and an image, no kubelet overrides."""
    nodeclass = nodeclass_from_dict({
        "metadata": {"name": "default"},
        "spec": {"region": "us-south", "instanceProfile": "bx2-4x16",
                 "image": "img-1"}})
    errors = nodeclass.validate()
    if errors:
        raise AssertionError(f"intake: the default NodeClass: {errors}")
    return nodeclass


def intake_catalog(nodeclass) -> tuple:
    """(catalog, seconds): the fake cloud's profiles priced through
    ``PricingProvider`` (its batcher closed after) and listed by
    ``InstanceTypeProvider`` under ``nodeclass``, then built."""
    t0 = time.perf_counter()
    cloud = FakeCloud(profiles=generate_profiles(INTAKE["types"]))
    pricing = PricingProvider(cloud)
    try:
        types = InstanceTypeProvider(cloud, pricing).list(nodeclass)
    finally:
        pricing.close()
    catalog = CatalogArrays.build(types)
    return catalog, time.perf_counter() - t0


def node_names(plan, pods) -> list:
    """Each pod's node, named by its place in the plan, or None."""
    where = {}
    for i, n in enumerate(plan.nodes):
        for name in n.pod_names:
            where[name] = f"{n.instance_type}/{n.zone}/{n.capacity_type}#{i}"
    return [where.get(pod_api.pod_key(p)) for p in pods]


def intake_window(label: str, solver, request, launches: dict,
                  need=("ffd_scan", "cost_sum")) -> tuple:
    """One window through ``solver`` on the card with the launch counts
    zeroed before and read after (added to ``launches``; the kernels in
    ``need`` must have run): (plan, catalog uploads it made, wall s)."""
    uploads = get_devtel().catalog_uploads
    reset_launches()
    t0 = time.perf_counter()
    plan = solver.solve(request)
    wall = time.perf_counter() - t0
    got = launch_counts()
    require_launches(got, need, label)
    add_launches(launches, got)
    return plan, get_devtel().catalog_uploads - uploads, wall


def intake_words(dev, label: str, solver, request) -> tuple:
    """The card's packed result of ``request`` against the plain CPU
    program's, word for word (the cost word too)."""
    problem = encode_mod.encode(request.pods, request.catalog,
                                request.nodepool)
    _, prep, card = packed_route_check(dev, label, solver, problem,
                                       lambda prep: None)
    return card.shape[0], prep


def cpu_plan(request):
    """The CPU solver's plan of ``request``, recorded on a throwaway
    tracer: the phase's telemetry ring holds the card's windows only."""
    with obs.use(obs.Tracer(obs.FlightRecorder())):
        return TorchSolver(device="cpu").solve(request)


def upload_ms(dev, catalog, O_pad: int, reps: int = 5) -> tuple:
    """(median ms, bytes) of one catalog upload: ``device_offerings`` on
    a fresh solver (an empty cache), synchronized."""
    walls, nbytes = [], 0
    for _ in range(reps):
        solver = TorchSolver(device=dev)
        before = get_devtel().catalog_upload_bytes
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        solver.device_offerings(catalog, O_pad)
        torch.cuda.synchronize(dev)
        walls.append((time.perf_counter() - t0) * 1e3)
        nbytes = get_devtel().catalog_upload_bytes - before
    return float(np.median(walls)), nbytes


def expect_uploads(label: str, got: int, want: int) -> None:
    if got != want:
        raise AssertionError(f"{label}: {got} catalog uploads, want {want}")


def intake_blackout(dev, solver, pods, catalog, base, launches: dict
                    ) -> dict:
    """(v3) The offerings of (v1)'s plan in INTAKE['zone'] blacked out
    on an injected clock, refreshed into the catalog, then expired."""
    used = sorted({(n.instance_type, n.zone, n.capacity_type)
                   for n in base.nodes if n.zone == INTAKE["zone"]})
    if not used:
        raise AssertionError(f"intake (v3): (v1)'s plan opened nothing in "
                             f"{INTAKE['zone']}")
    clock = [0.0]
    unavailable = UnavailableOfferings(clock=lambda: clock[0])
    for key in used:
        unavailable.mark_unavailable(*key, ttl=INTAKE["ttl"])
    t0 = time.perf_counter()
    changed = catalog.refresh_availability(unavailable)
    refresh_ms = (time.perf_counter() - t0) * 1e3
    if not changed:
        raise AssertionError("intake (v3): refresh_availability returned "
                             "False on a new blackout")
    dark = {catalog.find_offering(*key) for key in used}
    request = SolveRequest(pods, catalog)
    plan, uploads, wall = intake_window("intake blackout", solver, request,
                                        launches)
    expect_uploads("intake (v3) blackout window", uploads, 1)
    again, uploads_again, wall_again = intake_window(
        "intake blackout again", solver, request, launches)
    expect_uploads("intake (v3) repeat window", uploads_again, 0)
    plans_equal("intake (v3) repeat", again, plan)
    opened = {n.offering_index for n in plan.nodes} & dark
    if opened:
        raise AssertionError(f"intake (v3): the plan opened blacked-out "
                             f"offerings {sorted(opened)}")
    errors = validate_plan(plan, pods, catalog)
    if errors:
        raise AssertionError(f"intake (v3): validate_plan: {errors[:5]}")
    plans_equal("intake (v3) against the CPU solver", plan,
                cpu_plan(request))
    words, _ = intake_words(dev, "intake (v3) blackout window", solver,
                            request)
    clock[0] = INTAKE["ttl"] + 1.0
    if not catalog.refresh_availability(unavailable) or \
            not catalog.off_avail.all():
        raise AssertionError("intake (v3): the expired blackout did not "
                             "restore the mask")
    back, uploads_back, _ = intake_window("intake restored", solver,
                                          request, launches)
    expect_uploads("intake (v3) restored window", uploads_back, 1)
    plans_equal("intake (v3) restored against (v1)", back, base)
    say(f"intake (v3): {len(used)} offerings of (v1)'s plan in "
        f"{INTAKE['zone']} blacked out (refresh_availability "
        f"{refresh_ms:.3f} ms): one catalog upload, none on the repeat; "
        f"{len(plan.nodes)} nodes, none blacked out, {plan.placed_count} "
        f"placed, cost {plan.total_cost_per_hour:.4f} $/h (was "
        f"{base.total_cost_per_hour:.4f}), validate_plan clean, plan equal "
        f"to the CPU solver's, result buffer {words} words equal to the "
        f"plain CPU program; the blackout expired at {clock[0]:.0f} s: one "
        f"upload, plan equal to (v1)'s; walls {wall * 1e3:.3f} ms (the "
        f"re-encode of the new mask and the upload), "
        f"{wall_again * 1e3:.3f} ms (repeat)")
    return {"offerings": len(used), "refresh_ms": refresh_ms,
            "nodes": len(plan.nodes), "placed": plan.placed_count,
            "cost": plan.total_cost_per_hour, "upload_wall_ms": wall * 1e3,
            "repeat_wall_ms": wall_again * 1e3, "words": words}


def intake_risk(dev, solver, pods, catalog, base, launches: dict) -> dict:
    """(v4) The spot pairs of (v1)'s plan given an interruption rate,
    the catalog risk-priced, the headline and the stochastic windows on
    it."""
    spot = sorted({(n.instance_type, n.zone) for n in base.nodes
                   if n.capacity_type == "spot"})
    if not spot:
        raise AssertionError("intake (v4): (v1)'s plan opened no spot node")
    model = SpotRiskModel()
    for itype, zone in spot:
        model.observe(itype, zone, interrupted=INTAKE["interrupted"],
                      exposure=INTAKE["exposure"])
    g0 = catalog.risk_generation
    t0 = time.perf_counter()
    model.price_catalog(catalog)
    price_ms = (time.perf_counter() - t0) * 1e3
    g1 = catalog.risk_generation
    model.price_catalog(catalog)
    if (g1, catalog.risk_generation) != (g0 + 1, g0 + 1):
        raise AssertionError(f"intake (v4): risk generations {g0} -> {g1} "
                             f"-> {catalog.risk_generation}, want one bump")
    request = SolveRequest(pods, catalog)
    plan, uploads, wall = intake_window("intake risk", solver, request,
                                        launches)
    expect_uploads("intake (v4) risk window", uploads, 1)
    again, uploads_again, wall_again = intake_window(
        "intake risk again", solver, request, launches)
    expect_uploads("intake (v4) repeat window", uploads_again, 0)
    plans_equal("intake (v4) repeat", again, plan)
    clean_and_placed("intake (v4) risk window", plan, pods, catalog)
    plans_equal("intake (v4) against the CPU solver", plan,
                cpu_plan(request))
    words, prep = intake_words(dev, "intake (v4) risk window", solver,
                               request)
    one_upload_ms, upload_bytes = upload_ms(dev, catalog, prep.O_pad)
    penalised = set(spot)

    def on_penalised(p):
        return sum(1 for n in p.nodes if n.capacity_type == "spot"
                   and (n.instance_type, n.zone) in penalised)

    sto_pods = workload.stochastic_pods(HEADLINE["pods"],
                                        seed=STOCHASTIC["seed"])
    pool = NodePool(name="default", overcommit=STOCHASTIC["overcommit"])
    sto_request = SolveRequest(sto_pods, catalog, pool)
    sto, sto_uploads, sto_wall = intake_window(
        "intake stochastic", solver, sto_request, launches,
        need=("cost_sum",))
    if solver.last_stats["path"] != f"stochastic-{dev.type}":
        raise AssertionError(f"intake (v4) stochastic window took "
                             f"{solver.last_stats['path']!r}")
    clean_and_placed("intake (v4) stochastic window", sto, sto_pods,
                     catalog, pool)
    plans_equal("intake (v4) stochastic against the CPU solver", sto,
                cpu_plan(sto_request))
    moved = on_penalised(base) - on_penalised(plan)
    say(f"intake (v4): {len(spot)} spot pairs of (v1)'s plan at "
        f"{INTAKE['interrupted']}/{INTAKE['exposure']} interrupted; "
        f"price_catalog {price_ms:.3f} ms, risk generation {g0} -> "
        f"{catalog.risk_generation} (the second call with the same model "
        f"left it); the headline window: one catalog upload, none on the "
        f"repeat, {len(plan.nodes)} nodes, cost "
        f"{plan.total_cost_per_hour:.4f} $/h, plan equal to the CPU "
        f"solver's, result buffer {words} words equal to the plain CPU "
        f"program, wall {wall * 1e3:.3f} ms with the upload, "
        f"{wall_again * 1e3:.3f} ms the repeat; one upload alone "
        f"({upload_bytes} B, device_offerings on a fresh solver, "
        f"synchronized, median of 5) {one_upload_ms:.3f} ms; nodes on the "
        f"penalised pairs "
        f"{on_penalised(base)} -> {on_penalised(plan)} ({moved} moved off; "
        f"reported, not gated); the stochastic window (seed "
        f"{STOCHASTIC['seed']}, overcommit {STOCHASTIC['overcommit']}) on "
        f"the risk-priced catalog: path {solver.last_stats['path']}, "
        f"{sto_uploads} uploads, {len(sto.nodes)} nodes, plan equal to the "
        f"CPU solver's, wall {sto_wall * 1e3:.3f} ms")
    return {"pairs": len(spot), "price_ms": price_ms,
            "nodes": len(plan.nodes), "cost": plan.total_cost_per_hour,
            "wall_ms": wall * 1e3, "repeat_wall_ms": wall_again * 1e3,
            "upload_ms": one_upload_ms, "upload_bytes": upload_bytes,
            "words": words,
            "penalised_before": on_penalised(base),
            "penalised_after": on_penalised(plan),
            "stochastic_wall_ms": sto_wall * 1e3,
            "stochastic_nodes": len(sto.nodes)}


def intake_slo(ledger) -> dict:
    """(v5) The SLOs over the phase's ledger and recorder: the default
    soak objectives printed; gated only that both objectives of
    ``telemetry_measurements`` were measured from the card's windows and
    that no resolution was degraded."""
    t0 = time.perf_counter()
    report = evaluate_slos(list(DEFAULT_SOAK_SLOS), ledger_measurements(
        ledger, recorder=obs.get_recorder()))
    tel = telemetry_measurements()
    slo_ms = (time.perf_counter() - t0) * 1e3
    planes = telemetry_words.summary().get("planes", {})
    scan = planes.get("scan", {}).get("windows", 0)
    want = {"telemetry_escalations_per_window",
            "telemetry_min_fill_fraction"}
    if set(tel) != want or scan < 8:
        raise AssertionError(f"intake (v5): telemetry objectives {sorted(tel)} "
                             f"over {scan} scan windows; want {sorted(want)} "
                             f"over at least 8 (the fill fraction's floor)")
    outcomes = ledger.stats()["outcomes"]
    degraded = {k: v for k, v in outcomes.items()
                if k in ("placed_degraded", "released", "failed")}
    if degraded:
        raise AssertionError(f"intake (v5): degraded resolutions {degraded}")
    for line in report.render().splitlines():
        say(f"intake (v5) slo: {line}")
    say(f"intake (v5): telemetry over {scan} scan windows and "
        f"{planes.get('stochastic', {}).get('windows', 0)} stochastic: "
        + ", ".join(f"{k} {v.value:.6g}" for k, v in sorted(tel.items()))
        + f"; ledger outcomes {outcomes}; SLO evaluation {slo_ms:.3f} ms "
        f"of host time")
    return {"report": report.to_dict(), "slo_ms": slo_ms, "scan_windows":
            scan, "telemetry": {k: v.value for k, v in tel.items()},
            "outcomes": outcomes}


def phase_intake(dev, card: str, pods, catalog, main_plan) -> dict:
    """(v) The catalog intake on the card: (v1) the 500-type catalog
    through the port's FakeCloud -> PricingProvider ->
    InstanceTypeProvider chain, equal to ``workload.build_catalog`` and
    solved through ``make_solver()`` to phase (a)'s plan; (v2) the
    headline pods through ``SolveWindow`` (one window of 10,000, every
    future the direct plan's node, the ledger's stamps linked to its
    trace); (v3) a blackout and its expiry; (v4) the spot risk; (v5) the
    SLOs over the phase's ledger and recorder."""
    t_phase = time.perf_counter()
    launches: dict = {}
    saved_recorder = obs.get_tracer().recorder
    obs.reset_recorder()
    ledger = PlacementLedger(max_open=INTAKE["max_open"])
    try:
        with obs.use_ledger(ledger):
            out = intake_phases(dev, pods, catalog, main_plan, ledger,
                                launches)
            out["slo"] = intake_slo(ledger)
    finally:
        obs.get_tracer().recorder = saved_recorder
    out["launches"] = launches
    out["host_s"] = time.perf_counter() - t_phase
    say(f"intake phase: {out['host_s']:.3f} s on {card}, launches "
        f"{launches}")
    return out


def intake_phases(dev, pods, catalog, main_plan, ledger, launches) -> dict:
    nodeclass = intake_nodeclass()
    own, build_s = intake_catalog(nodeclass)
    for f in CATALOG_FIELDS:
        a, b = getattr(own, f), getattr(catalog, f)
        same = np.array_equal(a, b) if isinstance(a, np.ndarray) \
            else list(a) == list(b)
        if not same:
            raise AssertionError(f"intake (v1): field {f} differs from "
                                 f"workload.build_catalog")
    solver = make_solver(device=dev)
    request = SolveRequest(pods, own)
    base, uploads, cold = intake_window("intake (v1)", solver, request,
                                        launches)
    expect_uploads("intake (v1) first window", uploads, 1)
    plans_equal("intake (v1) against phase (a)", base, main_plan)
    _, _, warm = intake_window("intake (v1) warm", solver, request, launches)
    say(f"intake (v1): {INTAKE['types']} types listed from FakeCloud, "
        f"priced through PricingProvider's batcher and built by "
        f"InstanceTypeProvider under NodeClass {nodeclass.name!r} in "
        f"{build_s * 1e3:.3f} ms ({own.num_offerings} offerings), equal to "
        f"workload.build_catalog on every field; make_solver() on the "
        f"card: plan equal to phase (a)'s ({len(base.nodes)} nodes, cost "
        f"{base.total_cost_per_hour:.4f} $/h), cold {cold * 1e3:.3f} ms "
        f"with one catalog upload, warm {warm * 1e3:.3f} ms")

    # (v2): the pods through the solve window, fired at its count
    fired, solve_s, linked = [], [], []
    keys = [pod_api.pod_key(p) for p in pods]
    for key in keys:
        ledger.first_seen(key)

    def on_window(batch):
        recs = ledger.open_records()
        linked.append((sum(1 for r in recs
                           if "window_enqueue" in r.stamp_names()),
                       {r.trace_id for r in recs}))
        batch_keys = [pod_api.pod_key(p) for p in batch]
        ledger.solve_start(batch_keys)
        t0 = time.perf_counter()
        plan = solver.solve(SolveRequest(list(batch), own))
        solve_s.append(time.perf_counter() - t0)
        ledger.plan_decoded(batch_keys)
        names = node_names(plan, batch)
        for key, name in zip(batch_keys, names):
            if name is None:
                ledger.unplaced(key, "capacity_exhausted")
            else:
                ledger.resolve(key, "placed")
        fired.append(len(batch))
        return names

    opts = WindowOptions(**INTAKE["window"])
    window = SolveWindow(on_window, opts)
    reset_launches()
    try:
        t0 = time.perf_counter()
        futures = window.add_all(pods)
        got = [f.result(timeout=120) for f in futures]
        wall = time.perf_counter() - t0
    finally:
        window.close()
    window_launches = launch_counts()
    require_launches(window_launches, ["ffd_scan", "cost_sum"],
                     "intake (v2) window")
    add_launches(launches, window_launches)
    if fired != [len(pods)]:
        raise AssertionError(f"intake (v2): windows fired {fired}, want one "
                             f"of {len(pods)}")
    if got != node_names(base, pods):
        raise AssertionError("intake (v2): the window's node names differ "
                             "from the direct plan's")
    stamped, traces = linked[0]
    if stamped != len(pods) or len(traces) != 1 or 0 in traces:
        raise AssertionError(f"intake (v2): {stamped} window_enqueue stamps "
                             f"over trace ids {sorted(traces)[:4]}")
    say(f"intake (v2): {len(pods)} pods through SolveWindow (idle "
        f"{opts.idle_seconds} s, max {opts.max_seconds} s, max_pods "
        f"{opts.max_pods}): one window of {fired[0]}, every future the "
        f"direct plan's node, {stamped} window_enqueue stamps linked to "
        f"trace {next(iter(traces))}; wall from the first add to the last "
        f"future {wall * 1e3:.3f} ms, the solve {solve_s[0] * 1e3:.3f} ms "
        f"of it ({solve_s[0] / wall:.1%})")
    return {"build_ms": build_s * 1e3, "cold_ms": cold * 1e3,
            "warm_ms": warm * 1e3, "window_wall_ms": wall * 1e3,
            "window_solve_ms": solve_s[0] * 1e3,
            "window_solve_share": solve_s[0] / wall,
            "default_windows": intake_default_window(solver, pods, own, got,
                                                     launches),
            "blackout": intake_blackout(dev, solver, pods, own, base,
                                        launches),
            "risk": intake_risk(dev, solver, pods, own, base, launches)}


def intake_default_window(solver, pods, own, got, launches) -> list:
    """(v2) again at the window's defaults (``WindowOptions()``: idle
    1 s, max 10 s, max_pods 10,000): however many windows the idle and
    max timers fire, every pod is delivered exactly once and every
    future resolves; one window gives (v2)'s node names."""
    batches = []

    def on_window(batch):
        batches.append([pod_api.pod_key(p) for p in batch])
        plan = solver.solve(SolveRequest(list(batch), own))
        return node_names(plan, batch)

    opts = WindowOptions()
    window = SolveWindow(on_window, opts)
    reset_launches()
    try:
        t0 = time.perf_counter()
        futures = window.add_all(pods)
        names = [f.result(timeout=120) for f in futures]
        wall = time.perf_counter() - t0
    finally:
        window.close()
    window_launches = launch_counts()
    require_launches(window_launches, ["ffd_scan", "cost_sum"],
                     "intake (v2) default window")
    add_launches(launches, window_launches)
    delivered = collections.Counter(k for b in batches for k in b)
    keys = [pod_api.pod_key(p) for p in pods]
    if sorted(delivered) != sorted(keys) or \
            any(n != 1 for n in delivered.values()):
        raise AssertionError(f"intake (v2) default window: {len(delivered)} "
                             f"pods delivered over {len(batches)} windows, "
                             f"want each of {len(keys)} once")
    if len(batches) == 1 and names != got:
        raise AssertionError("intake (v2) default window: one window, node "
                             "names differ from (v2)'s")
    sizes = [len(b) for b in batches]
    say(f"intake (v2) at WindowOptions() (idle {opts.idle_seconds} s, max "
        f"{opts.max_seconds} s, max_pods {opts.max_pods}): windows of "
        f"{sizes}, each of the {len(keys)} pods delivered once, every future "
        f"resolved; wall {wall * 1e3:.3f} ms")
    return sizes


# -- phase 5: timings ---------------------------------------------------------


# -- (w) the provisioning loop ---------------------------------------------------

PROVISION = dict(
    # (w2): the reference's max_pods (the window fires at its count,
    # 10,000), idle and max past any stall of the host between two adds
    # (as (v2) and (x2)); (w3) re-windows on a short idle and retry tick
    window=dict(idle_seconds=60.0, max_seconds=60.0, max_pods=10_000),
    quick=dict(idle_seconds=0.05, max_seconds=0.5, max_pods=10_000),
    retry_s=0.3, deadline_s=60.0,
    # (w4)-(w6): the first 2,000 headline pods
    small=2000, cpu_limit_milli=1_000_000, soft_taint=("dedicated", "gpu"),
    # (w6)'s started window fires at its count only (the 2,000 pods): at
    # the quick idle a stall of the host between two adds split them into
    # two windows, and the one scripted fault reached only the first
    fault_window=dict(idle_seconds=60.0, max_seconds=60.0, max_pods=2000))


def provision_nodeclass():
    """(v)'s default NodeClass, its image resolved and Ready (the
    status controller's work)."""
    nodeclass = intake_nodeclass()
    nodeclass.status.resolved_image_id = "img-1"
    nodeclass.status.set_condition("Ready", "True", "Validated")
    return nodeclass


def permissive() -> CircuitBreakerManager:
    """A breaker that admits every create of a plan (its defaults, 2
    creates a minute and 5 at once, would stop a 240-node plan)."""
    return CircuitBreakerManager(CircuitBreakerConfig(
        failure_threshold=100_000, rate_limit_per_minute=100_000,
        max_concurrent_instances=100_000))


class ProvisionRig:
    """The provisioning loop on the port's fake cloud: ``FakeCloud`` with
    the headline's 500 profiles, ``PricingProvider``,
    ``UnavailableOfferings``, ``InstanceTypeProvider``, a ``ClusterState``
    with a ready NodeClass and the given pools (the default NodePool when
    none), an ``Actuator`` and a ``Provisioner`` on ``device``.  The
    breaker admits every create of a plan (its defaults, 2 creates a
    minute and 5 at once, would stop a 245-node plan after two)."""

    def __init__(self, device, pools=(), journal=None, window=None,
                 families=None, solver=None):
        self.cloud = FakeCloud(profiles=generate_profiles(
            INTAKE["types"], **({"families": families} if families else {})))
        self.pricing = PricingProvider(self.cloud)
        self.unavail = UnavailableOfferings()
        self.itp = InstanceTypeProvider(self.cloud, self.pricing,
                                        self.unavail)
        self.cluster = ClusterState()
        self.nodeclass = self.cluster.add_nodeclass(provision_nodeclass())
        for pool in pools or (NodePool(name="default",
                                       nodeclass_name="default"),):
            self.cluster.add_nodepool(pool)
        self.device = device
        self.window = window or PROVISION["window"]
        self.solver = solver or SolverOptions()
        self.restart(journal)

    def restart(self, journal=None):
        """A new actuator and provisioner on the same cloud and cluster
        (an operator restart)."""
        if getattr(self, "prov", None) is not None:
            self.prov.stop()
        self.journal = journal
        self.actuator = Actuator(
            self.cloud, self.cluster, unavailable=self.unavail,
            breaker=permissive(), journal=journal)
        self.prov = Provisioner(
            self.cluster, self.itp, self.actuator, ProvisionerOptions(
                solver=self.solver, window=WindowOptions(**self.window)),
            journal=journal, device=self.device)

    def add(self, pods) -> None:
        for p in pods:
            self.cluster.add_pod(p)

    def close(self) -> None:
        self.prov.stop()
        self.pricing.close()


class CycleClock:
    """Host timers around one provisioner's stages: the window handler,
    the catalog resolve, the solve, the actuation and the nominations;
    the solves' requests and plans in order."""

    def __init__(self, prov):
        self.s: dict = {}
        self.solves: list = []
        self.fired: list = []
        self.last_nominate = 0.0
        for owner, attr, name in ((prov, "_catalog_for", "catalog"),
                                  (prov.actuator, "execute_plan",
                                   "actuation"),
                                  (prov, "_nominate", "nomination"),
                                  (prov, "_on_window", "window")):
            self._wrap(owner, attr, name)
        solve = prov.solver.solve

        def timed_solve(request):
            t0 = time.perf_counter()
            plan = solve(request)
            self.s["solve"] = self.s.get("solve", 0.0) + \
                time.perf_counter() - t0
            self.solves.append((request, plan))
            return plan

        prov.solver.solve = timed_solve

    def _wrap(self, owner, attr, name):
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            if name == "window":
                self.fired.append((t0, len(args[0])))
            try:
                return fn(*args, **kwargs)
            finally:
                t1 = time.perf_counter()
                self.s[name] = self.s.get(name, 0.0) + t1 - t0
                if name == "nomination":
                    self.last_nominate = t1

        setattr(owner, attr, timed)


def provision_claims(cluster) -> dict:
    """{the pod keys nominated onto a live claim: its offering and
    pool}: claims compared by their pod sets, not their random names."""
    pods: dict = {}
    for p in cluster.list("pods"):
        if p.nominated_node:
            pods.setdefault(p.nominated_node, []).append(
                pod_api.pod_key(p.spec))
    return {frozenset(pods.get(c.name, ())): (
        c.instance_type, c.zone, c.capacity_type, c.nodepool_name)
        for c in cluster.nodeclaims() if not c.deleted}


def provision_cpu(pods, pools=()) -> tuple:
    """The CPU port's ``provision_once`` on a fresh rig with ``pods``:
    (rig, plans)."""
    rig = ProvisionRig("cpu", pools=pools)
    rig.add(pods)
    return rig, rig.prov.provision_once()


def no_leaks(label: str, cloud, cluster) -> dict:
    """Every VNI and volume attached to an instance, one instance per
    live claim."""
    insts = cloud.list_instances()
    vnis = {i.vni_id for i in insts}
    vols = {v for i in insts for v in i.volume_ids}
    live = {c.provider_id for c in cluster.nodeclaims() if not c.deleted}
    if set(cloud.vnis) != vnis or set(cloud.volumes) != vols or \
            {provider_id(cloud.region, i.id) for i in insts} != live:
        raise AssertionError(
            f"{label}: leaked resources: {len(cloud.vnis)} VNIs for "
            f"{len(vnis)} attached, {len(cloud.volumes)} volumes for "
            f"{len(vols)}, {len(insts)} instances for {len(live)} claims")
    return {"instances": len(insts), "vnis": len(vnis), "volumes": len(vols)}


def phase_provision(dev, card: str, pods) -> dict:
    """(w) The provisioning loop on the card (see the module docstring):
    (w1) the rig, (w2) 10,000 headline pods through the watch path,
    (w3) a failed create, (w4) pool limits and soft taints, (w5) the
    kubelet, the cloud provider, drift and a crash with its recovery."""
    t_phase = time.perf_counter()
    launches: dict = {}
    ledger = PlacementLedger(max_open=INTAKE["max_open"])
    rigs: list = []
    try:
        with obs.use_ledger(ledger):
            rig = ProvisionRig(dev)
            rigs.append(rig)
            out = {"cycle": provision_cycle(dev, card, rig, pods, rigs,
                                            launches)}
            clock_plan = out["cycle"].pop("plan")
            # (w8) holds its plan over HTTP against (w2)'s
            out["plan"] = clock_plan[1]
            out["failed_create"] = provision_failed_create(
                dev, card, rig, clock_plan, launches)
            out["limits"] = provision_limits(dev, card, pods, rigs,
                                             launches)
            out["after"] = provision_after(dev, card, rig, pods, rigs,
                                           launches)
    finally:
        for r in rigs:
            r.close()
    out["launches"] = launches
    out["host_s"] = time.perf_counter() - t_phase
    say(f"provision (w): {out['host_s']:.3f} s on {card}; launches "
        f"{launches} (ffd_scan {launches.get('ffd_scan', 0)}, cost_sum "
        f"{launches.get('cost_sum', 0)})")
    return out


def provision_cycle(dev, card, rig, pods, rigs, launches) -> dict:
    """(w2) The headline pods added through ``ClusterState.add_pod`` with
    the provisioner started: every pod nominated, every future of the
    window a claim name, the claims those of the CPU port's
    ``provision_once`` by pod set."""
    clock = CycleClock(rig.prov)
    rig.prov.start()
    futures: list = []
    add = rig.prov._window.add

    def add_kept(pod):
        fut = add(pod)
        futures.append(fut)
        return fut

    rig.prov._window.add = add_kept
    reset_launches()
    t0 = time.perf_counter()
    rig.add(pods)
    t_added = time.perf_counter()
    got = [f.result(timeout=PROVISION["deadline_s"]) for f in futures]
    t_done = time.perf_counter()
    cycle_launches = launch_counts()
    require_launches(cycle_launches, ["ffd_scan", "cost_sum"],
                     "provision (w2) cycle")
    add_launches(launches, cycle_launches)
    claims = {c.name: c for c in rig.cluster.nodeclaims()}
    if len(got) != len(pods) or any(g not in claims for g in got):
        bad = sum(1 for g in got if g not in claims)
        raise AssertionError(f"provision (w2): {len(got)} futures for "
                             f"{len(pods)} pods, {bad} without a claim")
    pending = rig.cluster.pending_pods()
    if len(pending) != len(pods) or not all(p.nominated_node
                                            for p in pending):
        raise AssertionError("provision (w2): a pod was not nominated")
    wall = clock.last_nominate - t0
    s = clock.s
    split = {"intake": clock.fired[0][0] - t0, "catalog": s["catalog"],
             "solve": s["solve"], "actuation": s["actuation"],
             "nomination": s["nomination"]}
    split["rest_of_window"] = s["window"] - sum(
        split[k] for k in ("catalog", "solve", "actuation", "nomination"))
    plan = clock.solves[0][1]
    clean_and_placed("provision (w2) plan", plan, pods, clock.solves[0][0]
                     .catalog, clock.solves[0][0].nodepool)
    t1 = time.perf_counter()
    cpu, cpu_plans = provision_cpu(pods)
    rigs.append(cpu)
    cpu_s = time.perf_counter() - t1
    if len(cpu_plans) != 1:
        raise AssertionError(f"provision (w2): the CPU port made "
                             f"{len(cpu_plans)} plans")
    plans_equal("provision (w2) plan against the CPU port's", plan,
                cpu_plans[0])
    if provision_claims(rig.cluster) != provision_claims(cpu.cluster):
        raise AssertionError("provision (w2): the claims differ from the "
                             "CPU port's by pod set")
    fired = [n for _, n in clock.fired]
    say(f"provision (w2) [{card}]: {len(pods)} headline pods through "
        f"ClusterState.add_pod with the Provisioner started (window idle "
        f"{rig.window['idle_seconds']} s, max {rig.window['max_seconds']} "
        f"s, max_pods {rig.window['max_pods']}): windows of {fired}; wall "
        f"from the first add to the last nomination {wall * 1e3:.3f} ms "
        f"(adds {(t_added - t0) * 1e3:.3f} ms, last future "
        f"{(t_done - t0) * 1e3:.3f} ms); split: intake "
        f"{split['intake'] * 1e3:.3f} ms, catalog resolve "
        f"{split['catalog'] * 1e3:.3f} ms, solve {split['solve'] * 1e3:.3f}"
        f" ms, actuation {split['actuation'] * 1e3:.3f} ms "
        f"({len(plan.nodes)} staged creates), nomination "
        f"{split['nomination'] * 1e3:.3f} ms, rest of the window "
        f"{split['rest_of_window'] * 1e3:.3f} ms; {len(claims)} claims, "
        f"{rig.cloud.instance_count()} instances in the fake cloud; every "
        f"pod nominated and every future a claim name; plan and claims "
        f"equal to the CPU port's provision_once by pod set ({cpu_s:.3f} s"
        f" on the host); launches {cycle_launches}")
    return {"wall_ms": wall * 1e3, "adds_ms": (t_added - t0) * 1e3,
            "futures_ms": (t_done - t0) * 1e3,
            "split_ms": {k: v * 1e3 for k, v in split.items()},
            "windows": fired, "claims": len(claims),
            "instances": rig.cloud.instance_count(), "nodes": len(plan.nodes),
            "cost": plan.total_cost_per_hour, "cpu_s": cpu_s,
            "launches": cycle_launches, "plan": (clock, plan)}


def provision_failed_create(dev, card, rig, clock_plan, launches) -> dict:
    """(w3) A capacity error injected on one offering of (w2)'s plan: a
    claim of (w2) is deleted (its instance first), its pods re-window,
    the create of that offering fails and blacks it out, the pods stay
    pending; the retry ticker re-windows them onto another offering.
    One availability upload of the catalog; the re-keyed plan is the CPU
    solver's."""
    clock, plan = clock_plan
    used = {(n.instance_type, n.zone, n.capacity_type) for n in plan.nodes}
    request = clock.solves[0][0]
    by_claim: dict = {}
    for p in rig.cluster.list("pods"):
        by_claim.setdefault(p.nominated_node, []).append(p.spec)
    victim = target = None
    for claim in rig.cluster.nodeclaims():
        orphans = by_claim.get(claim.name, [])
        probe = cpu_plan(SolveRequest(orphans, request.catalog,
                                      request.nodepool))
        first = probe.nodes[0]
        offering = (first.instance_type, first.zone, first.capacity_type)
        if offering in used:
            victim, target = claim, offering
            break
    if victim is None:
        raise AssertionError("provision (w3): no claim re-plans onto an "
                             "offering of (w2)'s plan")
    orphans = [pod_api.pod_key(p) for p in by_claim[victim.name]]
    failed: list = []
    create = rig.cloud.create_instance

    def create_or_fail(**kw):
        if (kw.get("profile"), kw.get("zone"),
                kw.get("capacity_type")) == target:
            failed.append(time.perf_counter())
            raise CloudError(f"insufficient capacity for {target}", 503,
                             code="insufficient_capacity", retryable=False)
        return create(**kw)

    rig.prov.stop()
    rig.prov.options.window = WindowOptions(**PROVISION["quick"])
    rig.prov.options.retry_interval = PROVISION["retry_s"]
    rig.prov.start()
    rig.cloud.create_instance = create_or_fail
    dt = get_devtel()
    uploads, nbytes = dt.catalog_uploads, dt.catalog_upload_bytes
    n_solves = len(clock.solves)
    reset_launches()
    try:
        rig.actuator.delete_node(victim)
    except NodeClaimNotFoundError:
        pass
    else:
        raise AssertionError("provision (w3): the claim's delete did not "
                             "verify the instance gone")
    t_delete = time.perf_counter()
    rig.cluster.delete("nodeclaims", victim.name)

    def recovered():
        return failed and all(
            rig.cluster.get("pods", k).nominated_node for k in orphans)

    deadline = time.perf_counter() + PROVISION["deadline_s"]
    while not recovered() and time.perf_counter() < deadline:
        time.sleep(0.005)
    t_done = time.perf_counter()
    rig.prov.stop()
    rig.cloud.create_instance = create
    got = launch_counts()
    add_launches(launches, got)
    if not failed:
        raise AssertionError(f"provision (w3): no create of {target} was "
                             f"tried after the re-window")
    if not recovered():
        raise AssertionError("provision (w3): the orphaned pods were not "
                             "re-nominated within the deadline")
    if not rig.unavail.is_unavailable(*target):
        raise AssertionError(f"provision (w3): {target} is not blacked out")
    claims = {c.name: c for c in rig.cluster.nodeclaims()}
    landed = set()
    for k in orphans:
        c = claims[rig.cluster.get("pods", k).nominated_node]
        landed.add((c.instance_type, c.zone, c.capacity_type))
    if target in landed:
        raise AssertionError(f"provision (w3): a pod landed on the "
                             f"blacked-out {target}")
    up = dt.catalog_uploads - uploads
    up_bytes = dt.catalog_upload_bytes - nbytes
    if up != 1:
        raise AssertionError(f"provision (w3): {up} catalog uploads, want "
                             f"one (the availability re-key)")
    catalog = rig.prov._catalog_for(rig.nodeclass)
    if catalog is not request.catalog:
        raise AssertionError("provision (w3): the blackout rebuilt the "
                             "catalog instead of re-keying its mask")
    rekeyed = [(req, p) for req, p in clock.solves[n_solves:]
               if not any(target == (n.instance_type, n.zone,
                                     n.capacity_type) for n in p.nodes)]
    if not rekeyed:
        raise AssertionError("provision (w3): no re-keyed plan")
    req, rplan = rekeyed[-1]
    plans_equal("provision (w3) re-keyed plan against the CPU solver's",
                rplan, cpu_plan(SolveRequest(list(req.pods), req.catalog,
                                             req.nodepool)))
    recovery = t_done - failed[0]
    say(f"provision (w3) [{card}]: claim {victim.name} deleted "
        f"({len(orphans)} pods re-windowed); {len(failed)} create(s) of "
        f"{'/'.join(target)} failed on an injected capacity error and "
        f"blacked it out; the retry ticker ({PROVISION['retry_s']} s, "
        f"window idle {PROVISION['quick']['idle_seconds']} s) re-windowed "
        f"the pods onto {sorted('/'.join(x) for x in landed)}; time to "
        f"recovery from the failed create {recovery * 1e3:.3f} ms (from "
        f"the claim's delete {(t_done - t_delete) * 1e3:.3f} ms); "
        f"{len(clock.solves) - n_solves} solves; availability uploads "
        f"{up} of {up_bytes} B; the re-keyed plan ({len(rplan.nodes)} "
        f"nodes: {[n.instance_type + '/' + n.zone + '/' + n.capacity_type for n in rplan.nodes]}) "
        f"equal to the CPU solver's; launches {got}")
    return {"recovery_ms": recovery * 1e3,
            "from_delete_ms": (t_done - t_delete) * 1e3,
            "failed_creates": len(failed), "orphans": len(orphans),
            "target": list(target), "landed": sorted(landed),
            "uploads": up, "upload_bytes": up_bytes,
            "solves": len(clock.solves) - n_solves, "launches": got}


def provision_limits(dev, card, pods, rigs, launches) -> dict:
    """(w4) On the first 2,000 headline pods: a pool whose cpu limit
    trims the card's plan (the dropped pods carry NodePoolLimitReached),
    and a soft-tainted heavy pool beside a capped general pool, which the
    pods it does not tolerate reach only in the second pass; each equal
    to the CPU port's."""
    small = pods[:PROVISION["small"]]
    key, value = PROVISION["soft_taint"]
    limit = PROVISION["cpu_limit_milli"]
    cases = {
        "limit": lambda: (NodePool(name="capped", nodeclass_name="default",
                                   cpu_limit_milli=limit),),
        "soft": lambda: (
            NodePool(name="gpu-pool", nodeclass_name="default", weight=100,
                     taints=(pod_api.Taint(key, value,
                                           "PreferNoSchedule"),)),
            NodePool(name="general", nodeclass_name="default", weight=10,
                     cpu_limit_milli=limit))}
    out = {}
    for name, pools in cases.items():
        rig = ProvisionRig(dev, pools=pools())
        rigs.append(rig)
        clock = CycleClock(rig.prov)
        rig.add(small)
        reset_launches()
        t0 = time.perf_counter()
        plans = rig.prov.provision_once()
        wall = time.perf_counter() - t0
        got = launch_counts()
        require_launches(got, ["ffd_scan", "cost_sum"],
                         f"provision (w4) {name}")
        add_launches(launches, got)
        cpu, cpu_plans = provision_cpu(small, pools=pools())
        rigs.append(cpu)
        if len(plans) != len(cpu_plans):
            raise AssertionError(f"provision (w4) {name}: {len(plans)} "
                                 f"plans, the CPU port {len(cpu_plans)}")
        for a, b in zip(plans, cpu_plans):
            plans_equal(f"provision (w4) {name}", a, b)
        if provision_claims(rig.cluster) != provision_claims(cpu.cluster):
            raise AssertionError(f"provision (w4) {name}: the claims differ "
                                 f"from the CPU port's")
        limited = sorted(e.name for e in rig.cluster.events
                         if e.reason == "NodePoolLimitReached")
        if limited != sorted(e.name for e in cpu.cluster.events
                             if e.reason == "NodePoolLimitReached"):
            raise AssertionError(f"provision (w4) {name}: the limit events "
                                 f"differ from the CPU port's")
        used = {}
        for c in rig.cluster.nodeclaims():
            ti = clock.solves[0][0].catalog.type_names.index(c.instance_type)
            used[c.nodepool_name] = used.get(c.nodepool_name, 0) + int(
                clock.solves[0][0].catalog.type_alloc[ti, 0])
        pools_seq = [req.nodepool.name for req, _ in clock.solves]
        nominated = sum(1 for p in rig.cluster.pending_pods()
                        if p.nominated_node)
        if name == "limit":
            if used.get("capped", 0) > limit or not limited:
                raise AssertionError(f"provision (w4) limit: {used} of "
                                     f"{limit} m, {len(limited)} limited "
                                     f"pods")
            say(f"provision (w4) limit [{card}]: pool 'capped' at "
                f"cpu_limit_milli {limit}: {used.get('capped', 0)} m "
                f"provisioned, {nominated} of {len(small)} pods nominated, "
                f"{len(limited)} pods with NodePoolLimitReached; plans, "
                f"claims and events equal to the CPU port's; "
                f"{wall * 1e3:.3f} ms; launches {got}")
        else:
            first, second = clock.solves[0][0], clock.solves[-1][0]
            pools_of = {pod_api.pod_key(p.spec): rig.cluster.get(
                "nodeclaims", p.nominated_node).nodepool_name
                for p in rig.cluster.pending_pods() if p.nominated_node}
            taint = (pod_api.Taint(key, value, "PreferNoSchedule"),)
            intolerant_heavy = [k for k, pool in pools_of.items()
                                if pool == "gpu-pool" and not
                                pod_api.tolerates_soft(
                                    rig.cluster.get("pods", k).spec
                                    .tolerations, taint)]
            second_keys = {pod_api.pod_key(p) for p in second.pods}
            if pools_seq != ["gpu-pool", "general", "gpu-pool"] or \
                    not all(pod_api.tolerates_soft(p.tolerations, taint)
                            for p in first.pods) or not intolerant_heavy \
                    or not set(intolerant_heavy) <= second_keys:
                raise AssertionError(
                    f"provision (w4) soft: solves {pools_seq}, "
                    f"{len(intolerant_heavy)} intolerant pods on the "
                    f"tainted pool")
            say(f"provision (w4) soft [{card}]: pools gpu-pool (weight 100,"
                f" {key}={value}:PreferNoSchedule) and general (weight 10, "
                f"cpu_limit_milli {limit}): solves {pools_seq} "
                f"({len(first.pods)} tolerant pods in pass 0, "
                f"{len(second.pods)} pods re-offered in pass 1); "
                f"{len(intolerant_heavy)} intolerant pods on gpu-pool, all "
                f"from pass 1; {nominated} of {len(small)} nominated; "
                f"plans, claims and events equal to the CPU port's; "
                f"{wall * 1e3:.3f} ms; launches {got}")
        out[name] = {"wall_ms": wall * 1e3, "solves": pools_seq,
                     "nominated": nominated, "limited": len(limited),
                     "cpu_used_milli": used, "launches": got}
    return out


def provision_after(dev, card, rig, pods, rigs, launches) -> dict:
    """(w5) After (w2)-(w3)'s plans: the kubelet joins every claim and the
    nominated pods bind; ``CloudProvider`` lists, gets and deletes; a new
    NodeClass image drifts every claim; then a provisioner with an
    ``IntentJournal`` dies at ``provision.pre_nominate`` and a new one
    recovers through ``Reconciler.recover()``: every pod nominated once,
    nothing leaked."""
    kubelet = FakeKubelet(rig.cluster, rig.cloud)
    joined = kubelet.join_pending(ready=True)
    bound = sum(1 for p in rig.cluster.list("pods") if p.bound_node)
    if bound != len(pods):
        raise AssertionError(f"provision (w5): {bound} of {len(pods)} pods "
                             f"bound after the join")
    cp = CloudProvider(rig.cluster, rig.actuator, rig.itp)
    listed = cp.list()
    live = [c for c in rig.cluster.nodeclaims() if not c.deleted]
    if len(listed) != len(live) or len(joined) != len(live):
        raise AssertionError(f"provision (w5): {len(listed)} listed, "
                             f"{len(joined)} joined, {len(live)} claims")
    for c in listed[:8]:
        if cp.get(c.provider_id) is not c:
            raise AssertionError(f"provision (w5): get({c.provider_id})")
    gone = listed[-1]
    try:
        cp.delete(gone)
    except NodeClaimNotFoundError:
        pass
    else:
        raise AssertionError("provision (w5): delete did not verify gone")
    try:
        cp.get(gone.provider_id)
    except NodeClaimNotFoundError:
        pass
    else:
        raise AssertionError("provision (w5): a deleted claim resolves")
    rig.cluster.delete("nodeclaims", gone.name)
    clean = sum(1 for c in cp.list() if cp.is_drifted(c))
    rig.nodeclass.status.resolved_image_id = "img-2"
    drifted = {cp.is_drifted(c) for c in cp.list()}
    rig.nodeclass.status.resolved_image_id = "img-1"
    if clean or drifted != {"ImageDrifted"}:
        raise AssertionError(f"provision (w5): drift {clean} before, "
                             f"{drifted} after the image change")
    leaks = no_leaks("provision (w5) after the plan", rig.cloud, rig.cluster)
    say(f"provision (w5) [{card}]: FakeKubelet joined {len(joined)} nodes "
        f"and bound {bound} pods; CloudProvider listed {len(listed)} "
        f"claims, got 8 by provider id, deleted one (verified gone); a new "
        f"NodeClass image drifted all {len(cp.list())} (ImageDrifted), none "
        f"before; no leak: {leaks}")
    return {"joined": len(joined), "bound": bound, "listed": len(listed),
            "drifted": len(cp.list()), "leaks": leaks,
            "recovery": provision_crash(dev, card, pods, rigs, launches)}


def provision_crash(dev, card, pods, rigs, launches) -> dict:
    small = pods[:PROVISION["small"]]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "journal.jsonl")
        rig = ProvisionRig(dev, journal=IntentJournal(path, owner="smoke"))
        rigs.append(rig)
        rig.add(small)
        inj = CrashInjector("provision.pre_nominate", seed=1,
                            first_hit_range=(1, 1), max_crashes=1)
        reset_launches()
        with crashpoints.installed(inj):
            try:
                rig.prov.provision_once()
            except SimulatedCrash:
                pass
            else:
                raise AssertionError("provision (w5): no crash at "
                                     "provision.pre_nominate")
        add_launches(launches, launch_counts())
        at_crash = sum(1 for p in rig.cluster.pending_pods()
                       if p.nominated_node)
        claims_at_crash = len(rig.cluster.nodeclaims())
        rig.journal.close()
        rig.restart(IntentJournal(path, owner="smoke"))
        t0 = time.perf_counter()
        report = Reconciler(rig.journal, rig.cloud, rig.cluster).recover()
        recover_s = time.perf_counter() - t0
        reset_launches()
        again = rig.prov.provision_once()
        add_launches(launches, launch_counts())
        live = {c.name for c in rig.cluster.nodeclaims() if not c.deleted}
        pending = rig.cluster.pending_pods()
        if again or at_crash or len(pending) != len(small) or not all(
                p.nominated_node in live for p in pending) or \
                report.nominations_restored != len(small):
            raise AssertionError(
                f"provision (w5) recovery: {at_crash} nominated at the "
                f"crash, {report.nominations_restored} restored, "
                f"{len(again)} plans after it")
        leaks = no_leaks("provision (w5) recovery", rig.cloud, rig.cluster)
        rig.journal.close()
    rep = report.to_dict()
    say(f"provision (w5) crash [{card}]: {len(small)} pods, the "
        f"provisioner killed at provision.pre_nominate with "
        f"{claims_at_crash} claims registered and {at_crash} pods "
        f"nominated; a new Provisioner and Reconciler.recover() "
        f"({recover_s * 1e3:.3f} ms): RecoveryReport {rep}; every pod "
        f"nominated once onto a live claim, no plan left to make, no "
        f"leak: {leaks}")
    return {"report": rep, "claims": claims_at_crash,
            "recover_ms": recover_s * 1e3, "leaks": leaks}


def phase_provision_fault(dev, card: str, pods) -> dict:
    """(w6) A scripted device fault during the provisioning loop's solve
    on the card (phase (s)'s injection): ``DeviceFaultError`` out of
    ``provision_once`` and into every future of a window on the watch
    path; no claim, no instance, no breadcrumb (no greedy plan)."""
    from karpenter_tpu_torch.faulttol import DeviceFaultError

    small = pods[:PROVISION["small"]]
    rig = ProvisionRig(dev, window=PROVISION["fault_window"])
    try:
        rig.add(small)
        with injected():
            ms = expect_fault("provision (w6) provision_once",
                              rig.prov.provision_once)
        before = degradation_marks()
        rig.prov.options.retry_interval = PROVISION["deadline_s"]
        with injected():
            rig.prov.start()
            futures = rig.prov._window.add_all(
                [p.spec for p in rig.cluster.pending_pods()])
            errors = 0
            for f in futures:
                try:
                    f.result(timeout=PROVISION["deadline_s"])
                except DeviceFaultError:
                    errors += 1
            rig.prov.stop()
        expect_marks("provision (w6) window", before, {})
        if errors != len(small) or rig.cluster.nodeclaims() or \
                rig.cloud.instance_count() or any(
                    p.nominated_node for p in rig.cluster.pending_pods()):
            raise AssertionError(
                f"provision (w6): {errors} of {len(small)} futures raised, "
                f"{len(rig.cluster.nodeclaims())} claims, "
                f"{rig.cloud.instance_count()} instances")
    finally:
        rig.close()
    say(f"provision (w6) [{card}]: a scripted device fault in the loop's "
        f"solve raised DeviceFaultError out of provision_once "
        f"({ms:.3f} ms) and into all {errors} futures of a window; no "
        f"claim, no instance, no nomination, no breadcrumb")
    return {"provision_once_ms": ms, "window_errors": errors}


# -- (x) the controllers ---------------------------------------------------------

CONTROLLERS = dict(
    # (x2): the disruption ticks after half the pods go, the fake clock
    # past the pool's 30 s consolidateAfter between them
    ticks=3, tick_s=31.0,
    # (x2)'s started window fires at its count only: idle and max past the
    # deadline, so a stall of the host between two adds (a collection of
    # the process's heap) cannot split the headline pods into two windows
    # that the CPU port's one provision_once does not see
    window=dict(idle_seconds=PROVISION["deadline_s"],
                max_seconds=PROVISION["deadline_s"], max_pods=10_000),
    # (x6): the small rigs of the faulted controllers
    fault_pods=600, fault_claims=8)
_TRACE = re.compile(r"trace=\d+")


class FixedIds:
    """Counters in place of ``uuid.uuid4`` and ``secrets.token_hex`` while
    a side of (x) runs: claim names and bootstrap tokens then follow the
    order of the creates, so the card's run and the CPU's name the same
    claims alike."""

    def __init__(self):
        self.n = self.t = 0

    def uuid4(self):
        self.n += 1
        return uuid.UUID(int=self.n << 96)

    def token_hex(self, nbytes=None):
        self.t += 1
        return f"{self.t:0{2 * (nbytes or 32)}x}"


@contextlib.contextmanager
def side_state():
    """One side's run on its own process state: fixed names, a fresh
    explain registry (its stamps dedupe the controllers' Unplaced events
    per pod key, and both sides use the same keys), a fresh placement
    ledger and a fresh spot risk model (the spot preemption controller
    stamps every live spot instance into the ledger each round and
    rebuilds the process's risk model from it, which prices the next
    catalog the provisioner resolves)."""
    from karpenter_tpu_torch import explain
    from karpenter_tpu_torch.stochastic import risk

    ids = FixedIds()
    saved = uuid.uuid4, secrets.token_hex, explain._REGISTRY, risk._MODEL
    uuid.uuid4, secrets.token_hex = ids.uuid4, ids.token_hex
    explain._REGISTRY = explain.ExplainRegistry()
    risk._MODEL = SpotRiskModel()
    try:
        with obs.use_ledger(PlacementLedger(max_open=INTAKE["max_open"])):
            yield ids
    finally:
        (uuid.uuid4, secrets.token_hex, explain._REGISTRY,
         risk._MODEL) = saved


@contextlib.contextmanager
def timed_methods(spans: dict, targets):
    """Host time in ``spans[label]`` of each (owner, attribute, label)
    while the block runs."""
    saved = []
    for owner, attr, label in targets:
        fn = getattr(owner, attr)
        saved.append((owner, attr, fn))

        def timed(*args, _fn=fn, _label=label, **kwargs):
            t0 = time.perf_counter()
            try:
                return _fn(*args, **kwargs)
            finally:
                spans[_label] = spans.get(_label, 0.0) + \
                    time.perf_counter() - t0

        setattr(owner, attr, timed)
    try:
        yield spans
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)


def controller_set(rig, clock, resident=False, gang_options=None,
                   preempt_options=None, repack_options=None):
    """The reference operator's registration list
    (``karpenter_tpu/operator/operator.py:189-255``) without the IKS,
    load-balancer and what-if entries, interruption, preemption and gang
    admission enabled and orphan cleanup off (its default); the repack
    enabled with no cooldown; the planning controllers on the rig's
    device and the time-gated ones on ``clock``."""
    cluster, cloud, actuator = rig.cluster, rig.cloud, rig.actuator
    cp = CloudProvider(cluster, actuator, rig.itp)
    return [
        NodeClassHashController(cluster),
        NodeClassStatusController(cluster, cloud,
                                  subnet_provider=actuator.subnets,
                                  image_resolver=actuator.images),
        AutoplacementController(cluster, rig.itp, actuator.subnets),
        NodeClassTerminationController(cluster),
        RegistrationController(cluster),
        StartupTaintController(cluster),
        NodeClaimTerminationController(cluster, actuator),
        GarbageCollectionController(cluster, cloud),
        TaggingController(cluster, cloud),
        SpotPreemptionController(cluster, cloud, rig.unavail),
        InstanceTypeRefreshController(rig.itp, rig.unavail),
        PricingRefreshController(rig.pricing),
        InterruptionController(cluster, rig.unavail, cloud=cloud),
        BootstrapTokenController(cluster, actuator.bootstrap.tokens),
        DisruptionController(cluster, cp, provisioner=rig.prov, clock=clock,
                             repack_enabled=True, repack_cooldown=0.0,
                             resident_occupancy=resident,
                             repack_options=repack_options,
                             device=rig.device),
        PreemptionController(cluster, rig.prov, clock=clock,
                             options=preempt_options, min_pending_age=0.0,
                             device=rig.device),
        GangAdmissionController(cluster, rig.prov, clock=clock,
                                options=gang_options, device=rig.device),
        OrphanCleanupController(cluster, cloud, enabled=False),
    ]


class ControllerRig(ProvisionRig):
    """(x1) A ``ProvisionRig`` with a ``ControllerManager`` (``AlwaysLeader``)
    carrying ``controller_set``; a fake clock for the time-gated
    controllers and a ``FakeKubelet``."""

    def __init__(self, device, resident=False, families=None, pools=(),
                 window=None, **ctrl_kw):
        super().__init__(device, pools=pools, families=families,
                         window=window, solver=SolverOptions(
                             resident="on" if resident else "off"))
        self.clock = ManualClock()
        self.kubelet = FakeKubelet(self.cluster, self.cloud)
        self.manager = ControllerManager(self.cluster,
                                         leader=AlwaysLeader().is_leader)
        self.ctrls = {}
        for c in controller_set(self, self.clock, resident=resident,
                                **ctrl_kw):
            self.manager.register(c)
            self.ctrls[c.name] = c


class ManualClock:
    """The time-gated controllers' clock: advanced by hand."""

    def __init__(self, t: float = 1_000_000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


def controller_world(rig) -> dict:
    """What the controllers changed: claims (by name, the names fixed),
    bindings and nominations, events, the fake cloud's calls and
    instances, the repack, eviction and placement logs."""
    ctrls = getattr(rig, "ctrls", {})
    out = {
        "claims": {c.name: (c.instance_type, c.zone, c.capacity_type,
                            c.nodepool_name, c.node_name, c.registered,
                            c.initialized, c.deleted)
                   for c in rig.cluster.nodeclaims()},
        "pods": {k: (p.bound_node, p.nominated_node,
                     p.spec.gang is None)
                 for k, p in sorted(rig.cluster._collections["pods"]
                                    .items())},
        "events": [(e.kind, e.name, e.type, e.reason,
                    _TRACE.sub("trace=*", e.message))
                   for e in rig.cluster.events],
        "calls": {k: len(v) for k, v in rig.cloud.recorder.calls.items()
                  if v},
        "instances": sorted((i.id, i.name, i.profile, i.zone,
                             i.capacity_type, i.status)
                            for i in rig.cloud.list_instances()),
        "unavailable": sorted(rig.unavail.unavailable_keys())}
    if "disruption" in ctrls:
        d = ctrls["disruption"]
        out["repack_log"] = [(r.migrations, r.drained, r.reopened,
                              r.savings_fraction) for r in d.repack_log]
        out["repack_violations"] = list(d.repack_violations)
    if "preemption" in ctrls:
        out["eviction_log"] = [
            (e.pod_key, e.victim_priority, e.beneficiary_priority,
             e.beneficiary, e.claim_name)
            for e in ctrls["preemption"].eviction_log]
    if "gang" in ctrls:
        g = ctrls["gang"]
        out["placement_log"] = [(r.gang, r.claim_name, r.members)
                                for r in g.placement_log]
        out["admitted"] = sorted(g.admitted)
        out["released"] = list(g.released)
    return out


def worlds_equal(label: str, card: dict, cpu: dict) -> None:
    for key in card:
        if card[key] != cpu.get(key):
            a, b = card[key], cpu.get(key)
            where = key
            if isinstance(a, dict) and isinstance(b, dict):
                bad = sorted(k for k in set(a) | set(b)
                             if a.get(k) != b.get(k))[:3]
                where = f"{key} {[(k, a.get(k), b.get(k)) for k in bad]}"
            elif isinstance(a, list) and isinstance(b, list):
                i = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                         min(len(a), len(b)))
                where = (f"{key}[{i}] of {len(a)} / {len(b)}: "
                         f"{a[i] if i < len(a) else None} / "
                         f"{b[i] if i < len(b) else None}")
            raise AssertionError(f"{label}: the card's run differs from "
                                 f"the CPU port's at {where}")


def x2_script(rig, pods, started: bool) -> dict:
    """(x2) on one rig: the pods provisioned (through the started watch
    path in one window, or ``provision_once`` on the CPU rig), joined and
    registered; half of them deleted; ``ticks`` disruption ticks ``tick_s``
    apart (the kubelet joins whatever a tick created); the blue/green
    proposal."""
    steps = {}
    t0 = time.perf_counter()
    if started:
        fired: list = []
        on_window = rig.prov._on_window

        def counted(batch):
            fired.append(len(batch))
            return on_window(batch)

        # the window binds its handler at start
        rig.prov._on_window = counted
        rig.prov.start()
        futures: list = []
        add = rig.prov._window.add

        def add_kept(pod):
            fut = add(pod)
            futures.append(fut)
            return fut

        rig.prov._window.add = add_kept
        rig.add(pods)
        got = [f.result(timeout=PROVISION["deadline_s"]) for f in futures]
        rig.prov.stop()
        del rig.prov._on_window
        if fired != [len(pods)]:
            raise AssertionError(f"controllers (x2): the started window "
                                 f"fired {fired}, want one of {len(pods)}")
        if len(got) != len(pods) or not all(got):
            raise AssertionError("controllers (x2): a pod of the started "
                                 "watch path was not nominated")
    else:
        rig.add(pods)
        rig.prov.provision_once()
    steps["provision_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    rig.kubelet.join_pending(ready=True)
    rig.manager.sync(rounds=1)
    steps["join_s"] = time.perf_counter() - t0
    before = controller_world(rig)
    t0 = time.perf_counter()
    for i, p in enumerate(pods):
        if i % 2 == 0:
            rig.cluster.delete("pods", pod_api.pod_key(p))
    for _ in range(CONTROLLERS["ticks"]):
        rig.kubelet.join_pending(ready=True)
        rig.manager.sync(rounds=1)
        rig.clock.t += CONTROLLERS["tick_s"]
    steps["ticks_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    proposal = rig.ctrls["disruption"].propose_repack()
    steps["proposal_s"] = time.perf_counter() - t0
    return {"steps": steps, "before": before, "world": controller_world(rig),
            "proposal": None if proposal is None else (
                proposal.current_cost, proposal.proposed_cost,
                plan_view(proposal.plan))}


def phase_controllers(dev, card: str, pods) -> dict:
    """(x) The controllers on the card (see the module docstring):
    (x1) the rig, (x2) consolidation and the repack with the resident
    occupancy view on and off, (x3) gang admission, (x4) preemption, (x5)
    a spot preemption; each against the same script on a CPU rig."""
    t_phase = time.perf_counter()
    launches: dict = {}
    rigs: list = []
    out: dict = {}
    try:
        out["x2"] = controllers_x2(dev, card, pods, rigs, launches)
        out["x5"] = controllers_spot(dev, card, out["x2"].pop("rigs"),
                                     launches)
        out["x3"] = controllers_gang(dev, card, rigs, launches)
        out["x4"] = controllers_preempt(dev, card, rigs, launches)
    finally:
        for r in rigs:
            r.close()
    out["launches"] = launches
    out["host_s"] = time.perf_counter() - t_phase
    say(f"controllers (x): {out['host_s']:.3f} s on {card}; launches "
        f"{launches} (ffd_scan {launches.get('ffd_scan', 0)}, cost_sum "
        f"{launches.get('cost_sum', 0)})")
    return out


def controllers_x2(dev, card, pods, rigs, launches) -> dict:
    """(x2) on the card with the resident occupancy view off and on, and
    on the CPU: one outcome; the card's share of the run by stage."""
    from karpenter_tpu_torch.repack.planner import RepackPlanner as RP
    from karpenter_tpu_torch.resident.store import (
        OccupancySnapshot, ResidentStore,
    )

    runs, walls, shares = {}, {}, {}
    for side, device, resident in (("card", dev, False),
                                   ("card-resident", dev, True),
                                   ("cpu", "cpu", False)):
        with side_state():
            rig = ControllerRig(device, resident=resident,
                                window=dict(CONTROLLERS["window"],
                                            max_pods=len(pods)))
        rigs.append(rig)
        spans: dict = {}
        targets = [(rig.prov.solver, "solve", "solve"),
                   (RP, "_score_grid", "repack grid"),
                   (OccupancySnapshot, "__init__", "occupancy"),
                   (ResidentStore, "occupancy_tensors", "occupancy")]
        reset_launches()
        t0 = time.perf_counter()
        with side_state(), timed_methods(spans, targets):
            runs[side] = x2_script(rig, pods, started=side != "cpu")
        walls[side] = time.perf_counter() - t0
        got = launch_counts()
        if side != "cpu":
            require_launches(got, ["ffd_scan", "cost_sum"],
                             f"controllers (x2) {side}")
            add_launches(launches, got)
            steps = rig.ctrls["disruption"]._repacker.primary.device_steps
            if steps < 1:
                raise AssertionError(f"controllers (x2) {side}: the repack "
                                     f"grid never ran on the card")
        shares[side] = dict(spans, launches=got)
    cpu = runs["cpu"]
    for side in ("card", "card-resident"):
        worlds_equal(f"controllers (x2) {side} before the ticks",
                     runs[side]["before"], cpu["before"])
        worlds_equal(f"controllers (x2) {side}", runs[side]["world"],
                     cpu["world"])
        if runs[side]["proposal"] != cpu["proposal"]:
            raise AssertionError(f"controllers (x2) {side}: the blue/green "
                                 f"proposal differs from the CPU port's")
    w, b = cpu["world"], cpu["before"]
    live = {n: c for n, c in w["claims"].items() if not c[7]}
    # deleted claims are finalized and leave the store
    gone = sum(1 for n in b["claims"] if n not in live)
    moved = sum(1 for k, v in w["pods"].items()
                if k in b["pods"] and b["pods"][k][0] and v[0]
                and v[0] != b["pods"][k][0])
    migrations = sum(len(r[0]) for r in w["repack_log"])
    if not gone or not w["repack_log"] and not moved:
        raise AssertionError(f"controllers (x2): the ticks retired {gone} "
                             f"claims and moved {moved} pods")
    prop = cpu["proposal"]
    for side in ("card", "card-resident"):
        sp, st = shares[side], runs[side]["steps"]
        total = walls[side]
        say(f"controllers (x2) {side} [{card}]: {len(pods)} headline pods "
            f"provisioned through the started watch path (one window at its "
            f"count) in "
            f"{st['provision_s'] * 1e3:.3f} ms, joined and registered in "
            f"{st['join_s'] * 1e3:.3f} ms; half deleted, "
            f"{CONTROLLERS['ticks']} ticks {CONTROLLERS['tick_s']} s apart "
            f"in {st['ticks_s'] * 1e3:.3f} ms, the blue/green proposal in "
            f"{st['proposal_s'] * 1e3:.3f} ms; run wall {total:.3f} s, of "
            f"it solve {sp.get('solve', 0.0) * 1e3:.3f} ms "
            f"({sp.get('solve', 0.0) / total:.4f}), repack grid "
            f"{sp.get('repack grid', 0.0) * 1e3:.3f} ms "
            f"({sp.get('repack grid', 0.0) / total:.4f}), occupancy "
            f"{sp.get('occupancy', 0.0) * 1e3:.3f} ms "
            f"({sp.get('occupancy', 0.0) / total:.4f}); launches "
            f"{sp['launches']}")
    say(f"controllers (x2) [{card}]: {len(b['claims'])} claims after the "
        f"join, {gone} retired by the ticks, {len(live)} live; {moved} "
        f"pods rebound by consolidation and the repack ({migrations} "
        f"repack migrations in {len(w['repack_log'])} plans, "
        f"{sum(len(r[1]) for r in w['repack_log'])} drained); proposal "
        f"{prop[0] if prop else None} -> {prop[1] if prop else None} $/h; "
        f"claims, bindings, nominations, events, cloud calls and logs "
        f"equal on the card with the occupancy view off and on and on the "
        f"CPU port ({walls['cpu']:.3f} s)")
    return {"walls_s": walls, "steps": {k: v["steps"] for k, v in
                                         runs.items()},
            "shares_s": {k: {a: b for a, b in v.items() if a != "launches"}
                         for k, v in shares.items()},
            "claims": len(b["claims"]), "retired": gone, "moved": moved,
            "migrations": migrations, "proposal": prop[:2] if prop else None,
            "rigs": {"card": rigs[0], "cpu": rigs[2]}}


def controllers_spot(dev, card, pair: dict, launches) -> dict:
    """(x5) On (x2)'s card rig and CPU rig: the fake cloud preempts the
    first live spot claim's instance; ``SpotPreemptionController`` blacks
    its offering out and deletes the claim, whose termination re-pends
    its pods; the next window re-keys the catalog's availability with one
    upload and its plan avoids the dark offering."""
    out = {}
    worlds = {}
    for side in ("card", "cpu"):
        rig = pair[side]
        spot = next((c for c in rig.cluster.nodeclaims()
                     if not c.deleted and c.capacity_type == "spot"), None)
        if spot is None:
            raise AssertionError("controllers (x5): no live spot claim")
        offering = (spot.instance_type, spot.zone, spot.capacity_type)
        dt = get_devtel()
        uploads, nbytes = dt.catalog_uploads, dt.catalog_upload_bytes
        reset_launches()
        t0 = time.perf_counter()
        with side_state() as ids:
            ids.n = 10 ** 6      # past every name the side minted
            rig.cloud.preempt_spot_instance(spot.provider_id.rsplit("/", 1)[1])
            rig.ctrls["spot.preemption"].reconcile()
            rig.ctrls["nodeclaim.termination"].reconcile(spot.name)
            repended = sum(1 for p in rig.cluster.pending_pods()
                           if not p.bound_node and not p.nominated_node)
            plans = rig.prov.provision_once()
        wall = time.perf_counter() - t0
        got = launch_counts()
        up = dt.catalog_uploads - uploads
        if not rig.unavail.is_unavailable(*offering):
            raise AssertionError(f"controllers (x5) {side}: {offering} is "
                                 f"not blacked out")
        if not plans or any((n.instance_type, n.zone, n.capacity_type)
                            == offering for p in plans for n in p.nodes):
            raise AssertionError(f"controllers (x5) {side}: the next window "
                                 f"planned nothing or the dark offering")
        if side == "card":
            require_launches(got, ["ffd_scan", "cost_sum"],
                             "controllers (x5)")
            add_launches(launches, got)
            if up != 1:
                raise AssertionError(f"controllers (x5): {up} catalog "
                                     f"uploads, want one")
            out = {"wall_ms": wall * 1e3, "uploads": up,
                   "upload_bytes": dt.catalog_upload_bytes - nbytes,
                   "offering": list(offering),
                   "nodes": sum(len(p.nodes) for p in plans),
                   "repended": repended,
                   "launches": got}
        worlds[side] = (controller_world(rig), [plan_view(p) for p in plans])
    worlds_equal("controllers (x5)", worlds["card"][0], worlds["cpu"][0])
    if worlds["card"][1] != worlds["cpu"][1]:
        raise AssertionError("controllers (x5): the re-keyed plan differs "
                             "from the CPU port's")
    say(f"controllers (x5) [{card}]: the fake cloud preempted a "
        f"{'/'.join(out['offering'])} instance; SpotPreemptionController "
        f"blacked the offering out and the termination re-pended its "
        f"{out['repended']} pods; the next window ({out['wall_ms']:.3f} ms "
        f"with the two reconciles) "
        f"uploaded the catalog's availability {out['uploads']} time "
        f"({out['upload_bytes']} B) and planned {out['nodes']} nodes, "
        f"none on the dark offering; equal to the CPU port's; launches "
        f"{out['launches']}")
    return out


def controllers_gang(dev, card, rigs, launches) -> dict:
    """(x3) ``run_gang``'s 64 gangs x 16 members on a rig of 500
    accelerator profiles: parked out of a window by
    ``provisioner.admission``, then one sync admits them, places the
    slice gangs through the card's gang planner and re-windows the
    plain gangs, which the next window places atomically.  The grid is
    forced onto the device as in (m): the planner's size rule
    (``use_device="auto"``) takes numpy below 2048 cells, and a
    controller's grid steps (open nodes x placements) stay below it at
    this shape."""
    pods = gang_pods(GANG)
    runs = {}
    for side, device in (("card", dev), ("cpu", "cpu")):
        with side_state():
            rig = ControllerRig(device, families=workload.ACCEL_FAMILIES,
                                gang_options=GangOptions(use_device="on"))
        rigs.append(rig)
        reset_launches()
        t0 = time.perf_counter()
        with side_state():
            rig.add(pods)
            parked = rig.prov.provision_once()
            rig.manager.sync(rounds=1)
            admitted = len(rig.ctrls["gang"].admitted)
            plans = rig.prov.provision_once()
            rig.kubelet.join_pending(ready=True)
            rig.manager.sync(rounds=1)
        wall = time.perf_counter() - t0
        got = launch_counts()
        planner = rig.ctrls["gang"].planner.primary
        if parked:
            raise AssertionError(f"controllers (x3) {side}: a window solved "
                                 f"parked gang members")
        if side == "card":
            if planner.device_steps < 1:
                raise AssertionError("controllers (x3): the gang grid never "
                                     "ran on the card")
            if plans:
                require_launches(got, ["ffd_scan", "cost_sum"],
                                 "controllers (x3) plain gangs")
            add_launches(launches, got)
        runs[side] = (controller_world(rig), [plan_view(p) for p in plans],
                      wall, planner.device_steps, got, admitted)
    worlds_equal("controllers (x3)", runs["card"][0], runs["cpu"][0])
    if runs["card"][1] != runs["cpu"][1]:
        raise AssertionError("controllers (x3): the plain gangs' plans "
                             "differ from the CPU port's")
    w = runs["card"][0]
    slice_placed = len(w["placement_log"])
    nominated = sum(1 for v in w["pods"].values() if v[1] or v[0])
    partial = 0
    for r in w["placement_log"]:
        if len(r[2]) != GANG["members"]:
            partial += 1
    if partial or not slice_placed:
        raise AssertionError(f"controllers (x3): {slice_placed} slice gangs "
                             f"placed, {partial} partial")
    say(f"controllers (x3) [{card}]: {GANG['gangs']} gangs x "
        f"{GANG['members']} members parked out of the first window; one "
        f"sync admitted {runs['card'][5]}, placed {slice_placed} slice "
        f"gangs whole ({runs['card'][3]} torch grid steps on the card) and "
        f"re-windowed the rest, which {len(runs['card'][1])} plan(s) placed; "
        f"{nominated} of {len(pods)} pods nominated or bound; "
        f"{runs['card'][2] * 1e3:.3f} ms; equal to the CPU port's; "
        f"launches {runs['card'][4]}")
    return {"wall_ms": runs["card"][2] * 1e3, "admitted": runs["card"][5],
            "slice_placed": slice_placed, "nominated": nominated,
            "device_steps": runs["card"][3], "launches": runs["card"][4]}


def fill_claims(rig, count: int, seed: int) -> None:
    """``bench.run_preempt``'s full claims on the rig's catalog: ``count``
    claims of the default pool, each ~96% full with three victims of
    priority 0 (3 in 4) or 100, bound through the cluster."""
    catalog = rig.prov._catalog_for(rig.nodeclass)
    rng = np.random.RandomState(seed)
    alloc = catalog.type_alloc
    hostable = [t for t in range(catalog.num_types)
                if alloc[t, 0] >= 2000 and alloc[t, 1] >= 4096]
    for i in range(count):
        t = hostable[rng.randint(len(hostable))]
        rig.cluster.add_nodeclaim(NodeClaim(
            name=f"pc{i}", nodeclass_name="default", nodepool_name="default",
            instance_type=catalog.type_names[t],
            zone=catalog.zones[rng.randint(len(catalog.zones))],
            node_name=f"node-pc{i}", launched=True))
        for j in range(3):
            name = f"v{i}-{j}"
            rig.cluster.add_pod(pod_api.PodSpec(
                name, requests=pod_api.ResourceRequests(
                    int(alloc[t, 0] * 0.32), int(alloc[t, 1] * 0.32), 0, 1),
                priority=int(rng.choice([0, 0, 0, 100]))))
            rig.cluster.bind_pod(f"default/{name}", f"node-pc{i}")


def controllers_preempt(dev, card, rigs, launches) -> dict:
    """(x4) 2,000 full claims and the pending pods of ``run_preempt``'s
    mix of sizes and priorities: one sync of the preemption controller
    plans on the card's fit grid and evicts within the pool's
    ``preemption_budget``."""
    runs = {}
    pending = preempt_pending(np.random.RandomState(PREEMPT["seed"]),
                              PREEMPT["pending"])
    for side, device in (("card", dev), ("cpu", "cpu")):
        with side_state():
            rig = ControllerRig(device)
        rigs.append(rig)
        fill_claims(rig, PREEMPT["claims"], PREEMPT["seed"])
        rig.add(pending)
        ctrl = rig.ctrls["preemption"]
        reset_launches()
        t0 = time.perf_counter()
        with side_state():
            ctrl.reconcile()
        wall = time.perf_counter() - t0
        got = launch_counts()
        if side == "card":
            require_no_launches(got, "controllers (x4)")
            if ctrl.planner.primary.device_steps < 1:
                raise AssertionError("controllers (x4): the fit grid never "
                                     "ran on the card")
        runs[side] = (controller_world(rig), wall,
                      ctrl.planner.primary.device_steps)
    worlds_equal("controllers (x4)", runs["card"][0], runs["cpu"][0])
    w = runs["card"][0]
    budget = NodePool(name="default").preemption_budget
    evicted = len(w["eviction_log"])
    if not evicted or evicted > budget:
        raise AssertionError(f"controllers (x4): {evicted} evictions, the "
                             f"budget {budget}")
    placed = sum(1 for k, v in w["pods"].items() if v[1])
    say(f"controllers (x4) [{card}]: {PREEMPT['claims']} full "
        f"claims, {len(pending)} pending pods: one reconcile "
        f"{runs['card'][1] * 1e3:.3f} ms, {evicted} evictions (budget "
        f"{budget}), {placed} beneficiaries nominated; "
        f"{runs['card'][2]} torch grid steps on the card; equal to the CPU "
        f"port's ({runs['cpu'][1] * 1e3:.3f} ms)")
    return {"wall_ms": runs["card"][1] * 1e3, "evictions": evicted,
            "budget": budget, "placed": placed,
            "device_steps": runs["card"][2]}


def phase_controllers_fault(dev, card: str, pods) -> dict:
    """(x6) One scripted device fault per planning controller (repack,
    gang, preemption) on a small rig with its grid forced onto the card:
    ``DeviceFaultError`` out of the wrapper, one
    ``ERRORS{controller.<name>, reconcile}`` from the manager, no claim,
    eviction or migration and no breadcrumb; the next sync after the
    fault plans on the card."""
    from karpenter_tpu_torch.faulttol import DeviceFaultError

    out = {}
    small = pods[:CONTROLLERS["fault_pods"]]
    never = (NodePool(name="default", nodeclass_name="default",
                      consolidation_policy="Never"),)
    cases = {
        "disruption": ("repack-grid", dict(pools=never, repack_options=
                                           RepackOptions(use_device="on"))),
        "gang": ("gang-grid", dict(families=workload.ACCEL_FAMILIES,
                                   gang_options=GangOptions(
                                       use_device="on"))),
        "preemption": ("preempt-grid", dict(preempt_options=PlannerOptions(
            use_device="on")))}
    for name, (site, kw) in cases.items():
        rig = ControllerRig(dev, **kw)
        try:
            ctrl = rig.ctrls[name]
            if name == "disruption":
                rig.add(small)
                rig.prov.provision_once()
                rig.kubelet.join_pending(ready=True)
                for claim in rig.cluster.nodeclaims():
                    rig.ctrls["nodeclaim.registration"].reconcile(claim.name)
                for i, p in enumerate(small):
                    if i % 2 == 0:
                        rig.cluster.delete("pods", pod_api.pod_key(p))
                ctrl.repack_rebuild = False
            elif name == "gang":
                rig.add([p for p in gang_pods(GANG)
                         if p.gang.slice_shape][:4 * GANG["members"]])
            else:
                fill_claims(rig, CONTROLLERS["fault_claims"],
                            PREEMPT["seed"])
                rig.add(preempt_pending(
                    np.random.RandomState(PREEMPT["seed"]), 64))
            mgr = ControllerManager(rig.cluster)
            mgr.register(ctrl)
            planner = (ctrl._repacker.primary if name == "disruption"
                       and ctrl._repacker is not None else None)
            before = {k: v for k, v in controller_world(rig).items()
                      if k in ("claims", "pods", "instances")}
            marks = degradation_marks()
            errors = metrics.ERRORS.samples()
            with injected(site) as inj:
                try:
                    ctrl.reconcile()
                except DeviceFaultError:
                    pass
                else:
                    raise AssertionError(f"controllers (x6) {name}: the "
                                         f"fault did not raise")
                inj.injected = 0
                mgr.sync(rounds=1)
            moved = {k: v - errors.get(k, 0.0)
                     for k, v in metrics.ERRORS.samples().items()
                     if v != errors.get(k, 0.0)}
            counted = moved.get((f"controller.{name}", "reconcile"), 0.0)
            after = {k: v for k, v in controller_world(rig).items()
                     if k in ("claims", "pods", "instances")}
            expect_marks(f"controllers (x6) {name}", marks, {})
            if counted != 1.0 or after != before:
                raise AssertionError(
                    f"controllers (x6) {name}: {counted} reconcile errors "
                    f"counted, the world {'moved' if after != before else 'stood'}")
            planner = ctrl._repacker.primary if name == "disruption" \
                else ctrl.planner.primary
            steps = planner.device_steps
            t0 = time.perf_counter()
            mgr.sync(rounds=1)
            wall = time.perf_counter() - t0
            if planner.device_steps <= steps:
                raise AssertionError(f"controllers (x6) {name}: the sync "
                                     f"after the fault did not plan on the "
                                     f"card")
            out[name] = {"site": site, "counted": counted,
                         "next_sync_ms": wall * 1e3,
                         "grid_steps": planner.device_steps - steps}
        finally:
            rig.close()
    syncs = ", ".join(f"{k} {v['next_sync_ms']:.3f} ms"
                      for k, v in out.items())
    say(f"controllers (x6) [{card}]: a scripted device fault at each of "
        f"{[v['site'] for v in out.values()]} raised DeviceFaultError out "
        f"of its controller's planner; the manager counted one "
        f"ERRORS{{controller.<name>, reconcile}} each; no claim, eviction or "
        f"migration, no breadcrumb; the next syncs planned on the card "
        f"({syncs})")
    return out


# -- (y) the gRPC solver sidecar on the card -----------------------------------

SIDECAR = dict(walls=10, handle_k=(1, 10), handle_reps=20)


class WireLog:
    """Records every request and reply a client's three byte methods
    carry, so that the same request bytes can be replayed elsewhere."""

    def __init__(self, client):
        self.calls: list[tuple[str, bytes, bytes]] = []
        for method in ("_upload", "_solve", "_solve_batch"):
            setattr(client, method, self._wrap(method,
                                               getattr(client, method)))

    def _wrap(self, method: str, fn):
        def call(request: bytes) -> bytes:
            reply = fn(request)
            self.calls.append((method, request, reply))
            return reply

        return call


def sidecar_windows(pods, catalog) -> dict:
    """(y)'s windows: the headline, the flat seed-7 window, the pref
    window and the zone-candidate window, each (request, route need)."""
    flat_pods, flat_cat = workload.build_hetero_workload(
        HEADLINE["pods"], HEADLINE["types"], **FLAT_WINDOWS[0])
    return {
        "headline": (SolveRequest(pods, catalog), ("ffd_scan", "cost_sum")),
        "flat seed 7": (SolveRequest(flat_pods, flat_cat),
                        ("segment_sum", "cost_sum")),
        "pref": (SolveRequest(workload.with_preferences(pods), catalog),
                 ("ffd_scan_pref", "presence_sum", "cost_sum")),
        "zone batch": (SolveRequest(zone_window(pods), catalog),
                       ("ffd_scan", "ffd_scan_fleet", "cost_sum"))}


def replay_words(label: str, log: WireLog, plain) -> int:
    """Every logged request replayed into ``plain`` (the byte handlers on
    the CPU): each reply's arrays must equal the card's, word for word.
    Returns the number of compared replies."""
    from karpenter_tpu_torch.service import _unpack

    compared = 0
    for method, request, reply in log.calls:
        want = getattr(plain, method)(request)
        if method == "_upload":
            continue
        got, ref = _unpack(reply), _unpack(want)
        if sorted(got) != sorted(ref):
            raise AssertionError(f"sidecar {label}: reply arrays "
                                 f"{sorted(got)} vs {sorted(ref)}")
        for k in ref:
            if got[k].dtype != ref[k].dtype or \
                    not np.array_equal(got[k], ref[k]):
                raise AssertionError(f"sidecar {label}: reply {k!r} "
                                     f"differs from the plain CPU "
                                     f"handlers'")
        compared += 1
    return compared


def phase_sidecar(dev, card: str, pods, catalog) -> dict:
    """(y) The sidecar on the card (under the gate): whether this machine
    imports ``grpc`` (it must); ``SolverServer(device="cuda")`` on
    127.0.0.1 and ``RemoteSolver`` over the socket; the headline, flat
    seed-7, pref and
    zone-candidate windows, each plan equal to ``TorchSolver(device=
    "cuda")``'s, each reply's arrays equal to the plain CPU handlers' on
    the same request bytes, the route's kernels launched;
    ``compute_handle``'s words equal to the headline dispatch's, its
    device time per call at k = 1 and 10 beside the remote and local p50
    walls (not gated)."""
    import importlib.util

    from karpenter_tpu_torch import service as sidecar

    has_grpc = importlib.util.find_spec("grpc") is not None
    say(f"sidecar (y) [{card}]: importlib.util.find_spec('grpc') is "
        f"{'found' if has_grpc else 'None'} on this machine")
    if not has_grpc:
        raise RuntimeError("sidecar (y): grpc is not installed on this "
                           "machine; the sidecar cannot serve")
    server = sidecar.SolverServer(device=dev).start()
    client = sidecar.RemoteSolver(f"127.0.0.1:{server.port}")
    transport = f"gRPC socket 127.0.0.1:{server.port}"
    plain = sidecar.SolverHandlers(device="cpu")
    out = {"grpc": has_grpc, "transport": transport, "windows": {}}
    launches_all: dict = {}
    try:
        for label, (request, need) in sidecar_windows(pods,
                                                      catalog).items():
            log = WireLog(client)
            reset_launches()
            t0 = time.perf_counter()
            plan = client.solve(request)
            wall = time.perf_counter() - t0
            launches = launch_counts()
            require_launches(launches, need, f"sidecar {label}")
            add_launches(launches_all, launches)
            local = TorchSolver(device=dev).solve(request)
            plans_equal(f"sidecar {label}", plan, local)
            if plan.backend != "remote":
                raise AssertionError(f"sidecar {label}: backend "
                                     f"{plan.backend!r}")
            replies = replay_words(label, log, plain)
            methods = sorted({m for m, _, _ in log.calls})
            out["windows"][label] = {
                "wall_ms": wall * 1e3, "launches": launches,
                "replies": replies, "methods": methods,
                "nodes": len(plan.nodes),
                "cost": plan.total_cost_per_hour}
            say(f"sidecar (y) {label}: {len(request.pods)} pods, "
                f"{len(plan.nodes)} nodes, cost "
                f"{plan.total_cost_per_hour:.4f} $/h, plan equal to "
                f"TorchSolver(cuda)'s, {replies} reply(s) equal word for "
                f"word to the plain CPU handlers', methods {methods}, "
                f"first call {wall * 1e3:.3f} ms, launches {launches}")
        if "_solve_batch" not in out["windows"]["zone batch"]["methods"]:
            raise AssertionError("sidecar zone batch: no SolveBatch call")
        head = SolveRequest(pods, catalog)
        solver = TorchSolver(device=dev)
        remote_walls, local_walls = [], []
        for _ in range(SIDECAR["walls"]):
            t0 = time.perf_counter()
            client.solve(head)
            remote_walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            solver.solve(head)
            local_walls.append(time.perf_counter() - t0)
        problem = encode_mod.encode(pods, catalog)
        words = solver.dispatch_packed(solver._prepare(problem)).cpu()
        reset_launches()
        run = solver.compute_handle(problem)
        got = run(1).cpu()
        if not torch.equal(got, words):
            raise AssertionError("compute_handle: words differ from the "
                                 "headline dispatch's")
        require_launches(launch_counts(), ("ffd_scan", "cost_sum"),
                         "compute_handle")
        handle_ms = {}
        for k in SIDECAR["handle_k"]:
            handle_ms[k] = cuda_ms(lambda k=k: run(k),
                                   SIDECAR["handle_reps"]) / k
        out.update(remote_p50_ms=p50_ms(remote_walls),
                   local_p50_ms=p50_ms(local_walls),
                   compute_handle_ms=handle_ms,
                   launches=launches_all)
        say(f"sidecar (y) [{card}] over the {transport}: headline p50 "
            f"{p50_ms(remote_walls):.3f} ms remote beside "
            f"{p50_ms(local_walls):.3f} ms TorchSolver.solve "
            f"({SIDECAR['walls']} each, in turns); compute_handle words "
            f"equal the headline dispatch's, device time per call "
            f"{handle_ms[1]:.4f} ms at k = 1, {handle_ms[10]:.4f} ms at "
            f"k = 10 (not gated)")
    finally:
        client.close()
        server.stop()
    return out


def phase_sidecar_fault(dev, card: str, pods, catalog) -> dict:
    """(y6) One scripted device fault in the sidecar's solve, through
    ``make_solver(SolverOptions(backend="remote"))``: it raises to the
    client (the server's error status over gRPC), the guard counts it
    once, and no breadcrumb moves."""
    import grpc

    from karpenter_tpu_torch import service as sidecar

    request = SolveRequest(pods, catalog)
    server = sidecar.SolverServer(device=dev).start()
    solver = make_solver(SolverOptions(
        backend="remote", address=f"127.0.0.1:{server.port}"))
    try:
        solver.solve(request)                # learns the server's device
        if solver.primary.device is None or \
                solver.primary.device.type != dev.type:
            raise AssertionError(f"sidecar (y6): the server named "
                                 f"{solver.primary.device}")
        marks = degradation_marks()
        errors = metrics.ERRORS.samples()
        t0 = time.perf_counter()
        with injected("scan"):
            try:
                solver.solve(request)
            except grpc.RpcError as e:
                what = f"{type(e).__name__}: {e.details()[:120]}"
            else:
                raise AssertionError("sidecar (y6): the fault did not "
                                     "raise to the client")
        wall = time.perf_counter() - t0
        expect_marks("sidecar (y6)", marks, {})
        moved = {k: v - errors.get(k, 0.0)
                 for k, v in metrics.ERRORS.samples().items()
                 if v != errors.get(k, 0.0)}
        counted = sum(v for (c, _), v in moved.items() if c == "device")
        if counted != 1.0:
            raise AssertionError(f"sidecar (y6): the fault was counted "
                                 f"{counted} times: {moved}")
        after = solver.solve(request)
    finally:
        solver.close()
        server.stop()
    say(f"sidecar (y6) [{card}]: a scripted device fault in the sidecar's "
        f"solve raised to make_solver(remote)'s caller ({what}), counted "
        f"once by the guard, no breadcrumb, {wall * 1e3:.3f} ms; the next "
        f"window planned {len(after.nodes)} nodes")
    return {"raised": what, "counted": counted, "wall_ms": wall * 1e3}


# -- (z) the chaos harness on the card -------------------------------------------

CHAOS = dict(profiles=("calm", "shard-skew", "affinity"), seed=1, rounds=10,
             serving="serving-storm")


def chaos_planes(harness) -> dict:
    """The device each of a harness's device planes ran on."""
    out = {"resident": str(harness.resident.device)}
    if harness.sharded is not None:
        out["sharded"] = str(harness.sharded.device)
    if harness.serving is not None:
        out["serving"] = str(harness.serving.solver.device)
    return out


def chaos_pair(dev, label: str, profile) -> dict:
    """One scenario on the card and on the CPU in this process: zero
    violations on the card, the same digest on both."""
    from karpenter_tpu_torch.chaos.runner import run_scenario

    reset_launches()
    t0 = time.perf_counter()
    res = run_scenario(profile, CHAOS["seed"], rounds=CHAOS["rounds"],
                       device=dev)
    wall = time.perf_counter() - t0
    launches = launch_counts()
    t0 = time.perf_counter()
    cpu = run_scenario(profile, CHAOS["seed"], rounds=CHAOS["rounds"],
                       device="cpu")
    cpu_wall = time.perf_counter() - t0
    if not res.ok:
        raise AssertionError(f"chaos {label} on the card: "
                             f"{res.render_failure()}")
    if res.digest != cpu.digest:
        raise AssertionError(f"chaos {label}: the card's digest "
                             f"{res.digest[:12]} != the CPU's "
                             f"{cpu.digest[:12]}")
    planes = chaos_planes(res.harness)
    if any(not d.startswith(dev.type) for d in planes.values()):
        raise AssertionError(f"chaos {label}: a plane ran off {dev}: "
                             f"{planes}")
    say(f"chaos (z) {label}: seed {CHAOS['seed']}, {CHAOS['rounds']} "
        f"rounds, {len(res.trace)} events, 0 violations, digest "
        f"{res.digest[:12]} equal to the CPU harness's; planes {planes}; "
        f"wall {wall:.3f} s on the card, {cpu_wall:.3f} s on the CPU; "
        f"launches {launches}")
    return {"wall_s": wall, "cpu_wall_s": cpu_wall, "launches": launches,
            "events": len(res.trace), "digest": res.digest,
            "planes": planes}


def phase_chaos(dev, card: str) -> dict:
    """(z) The chaos harness with its device planes on the card (under
    the gate): ``calm``, ``shard-skew`` and ``affinity`` at seed 1, and
    ``serving-storm`` with its device faults taken out (a changed
    profile), each with zero violations and the CPU harness's digest;
    ``ffd_scan_fleet`` launched by the sharded plane, ``ffd_scan`` by
    the serving ring."""
    from karpenter_tpu_torch.chaos.profile import get_profile

    out, total = {}, {}
    for name in CHAOS["profiles"]:
        out[name] = chaos_pair(dev, name, name)
        add_launches(total, out[name]["launches"])
    require_launches(out["shard-skew"]["launches"],
                     ("ffd_scan_fleet", "cost_sum"), "chaos shard-skew")
    quiet = dataclasses.replace(get_profile(CHAOS["serving"]),
                                device_fault_rates={})
    say(f"chaos (z): {CHAOS['serving']} runs as a changed profile, its "
        f"device_fault_rates set to {{}} (dataclasses.replace), so the "
        f"serving ring runs on the card with no fault")
    label = f"{CHAOS['serving']} without device faults"
    out[label] = chaos_pair(dev, label, quiet)
    add_launches(total, out[label]["launches"])
    require_launches(out[label]["launches"], ("ffd_scan", "cost_sum"),
                     f"chaos {label}")
    walls = ", ".join(f"{k} {v['wall_s']:.3f} s" for k, v in out.items())
    say(f"chaos (z) [{card}]: ffd_scan {total.get('ffd_scan', 0)} and "
        f"ffd_scan_fleet {total.get('ffd_scan_fleet', 0)} launches over "
        f"the phase; walls {walls}")
    return {"scenarios": out, "launches": total}


def phase_chaos_fault(dev, card: str) -> dict:
    """(z6) ``device-fault`` at seed 1 with its planes on the card: the
    first injected fault raises ``DeviceFaultError`` out of
    ``run_scenario``, the guard counts it once, no breadcrumb moves and
    no window went to the host route."""
    from karpenter_tpu_torch import faulttol
    from karpenter_tpu_torch.chaos.runner import run_scenario
    from karpenter_tpu_torch.faulttol import DeviceFaultError
    from karpenter_tpu_torch.faulttol import health as health_mod

    marks = degradation_marks()
    errors = metrics.ERRORS.samples()
    host = metrics.SHARDED_SOLVES.get("host")
    t0 = time.perf_counter()
    try:
        run_scenario("device-fault", CHAOS["seed"], rounds=CHAOS["rounds"],
                     device=dev)
    except DeviceFaultError as e:
        what = f"{e.kind} at {e.kernel!r}"
    else:
        raise AssertionError("chaos (z6): device-fault ran to its end on "
                             "the card; an injected fault must raise")
    finally:
        # the scenario raised before its quiesce disarmed the profile's
        # injector: take it out, and the health board it wrote, so that
        # no later phase draws a fault
        faulttol.clear_injector()
        health_mod._BOARD = None
    wall = time.perf_counter() - t0
    expect_marks("chaos (z6)", marks, {})
    moved = {k: v - errors.get(k, 0.0)
             for k, v in metrics.ERRORS.samples().items()
             if v != errors.get(k, 0.0)}
    counted = sum(v for (c, _), v in moved.items() if c == "device")
    if counted != 1.0 or metrics.SHARDED_SOLVES.get("host") != host:
        raise AssertionError(f"chaos (z6): counted {counted} faults "
                             f"({moved}), host-route windows "
                             f"{metrics.SHARDED_SOLVES.get('host') - host}")
    say(f"chaos (z6) [{card}]: device-fault at seed {CHAOS['seed']} "
        f"raised DeviceFaultError ({what}) out of run_scenario after "
        f"{wall:.3f} s, counted once by the guard, no breadcrumb, no "
        f"window on the host route")
    return {"raised": what, "counted": counted, "wall_s": wall}


# -- (l2), (l6) the what-if planning service ---------------------------------

WHATIF_SERVICE = dict(seed=17, hour=9, hours=24, ticks=3)
# the standing menu's scenarios, the blackout's zone seeded
WHATIF_MENU = ("baseline", "forecast-peak", "spot-storm", "zone-blackout",
               "pool-shrink")
# the payload's fields that read a clock
WALL_FIELDS = ("plan_seconds", "wall_seconds", "built_at", "created_at")


class PendingPods:
    """Just enough cluster for ``PlanningService``: a fixed pending set
    (the reference CLI's stub), so no arrival is stamped at the clock."""

    def __init__(self, pods):
        self._pods = [SimpleNamespace(spec=p) for p in pods]

    def pending_pods(self):
        return list(self._pods)

    def list(self, kind, predicate=None):
        return []

    def get_nodeclass(self, name):
        return None


def seed_arrivals(ledger, pods, seed: int) -> int:
    """The shape of the reference CLI's ``_seeded_world``: 0-2 arrivals of
    every signature group in each of 24 virtual hours."""
    rng = random.Random(seed * 31)
    sigs = sorted({p.signature_key() for p in pods})
    n = 0
    for hour in range(WHATIF_SERVICE["hours"]):
        for sig in sigs:
            for _ in range(rng.randint(0, 2)):
                ledger.arrival(sig, t=hour * 3600.0)
                n += 1
    return n


def without_walls(obj):
    """A payload with every field that reads a clock taken out."""
    if isinstance(obj, dict):
        return {k: without_walls(v) for k, v in obj.items()
                if k not in WALL_FIELDS}
    if isinstance(obj, list):
        return [without_walls(v) for v in obj]
    return obj


@contextlib.contextmanager
def pinned_hour(hour: int):
    """The service's clock read at ``hour`` o'clock of a virtual day: a
    periodic tick takes its hour from the clock."""
    from karpenter_tpu_torch.whatif import service as service_mod

    saved = service_mod.now
    service_mod.now = lambda: hour * 3600.0
    try:
        yield
    finally:
        service_mod.now = saved


def whatif_side(device, pods, catalog, validate=True) -> SimpleNamespace:
    """One side's service over the headline pods and a ledger seeded with
    arrivals; the stacked plan's launches kept apart from the rest."""
    ledger = PlacementLedger()
    arrivals = seed_arrivals(ledger, pods, WHATIF_SERVICE["seed"])
    cluster = PendingPods(pods)
    with obs.use_ledger(ledger):
        svc = whatif.PlanningService(
            cluster, catalog_fn=lambda: catalog,
            seed=WHATIF_SERVICE["seed"], validate=validate, device=device)
    side = SimpleNamespace(ledger=ledger, cluster=cluster, svc=svc,
                           arrivals=arrivals, plan_launches=[], plans=[])
    plan = svc.planner.plan

    def counted(baseline, scenarios):
        before = launch_counts()
        try:
            out = plan(baseline, scenarios)
            side.plans.append(out)
            return out
        finally:
            after = launch_counts()
            side.plan_launches.append(
                {k: v - before[k] for k, v in after.items()})

    svc.planner.plan = counted
    return side


def whatif_ticks(side, n: int) -> list:
    """``n`` ``WhatIfController`` ticks through a ``ControllerManager`` of
    the side's own at the pinned hour: the registry's size after each."""
    mgr = ControllerManager(side.cluster)
    mgr.register(WhatIfController(side.svc))
    sizes = []
    with obs.use_ledger(side.ledger), pinned_hour(WHATIF_SERVICE["hour"]):
        for _ in range(n):
            mgr.sync(rounds=1)
            sizes.append(len(side.svc.recommendations()))
    return sizes


def whatif_errors() -> dict:
    return {k: v for (c, k), v in metrics.ERRORS.samples().items()
            if c == "whatif"}


def phase_whatif_service(dev, card: str, pods, catalog) -> dict:
    """(l2) ``PlanningService`` over the headline's pending pods on the
    card: the standing menu in one stacked plan (one ``ffd_scan_fleet``,
    one ``cost_sum``), the fresh single solves of ``validate=True``, the
    payload and digest equal to the CPU port's; three
    ``WhatIfController`` ticks through a ``ControllerManager``."""
    t_phase = time.perf_counter()
    errors0 = whatif_errors()
    hour = WHATIF_SERVICE["hour"]
    card_side = whatif_side(dev, pods, catalog)
    reset_launches()
    t0 = time.perf_counter()
    with obs.use_ledger(card_side.ledger):
        payload = card_side.svc.evaluate(record=True, hour=hour)
    wall = time.perf_counter() - t0
    total = launch_counts()
    stacked = card_side.plan_launches[0]
    if {k: v for k, v in stacked.items() if v} != \
            {"ffd_scan_fleet": 1, "cost_sum": 1} or \
            payload["dispatches"] != 1 or payload["backend"] != "device":
        raise AssertionError(f"what-if service (l2): the stacked plan took "
                             f"{payload['dispatches']} solves on "
                             f"{payload['backend']!r} and launched "
                             f"{stacked}, want one ffd_scan_fleet and one "
                             f"cost_sum on the device")
    replay = {k: v - stacked[k] for k, v in total.items()}
    names = [s["scenario"].split(":")[0] for s in payload["scenarios"]]
    if tuple(names) != WHATIF_MENU:
        raise AssertionError(f"what-if service (l2): the menu is {names}, "
                             f"want {list(WHATIF_MENU)}")
    if payload["validation"]["violations"]:
        raise AssertionError(f"what-if service (l2): validate_whatif: "
                             f"{payload['validation']['violations'][:3]}")
    K = len(names)
    require_launches(replay, ["ffd_scan", "cost_sum"],
                     "what-if service (l2) replay")
    if replay["ffd_scan"] != K:
        raise AssertionError(f"what-if service (l2): the replay launched "
                             f"{replay}, want one ffd_scan per scenario")
    t1 = time.perf_counter()
    cpu_side = whatif_side("cpu", pods, catalog)
    with obs.use_ledger(cpu_side.ledger):
        cpu_payload = cpu_side.svc.evaluate(record=True, hour=hour)
    cpu_s = time.perf_counter() - t1
    if without_walls(payload) != without_walls(cpu_payload):
        diff = [k for k in payload
                if without_walls(payload[k]) != without_walls(cpu_payload[k])]
        raise AssertionError(f"what-if service (l2): the payload differs "
                             f"from the CPU port's in {diff}")
    digest = card_side.svc.digest()
    if digest != cpu_side.svc.digest():
        raise AssertionError("what-if service (l2): the digest differs from "
                             "the CPU port's")
    reset_launches()
    t0 = time.perf_counter()
    sizes = whatif_ticks(card_side, WHATIF_SERVICE["ticks"])
    ticks_s = time.perf_counter() - t0
    tick_launches = launch_counts()
    cpu_sizes = whatif_ticks(cpu_side, WHATIF_SERVICE["ticks"])
    if sizes != cpu_sizes or card_side.svc.digest() != \
            cpu_side.svc.digest() or sizes[-1] <= len(
                payload["recommendations"]):
        raise AssertionError(f"what-if service (l2): the registry after "
                             f"each tick {sizes}, on the CPU {cpu_sizes}")
    require_launches(tick_launches, ["ffd_scan_fleet", "cost_sum"],
                     "what-if service (l2) ticks")
    if whatif_errors() != errors0 or card_side.svc.snapshot()[
            "degraded_plans"]:
        raise AssertionError(f"what-if service (l2): a planning error was "
                             f"counted: {whatif_errors()}")
    launches = {k: total[k] + tick_launches[k] for k in total}
    out = {"launches": launches, "stacked_launches": stacked,
           "replay_launches": replay, "tick_launches": tick_launches,
           "scenarios": names, "K": K, "arrivals": card_side.arrivals,
           "recommendations": len(payload["recommendations"]),
           "registry": sizes, "digest": digest,
           "evaluate_ms": wall * 1e3,
           "plan_ms": payload["plan_seconds"] * 1e3,
           "cpu_evaluate_s": cpu_s, "ticks_s": ticks_s,
           "horizon_risk": payload["horizon_risk"],
           "host_s": time.perf_counter() - t_phase}
    say(f"what-if service (l2) [{card}]: PlanningService over "
        f"{payload['pending_pods']} pending pods x {catalog.num_types} "
        f"types, ledger seeded with {card_side.arrivals} arrivals over 24 "
        f"virtual hours, hour {hour}: menu {names} in one stacked plan "
        f"(launches {stacked}), validate=True replay launches {replay}; "
        f"{out['recommendations']} recommendations, horizon risk "
        f"{payload['horizon_risk']}; payload (clock fields aside) and "
        f"digest {digest[:12]} equal to the CPU port's ({cpu_s:.3f} s on "
        f"the host); evaluate {wall * 1e3:.3f} ms (stacked plan "
        f"{out['plan_ms']:.3f} ms); {WHATIF_SERVICE['ticks']} "
        f"WhatIfController ticks in {ticks_s:.3f} s, registry {sizes} as "
        f"on the CPU, launches {tick_launches}")
    return out


def phase_whatif_fault(dev, card: str, pods, catalog) -> dict:
    """(l6) A scripted device fault at the ``whatif`` guard site:
    ``evaluate`` raises ``DeviceFaultError``; a ``WhatIfController`` tick
    counts ``ERRORS{whatif, DeviceFaultError}`` once and records nothing;
    no breadcrumb, no host plan; the next clean tick records."""
    from karpenter_tpu_torch.faulttol import DeviceFaultError

    side = whatif_side(dev, pods, catalog, validate=False)
    marks = degradation_marks()
    errors0 = whatif_errors()
    with injected("whatif"):
        with obs.use_ledger(side.ledger):
            ms = expect_fault("what-if (l6) evaluate", side.svc.evaluate,
                              record=True, hour=WHATIF_SERVICE["hour"])
    mgr = ControllerManager(side.cluster)
    mgr.register(WhatIfController(side.svc))
    reset_launches()
    with injected("whatif"), obs.use_ledger(side.ledger), \
            pinned_hour(WHATIF_SERVICE["hour"]):
        mgr.sync(rounds=1)
    faulted = launch_counts()
    counted = marks_moved(errors0, whatif_errors())
    if counted != {"DeviceFaultError": 1.0} or side.svc.recommendations() \
            or not side.svc.last_error:
        raise AssertionError(f"what-if (l6): the faulted tick counted "
                             f"{counted} and left "
                             f"{len(side.svc.recommendations())} "
                             f"recommendations, last error "
                             f"{side.svc.last_error!r}")
    expect_marks("what-if (l6)", marks, {})
    reset_launches()
    with obs.use_ledger(side.ledger), pinned_hour(WHATIF_SERVICE["hour"]):
        mgr.sync(rounds=1)
    launches = launch_counts()
    backends = {p.backend for p in side.plans}
    if not side.svc.recommendations() or backends != {"device"} or \
            side.svc.last_error or side.svc.snapshot()["degraded_plans"]:
        raise AssertionError(f"what-if (l6): the clean tick recorded "
                             f"{len(side.svc.recommendations())}, backends "
                             f"{backends}, last error "
                             f"{side.svc.last_error!r}")
    require_launches(launches, ["ffd_scan_fleet", "cost_sum"],
                     "what-if (l6) clean tick")
    say(f"what-if (l6) [{card}]: a scripted fault at 'whatif' raised "
        f"DeviceFaultError out of evaluate ({ms:.3f} ms); the faulted "
        f"WhatIfController tick counted {counted} and recorded nothing "
        f"(launches {faulted}); no breadcrumb, no host plan; the clean "
        f"tick recorded {len(side.svc.recommendations())} on backends "
        f"{sorted(backends)} (launches {launches})")
    return {"raised_ms": ms, "counted": counted,
            "recorded": len(side.svc.recommendations()),
            "launches": launches}


# -- (w7), (w8) the IKS, load-balancer and HTTP cloud layer ------------------

IKS = dict(cluster_id="cls-1", prefix="kp", lb="lb-1", lb_pool="web",
           lb_port=443)
HTTP = dict(api_key="chip-smoke-key")


def iks_nodeclass(nodeclass):
    """(w1)'s NodeClass with dynamic worker pools (reaped as soon as they
    are empty) and one load-balancer pool."""
    nodeclass.spec.iks_dynamic_pools = DynamicPoolConfig(
        enabled=True, pool_name_prefix=IKS["prefix"],
        empty_pool_ttl_seconds=0)
    nodeclass.spec.load_balancer_integration = LoadBalancerIntegration(
        enabled=True, target_groups=(LoadBalancerTarget(
            load_balancer_id=IKS["lb"], pool_name=IKS["lb_pool"],
            port=IKS["lb_port"], health_check=HealthCheck(
                protocol="tcp", port=IKS["lb_port"])),))
    return nodeclass


class IKSRig(ProvisionRig):
    """(w7) A ``ProvisionRig`` whose provisioner actuates through a
    ``ProviderFactory``: ``IKS_CLUSTER_ID`` in the env it is given, so
    the NodeClass's plans become workers of ``FakeIKS`` pools on the same
    fake cloud through a ``WorkerPoolActuator``."""

    def restart(self, journal=None):
        iks_nodeclass(self.nodeclass)
        super().restart(journal)
        self.iks = FakeIKS(IKS["cluster_id"], self.cloud)
        self.pools = WorkerPoolActuator(self.iks, self.cluster,
                                        breaker=permissive(),
                                        unavailable=self.unavail)
        self.factory = ProviderFactory(
            self.actuator, self.pools,
            env={"IKS_CLUSTER_ID": IKS["cluster_id"]})
        self.prov.factory = self.factory


def iks_world(rig) -> dict:
    """The pools (name, flavor, zones, size, dynamic), the workers (id,
    pool, zone, instance) and the claims by pod set."""
    return {"pools": sorted((p.id, p.name, p.flavor, tuple(sorted(p.zones)),
                             p.size_per_zone, p.dynamic, p.state)
                            for p in rig.iks.list_pools()),
            "workers": sorted((w.id, w.pool_id, w.zone, w.instance_id)
                              for w in rig.iks.list_workers()),
            "claims": provision_claims(rig.cluster),
            "instances": rig.cloud.instance_count()}


def lb_members(lbs) -> list:
    pool = lbs.pools.get((IKS["lb"], IKS["lb_pool"]))
    return sorted((m.address, m.port) for m in pool.members.values()) \
        if pool is not None else []


def iks_script(rig, pods, clock=None) -> dict:
    """(w7) on one rig: the pods' plan actuated as pool workers; half the
    claims (the smallest pools' first) deleted through
    ``NodeClaimTerminationController(factory=...)`` and one
    ``PoolCleanupController`` tick; the live claims joined, registered in
    one load-balancer pool by ``LoadBalancerController``, a quarter of
    them then dropped from the store unseen and one ``LBMembershipSweeper``
    tick."""
    out = {}
    rig.add(pods)
    plans = rig.prov.provision_once()
    if len(plans) != 1:
        raise AssertionError(f"iks (w7): {len(plans)} plans")
    out["plan"] = plans[0]
    out["provisioned"] = iks_world(rig)
    # the claims of the smallest pools first, so the deleted half empties
    # whole pools
    size = collections.Counter(c.annotations.get(ANNOTATION_POOL_ID)
                               for c in rig.cluster.nodeclaims())
    claims = sorted(rig.cluster.nodeclaims(), key=lambda c: (
        size[c.annotations.get(ANNOTATION_POOL_ID)],
        c.annotations.get(ANNOTATION_POOL_ID, ""), c.name))
    if any(ANNOTATION_POOL_ID not in c.annotations for c in claims):
        raise AssertionError("iks (w7): a claim was not created as a pool "
                             "worker")
    term = NodeClaimTerminationController(rig.cluster, rig.actuator,
                                          factory=rig.factory)
    for c in claims[:len(claims) // 2]:
        c.deleted = True
        term.reconcile(c.name)
    PoolCleanupController(rig.cluster, rig.iks).reconcile()
    out["reaped"] = iks_world(rig)
    lbs = FakeLoadBalancers()
    provider = LoadBalancerProvider(lbs)
    kubelet = FakeKubelet(rig.cluster)
    registration = RegistrationController(rig.cluster)
    lbc = LoadBalancerController(rig.cluster, provider)
    live = sorted(rig.cluster.nodeclaims(), key=lambda c: c.name)
    for c in live:
        kubelet.join(c, ready=True)
        registration.reconcile(c.name)
        lbc.reconcile(c.name)
    out["registered"] = lb_members(lbs)
    for c in live[:len(live) // 4]:
        rig.cluster.delete("nodeclaims", c.name)
    LBMembershipSweeper(rig.cluster, provider).reconcile()
    out["swept"] = lb_members(lbs)
    out["records"] = sorted(r.name for r in
                            rig.cluster.list("lbregistrations"))
    return out


def phase_provision_iks(dev, card: str, pods) -> dict:
    """(w7) Provisioning through the IKS factory on the card against the
    same script on a CPU rig of the port (names from counters)."""
    t_phase = time.perf_counter()
    rigs = []
    try:
        with side_state():
            rig = IKSRig(dev)
            rigs.append(rig)
            reset_launches()
            t0 = time.perf_counter()
            card_out = iks_script(rig, pods)
            wall = time.perf_counter() - t0
            launches = launch_counts()
        with side_state():
            cpu = IKSRig("cpu")
            rigs.append(cpu)
            t1 = time.perf_counter()
            cpu_out = iks_script(cpu, pods)
            cpu_s = time.perf_counter() - t1
    finally:
        for r in rigs:
            r.close()
    require_launches(launches, ["ffd_scan", "cost_sum"], "iks (w7)")
    plans_equal("iks (w7) plan against the CPU port's", card_out["plan"],
                cpu_out["plan"])
    for key in ("provisioned", "reaped", "registered", "swept", "records"):
        if card_out[key] != cpu_out[key]:
            raise AssertionError(f"iks (w7): {key} differs from the CPU "
                                 f"port's")
    prov, reaped = card_out["provisioned"], card_out["reaped"]
    if not prov["workers"] or len(prov["workers"]) != len(
            card_out["plan"].nodes) or prov["instances"] != len(
                prov["workers"]) or len(reaped["pools"]) >= len(
                    prov["pools"]) or not card_out["swept"]:
        raise AssertionError(f"iks (w7): {len(prov['pools'])} pools and "
                             f"{len(prov['workers'])} workers for "
                             f"{len(card_out['plan'].nodes)} nodes, "
                             f"{len(reaped['pools'])} pools after the "
                             f"cleanup, {len(card_out['swept'])} members")
    out = {"launches": launches, "wall_s": wall, "cpu_s": cpu_s,
           "nodes": len(card_out["plan"].nodes),
           "pools": len(prov["pools"]), "workers": len(prov["workers"]),
           "pools_after_cleanup": len(reaped["pools"]),
           "workers_after_delete": len(reaped["workers"]),
           "members": len(card_out["registered"]),
           "members_after_sweep": len(card_out["swept"]),
           "host_s": time.perf_counter() - t_phase}
    say(f"iks (w7) [{card}]: {len(pods)} headline pods through "
        f"Provisioner(factory=ProviderFactory(Actuator, WorkerPoolActuator("
        f"FakeIKS), env={{IKS_CLUSTER_ID}})) in {wall:.3f} s: "
        f"{out['nodes']} nodes as {out['workers']} workers in "
        f"{out['pools']} dynamic pools; half the claims deleted through "
        f"NodeClaimTerminationController(factory=...), one "
        f"PoolCleanupController tick left {out['pools_after_cleanup']} "
        f"pools and {out['workers_after_delete']} workers; "
        f"LoadBalancerController registered {out['members']} members, "
        f"LBMembershipSweeper left {out['members_after_sweep']}; plan, "
        f"pools, workers, claims and members equal to the CPU port's "
        f"({cpu_s:.3f} s on the host); launches {launches}")
    return out


class HTTPRig:
    """(w8) ``StubCloudServer`` over a 500-profile ``FakeCloud`` on
    127.0.0.1; ``VPCCloudClient`` -> ``PricingProvider`` ->
    ``InstanceTypeProvider`` -> ``CatalogArrays``, a ``Provisioner`` on
    ``device`` and an ``Actuator`` over the same client."""

    def __init__(self, device):
        self.cloud = FakeCloud(profiles=generate_profiles(INTAKE["types"]))
        self.server = StubCloudServer(cloud=self.cloud,
                                      api_key=HTTP["api_key"]).start()
        self.pricing = self.prov = None
        try:
            self.client = VPCCloudClient(self.server.endpoint,
                                         HTTP["api_key"],
                                         region=self.cloud.region)
            t0 = time.perf_counter()
            self.pricing = PricingProvider(self.client)
            self.unavail = UnavailableOfferings()
            self.itp = InstanceTypeProvider(self.client, self.pricing,
                                            self.unavail)
            self.catalog = CatalogArrays.build(self.itp.list())
            self.intake_s = time.perf_counter() - t0
            self.cluster = ClusterState()
            self.cluster.add_nodeclass(provision_nodeclass())
            self.cluster.add_nodepool(NodePool(name="default",
                                               nodeclass_name="default"))
            self.actuator = Actuator(self.client, self.cluster,
                                     unavailable=self.unavail,
                                     breaker=permissive())
            self.prov = Provisioner(
                self.cluster, self.itp, self.actuator, ProvisionerOptions(
                    window=WindowOptions(**PROVISION["window"])),
                device=device)
        except BaseException:
            self.close()
            raise

    def close(self):
        try:
            if self.prov is not None:
                self.prov.stop()
            if self.pricing is not None:
                self.pricing.close()
        finally:
            self.server.stop()


def http_instances(cloud) -> list:
    return sorted((i.name, i.profile, i.zone, i.capacity_type, i.subnet_id,
                   i.image_id, len(i.volume_ids), tuple(sorted(
                       i.tags.items())))
                  for i in cloud.list_instances())


def http_script(rig, pods) -> dict:
    clock = CycleClock(rig.prov)
    for p in pods:
        rig.cluster.add_pod(p)
    t0 = time.perf_counter()
    plans = rig.prov.provision_once()
    wall = time.perf_counter() - t0
    if len(plans) != 1:
        raise AssertionError(f"http (w8): {len(plans)} plans")
    return {"plan": plans[0], "wall_s": wall, "split_s": dict(clock.s),
            "instances": http_instances(rig.cloud),
            "leaks": no_leaks("http (w8)", rig.cloud, rig.cluster),
            "cloud_calls": sum(len(v) for v in
                               rig.cloud.recorder.calls.values())}


def phase_provision_http(dev, card: str, pods, w2_plan) -> dict:
    """(w8) The headline pods provisioned over HTTP on the card: the
    catalog built over the wire equal to the one built on the fake cloud
    directly, array for array; the card's plan (w2)'s; the instances on
    the stub's cloud those of a CPU rig over its own stub."""
    t_phase = time.perf_counter()
    rigs = []
    try:
        with side_state():
            rig = HTTPRig(dev)
            rigs.append(rig)
            direct = workload.build_catalog(INTAKE["types"])
            for f in CATALOG_FIELDS:
                a, b = getattr(rig.catalog, f), getattr(direct, f)
                same = np.array_equal(a, b) if isinstance(a, np.ndarray) \
                    else a == b
                if not same:
                    raise AssertionError(f"http (w8): the catalog's {f} "
                                         f"built over the wire differs from "
                                         f"the one built on FakeCloud")
            reset_launches()
            card_out = http_script(rig, pods)
            launches = launch_counts()
        with side_state():
            cpu = HTTPRig("cpu")
            rigs.append(cpu)
            t1 = time.perf_counter()
            cpu_out = http_script(cpu, pods)
            cpu_s = time.perf_counter() - t1
    finally:
        for r in rigs:
            r.close()
    require_launches(launches, ["ffd_scan", "cost_sum"], "http (w8)")
    plans_equal("http (w8) plan against (w2)'s", card_out["plan"], w2_plan)
    plans_equal("http (w8) plan against the CPU port's", card_out["plan"],
                cpu_out["plan"])
    if card_out["instances"] != cpu_out["instances"] or len(
            card_out["instances"]) != len(card_out["plan"].nodes):
        raise AssertionError(f"http (w8): {len(card_out['instances'])} "
                             f"instances on the stub's cloud for "
                             f"{len(card_out['plan'].nodes)} nodes, or not "
                             f"the CPU rig's")
    s = card_out["split_s"]
    split = {"intake": rig.intake_s, "catalog": s.get("catalog", 0.0),
             "solve": s.get("solve", 0.0),
             "actuation": s.get("actuation", 0.0),
             "nomination": s.get("nomination", 0.0)}
    out = {"launches": launches, "wall_s": card_out["wall_s"],
           "split_ms": {k: v * 1e3 for k, v in split.items()},
           "cpu_s": cpu_s, "nodes": len(card_out["plan"].nodes),
           "instances": len(card_out["instances"]),
           "resources": card_out["leaks"],
           "cloud_calls": card_out["cloud_calls"],
           "host_s": time.perf_counter() - t_phase}
    say(f"http (w8) [{card}]: VPCCloudClient over StubCloudServer "
        f"(127.0.0.1:{rig.server.port}) -> PricingProvider -> "
        f"InstanceTypeProvider -> CatalogArrays equal to the direct "
        f"catalog on every field; provision_once of {len(pods)} headline "
        f"pods in {card_out['wall_s'] * 1e3:.3f} ms; split: intake over "
        f"the wire {split['intake'] * 1e3:.3f} ms, catalog resolve "
        f"{split['catalog'] * 1e3:.3f} ms, solve {split['solve'] * 1e3:.3f}"
        f" ms, actuation over the wire {split['actuation'] * 1e3:.3f} ms "
        f"({out['nodes']} creates, {card_out['cloud_calls']} cloud calls "
        f"through the wire), nomination "
        f"{split['nomination'] * 1e3:.3f} ms; plan equal to (w2)'s and to "
        f"the CPU rig's; {out['instances']} instances on the stub's cloud "
        f"({card_out['leaks']}) equal to the CPU rig's over its own stub "
        f"({cpu_s:.3f} s on the host); launches {launches}")
    return out


# -- (s) the fault and profiling planes ----------------------------------------

FAULT = dict(windows=300, capture_s=1.5, batch=16, warm=20,
             ab_rounds=40, ab_block=10,
             # (f): each child process solves the base window first (the
             # process's own first costs), then the first window of each
             # cold size: one catalog, G/O/U equal, N 128, 256 and 384
             cold_base=dict(pods=2000, types=120, seed=70),
             cold_types=300, cold_seed=71, cold_pods=(1500, 3000, 6000),
             cold_sides=("without", "with", "with", "without"))
# kernels per window of the headline and pref windows in the previous
# slice's run (PERF.md section 5, NVIDIA H100 80GB HBM3, 700.00 W)
PR9_KERNELS = {"headline": 473, "pref": 489}


class ScriptedInjector:
    """A fault script for ``device_guard``: the next entry per guarded
    dispatch (None = clean), on the guard's first device."""

    def __init__(self, script):
        self.script = list(script)
        self.injected = 0

    def draw(self, kernel, candidates):
        if not self.script:
            return None
        kind = self.script.pop(0)
        if kind is None:
            return None
        self.injected += 1
        return kind, candidates[0]

    def probe_faults(self, device):
        return False


def fresh_planes():
    """A new health board and a new profiler (default interval) in place
    of the process's, so that this phase's counts are its own."""
    from karpenter_tpu_torch import faulttol
    from karpenter_tpu_torch.faulttol import health as health_mod
    from karpenter_tpu_torch.obs import prof as prof_mod

    faulttol.clear_injector()
    health_mod._BOARD = None
    prof_mod._PROFILER = None
    prof = prof_mod.get_profiler()
    prof.interval = prof_mod.DEFAULT_INTERVAL
    return faulttol.get_health_board(), prof


def fault_overheads(dev, card: str, solver, request, problem) -> dict:
    """(a) FAULT["windows"] headline windows under the guard and the
    profiler at its default interval: both overhead fractions (< 1%, or
    the run fails), then a capture (every dispatch sampled, outside the
    overhead accounting) for the sampled "scan" split beside the device
    program's CUDA-event time."""
    import threading

    board, prof = fresh_planes()
    reset_launches()
    walls = []
    for _ in range(FAULT["windows"]):
        t0 = time.perf_counter()
        solver.solve(request)
        walls.append(time.perf_counter() - t0)
    launches = launch_counts()
    require_launches(launches, ["ffd_scan", "cost_sum"],
                     "guarded headline windows")
    guard_frac = board.healthy_overhead_fraction()
    prof_frac = prof.overhead_fraction()
    snap = prof.snapshot()
    guards = board.guards_entered
    per_guard_us = board.guard_overhead_s / max(guards, 1) * 1e6
    res: dict = {}
    th = threading.Thread(
        target=lambda: res.update(s=prof.capture(FAULT["capture_s"])))
    th.start()
    time.sleep(0.05)
    captured = 0
    while th.is_alive():
        solver.solve(request)
        captured += 1
    th.join()
    scan = [s for s in res.get("s") or () if s["kernel"] == "scan"]
    if not scan:
        raise AssertionError("(a) the capture holds no scan dispatch")
    split = {ph: float(np.median([s[f"{ph}_s"] for s in scan])) * 1e3
             for ph in ("dispatch", "execute", "fetch", "device")}
    prep = solver._prepare(problem)
    off_alloc, off_price, off_rank = solver.device_offerings(
        request.catalog, prep.O_pad)
    packed = torch.from_numpy(prep.packed).to(dev)
    program_ms = cuda_ms(lambda: tp.solve_packed_torch(
        packed, off_alloc, off_price, off_rank, G=prep.G_pad, O=prep.O_pad,
        U=prep.U_pad, N=prep.N, compact=prep.K, dense16=prep.dense16,
        coo16=prep.coo16), 20)
    p50 = float(np.percentile(walls, 50)) * 1e3
    say(f"fault (a) [{card}]: {FAULT['windows']} guarded headline windows, "
        f"p50 wall {p50:.4f} ms; {guards} guards at "
        f"{per_guard_us:.3f} us each; guard overhead fraction "
        f"{guard_frac:.6f}, profiler overhead fraction {prof_frac:.6f} "
        f"(interval {prof.interval}, {snap['samples']} samples of "
        f"{snap['dispatches_seen']} dispatches); launches {launches}")
    say(f"fault (a) [{card}]: sampled scan split over {len(scan)} captured "
        f"windows (medians): dispatch {split['dispatch']:.4f} ms, execute "
        f"{split['execute']:.4f} ms, fetch {split['fetch']:.4f} ms; the "
        f"bracket's CUDA-event device time {split['device']:.4f} ms beside "
        f"the device program back to back {program_ms:.4f} ms")
    for name, frac in (("guard", guard_frac), ("profiler", prof_frac)):
        if not 0.0 <= frac < 0.01:
            raise AssertionError(f"(a) {name} overhead fraction {frac} is "
                                 f"not under 1%")
    return {"windows": FAULT["windows"], "p50_wall_ms": p50,
            "guard_overhead_fraction": guard_frac,
            "profiler_overhead_fraction": prof_frac,
            "guard_us": per_guard_us, "guards": guards,
            "samples": snap["samples"],
            "dispatches_seen": snap["dispatches_seen"],
            "scan_split_ms": split, "captured_windows": len(scan),
            "device_program_ms": program_ms, "launches": launches}


def fault_planes_cost(dev, card: str, solver, request) -> dict:
    """(a), end to end: the headline window's wall with the planes on
    (guard and profiler at its default interval) and taken out (the
    null guard and a profiler that never samples, as in (g)), in
    FAULT["ab_rounds"] rounds of FAULT["ab_block"] windows each way, the
    order turned every round.  Each round gives the ratio of its two
    block p50s; the planes' cost is the median ratio less 1, the run's
    own spread half the interquartile range of the ratios, and the run
    fails if the cost exceeds the spread by more than 1%.  Beside it,
    the planes' own host time per window: empty guard and inactive
    probe brackets on this card's id, back to back."""
    from karpenter_tpu_torch.faulttol import device_guard, device_id
    from karpenter_tpu_torch.obs.prof import DeviceProfiler
    from karpenter_tpu_torch.solver import torch_backend

    fresh_planes()
    bare = DeviceProfiler(interval=0)
    blocks: dict = {"on": [], "off": []}
    for r in range(FAULT["ab_rounds"]):
        for mode in ("on", "off") if r % 2 == 0 else ("off", "on"):
            with contextlib.ExitStack() as stack:
                if mode == "off":
                    stack.enter_context(_patched(
                        torch_backend, "device_guard", NullGuard))
                    stack.enter_context(_patched(
                        torch_backend, "get_profiler", lambda: bare))
                walls = []
                for _ in range(FAULT["ab_block"]):
                    t0 = time.perf_counter()
                    solver.solve(request)
                    walls.append(time.perf_counter() - t0)
            blocks[mode].append(float(np.percentile(walls, 50)) * 1e3)
    ratios = np.array(blocks["on"]) / np.array(blocks["off"])
    cost = float(np.median(ratios)) - 1.0
    q25, q75 = (float(q) for q in np.percentile(ratios, [25, 75]))
    spread = (q75 - q25) / 2
    on, off = (float(np.median(blocks[m])) for m in ("on", "off"))
    ids = [device_id(dev)]
    n = 20_000
    t0 = time.perf_counter()
    for _ in range(n):
        with device_guard("scan", devices=ids):
            with bare.sampled("scan") as probe:
                probe.dispatched(None)
    host_us = (time.perf_counter() - t0) / n * 1e6
    fresh_planes()
    say(f"fault (a) [{card}]: headline wall in turns, {FAULT['ab_rounds']} "
        f"rounds of {FAULT['ab_block']} windows each way: planes on / "
        f"taken out, median of the rounds' ratios x{1 + cost:.4f} "
        f"(quartiles x{q25:.4f} / x{q75:.4f}, spread {spread:.4f}); "
        f"medians of the block p50s {on:.4f} / {off:.4f} ms; the planes' "
        f"own host time {host_us:.3f} us a window "
        f"({host_us / 1e3 / off:.6f} of the bare p50); ratios "
        f"{fmt_list(ratios)}")
    if cost > spread + 0.01:
        raise AssertionError(f"(a) the planes cost {cost:.4f} of the "
                             f"headline wall, over the run's spread "
                             f"{spread:.4f} plus 1%")
    return {"cost": cost, "spread": spread, "ratio_quartiles": [q25, q75],
            "on_ms": on, "off_ms": off, "host_us": host_us,
            "blocks_on_ms": blocks["on"], "blocks_off_ms": blocks["off"]}


def fmt_list(xs) -> str:
    return "[" + ", ".join(f"{x:.4f}" for x in xs) + "]"


def fault_real_oom(dev, card: str, solver, request, problem) -> dict:
    """(b) A real allocator OOM inside ``device_guard("scan-batch")`` is
    ``DeviceResourceExhausted`` with an ``oom`` fault on the card; the
    next headline window equals the plain CPU solve word for word."""
    from karpenter_tpu_torch import faulttol

    board, _ = fresh_planes()
    ids = [faulttol.device_id(dev)]
    try:
        with faulttol.device_guard("scan-batch", devices=ids):
            torch.empty(1 << 40, dtype=torch.uint8, device=dev)
    except faulttol.DeviceResourceExhausted as e:
        cause = type(e.__cause__).__name__
    else:
        raise AssertionError("(b) a 1 TiB allocation did not run out of "
                             "memory")
    torch.cuda.empty_cache()
    state = board.snapshot()["devices"][ids[0]]
    if state["last_kind"] != "oom" or board.faults_recorded != 1:
        raise AssertionError(f"(b) board after the OOM: {state}")
    prep = solver._prepare(problem)
    card_words = solver.dispatch_packed(prep).cpu().numpy()
    cpu_cat = [t.cpu() for t in solver.device_offerings(request.catalog,
                                                        prep.O_pad)]
    plain = tp.solve_packed_torch(
        torch.from_numpy(prep.packed.copy()), *cpu_cat, G=prep.G_pad,
        O=prep.O_pad, U=prep.U_pad, N=prep.N, right_size=True,
        compact=prep.K, dense16=prep.dense16, coo16=prep.coo16).numpy()
    words_equal("(b) window after the OOM", card_words, plain,
                prep.N + prep.G_pad)
    clean_and_placed("(b) window after the OOM", solver.solve(request),
                     request.pods, request.catalog)
    say(f"fault (b) [{card}]: a 1 TiB allocation in device_guard("
        f"'scan-batch') raised DeviceResourceExhausted (from {cause}); "
        f"board {ids[0]}: {state['state']}, last kind {state['last_kind']}"
        f"; the next headline window equals the plain CPU solve word for "
        f"word ({card_words.shape[0]} words) and validates clean")
    return {"cause": cause, "board": state}


def fault_launch_error(dev, card: str, solver, request) -> dict:
    """(c) The FFD library's C entry, called through its ctypes binding
    with N above its maximum (which the Python wrapper refuses first),
    returns cudaErrorInvalidValue before any launch; raised by the
    wrappers' ``check_launch`` inside a guard it is a ``DeviceFaultError``
    of kind "error".  The wrapper's own refusal (a ValueError) passes the
    guard unrecorded, and the context stays usable."""
    from karpenter_tpu_torch import faulttol

    board, _ = fresh_planes()
    ids = [faulttol.device_id(dev)]
    lib = cuda_build.load("ffd_scan")
    nmax = lib.ffd_scan_max_nodes()
    G, O = 1, 128
    meta = torch.zeros((1, G, 8), dtype=torch.int32, device=dev)
    compat = torch.zeros((1, G, O), dtype=torch.int32, device=dev)
    alloc = torch.zeros((O, 4), dtype=torch.int32, device=dev)
    rank = torch.zeros(O, dtype=torch.float32, device=dev)
    rows = torch.zeros((1, G, lib.ffd_scan_row_words(O)), dtype=torch.int32,
                       device=dev)
    outs = [torch.zeros(n, dtype=torch.int32, device=dev)
            for n in (nmax + 1, G * (nmax + 1), G)]
    err = lib.ffd_scan_launch(
        meta.data_ptr(), compat.data_ptr(), 0, alloc.data_ptr(), 0,
        rank.data_ptr(), 0, 0, rows.data_ptr(), outs[0].data_ptr(),
        outs[1].data_ptr(), outs[2].data_ptr(), 1, G, O, nmax + 1,
        ffd_kernel.FIT_BIG, dev.index, cuda_build.stream_handle(dev.index))
    if err != 1:
        raise AssertionError(f"(c) ffd_scan_launch with N={nmax + 1} "
                             f"returned cudaError {err}, want 1 "
                             f"(cudaErrorInvalidValue)")
    try:
        with faulttol.device_guard("scan", devices=ids):
            cuda_build.check_launch("ffd_scan", err,
                                    lib.ffd_scan_error_string)
    except faulttol.DeviceFaultError as e:
        typed = (type(e).__name__, e.kind, type(e.__cause__).__name__,
                 e.__cause__.code)
    else:
        raise AssertionError("(c) the launch error passed the guard")
    if typed != ("DeviceFaultError", "error", "KernelLaunchError", 1):
        raise AssertionError(f"(c) typed as {typed}")
    before = board.faults_recorded
    try:
        with faulttol.device_guard("scan", devices=ids):
            ffd_kernel.ffd_scan(meta, compat, alloc, rank, nmax + 1)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("(c) the wrapper took N above its maximum")
    if board.faults_recorded != before:
        raise AssertionError("(c) the wrapper's ValueError was recorded as "
                             "a device fault")
    torch.cuda.synchronize(dev)
    clean_and_placed("(c) window after the launch error",
                     solver.solve(request), request.pods, request.catalog)
    msg = lib.ffd_scan_error_string(err).decode()
    say(f"fault (c) [{card}]: ffd_scan_launch(N={nmax + 1}) through ctypes "
        f"returned cudaError {err} ({msg}) before any launch; in "
        f"device_guard('scan') check_launch raised {typed[0]} (kind "
        f"{typed[1]}, cause {typed[2]} code {typed[3]}); the wrapper's own "
        f"check raised ValueError ({refused}) and the guard recorded "
        f"nothing; the next headline window validates clean")
    return {"cuda_error": err, "message": msg, "typed": list(typed),
            "faults_recorded": board.faults_recorded}


def fault_probation(dev, card: str) -> dict:
    """(d) A quarantined card (three faults; the quarantine writes its
    triage bundle) turns to probation on the clock, and the probation
    ticks run the torch health probe on the card: two passing probes
    make it healthy again."""
    import shutil
    import tempfile

    from karpenter_tpu_torch import faulttol
    from karpenter_tpu_torch.obs.watchdog import write_triage_bundle

    ids = [faulttol.device_id(dev)]
    triage = tempfile.mkdtemp(prefix="triage-")
    bundles = []
    now = [1000.0]

    def writer(trigger, detail):
        bundles.append(write_triage_bundle(trigger, detail,
                                           triage_dir=triage))

    try:
        board = faulttol.HealthBoard(clock=lambda: now[0],
                                     triage_writer=writer)
        for _ in range(board.fault_threshold):
            board.record_fault(ids[0], kind="error", kernel="scan")
        walk = [board.state(ids[0])]
        t0 = time.perf_counter()
        probe_ok = board._run_probe(ids[0])
        probe_ms = (time.perf_counter() - t0) * 1e3
        for _ in range(board.probe_successes):
            now[0] += board.recovery_timeout_s + 1.0
            board.tick()
            walk.append(board.state(ids[0]))
        keys = sorted(json.loads(
            (Path(bundles[0]) / "bundle.json").read_text())) if bundles \
            else []
    finally:
        shutil.rmtree(triage, ignore_errors=True)
    if walk != ["quarantined", "probation", "healthy"] or not probe_ok \
            or len(bundles) != 1:
        raise AssertionError(f"(d) walk {walk}, probe {probe_ok}, bundles "
                             f"{len(bundles)}")
    say(f"fault (d) [{card}]: {ids[0]} quarantined after "
        f"{board.fault_threshold} faults (one triage bundle: {keys}); "
        f"probation ticks ran the torch probe on the card: "
        f"{' -> '.join(walk)}; one probe {probe_ms:.3f} ms")
    return {"walk": walk, "probe_ms": probe_ms, "bundle_keys": keys}


def fault_oom_halving(dev, card: str, pods, catalog) -> dict:
    """(e) An injected ``oom`` on a FAULT["batch"]-window batch halves it
    on the card (``solve_encoded_batch``): every plan equal to the
    unchunked batch's, cost word included."""
    from karpenter_tpu_torch import faulttol

    board, _ = fresh_planes()
    C = FAULT["batch"]
    problems = [encode_mod.encode(pods[i::C], catalog) for i in range(C)]
    solver = TorchSolver(device=dev)
    whole = solver.solve_encoded_batch(problems)
    if solver.last_stats.get("batch") != C:
        raise AssertionError(f"(e) the {C} windows did not share one batch:"
                             f" {solver.last_stats.get('path')}")
    guards0 = board.guards_entered
    inj = ScriptedInjector(["oom"])
    faulttol.install_injector(inj)
    try:
        halved = solver.solve_encoded_batch(problems)
    finally:
        faulttol.clear_injector()
    last = solver.last_stats.get("batch")
    for i, (a, b) in enumerate(zip(halved, whole)):
        plans_equal(f"(e) window {i} of the halved batch", a, b)
    if inj.injected != 1 or last != C // 2 or len(halved) != C:
        raise AssertionError(f"(e) injected {inj.injected}, last batch "
                             f"{last}, plans {len(halved)}")
    guards = board.guards_entered - guards0
    say(f"fault (e) [{card}]: an injected oom on the {C}-window batch "
        f"halved it on the card ({guards} guarded batch dispatches, the "
        f"last of {last} windows); all {C} plans equal the unchunked "
        f"batch's, cost words included")
    return {"batch": C, "last_batch": last, "guards": guards}


COLD_TAG = "cold-child: "


def cold_child(side: str) -> int:
    """One side of (f), in a fresh process of this script: the base
    window (the process's own first costs: CUDA context, libraries,
    allocator), then with ``side == "with"`` ``warmup_solver`` over the
    cold sizes' ladder shapes, then for each cold size its first window
    and the p50 of FAULT["warm"] more, each plan checked.  Prints one
    line, COLD_TAG and a JSON object."""
    from karpenter_tpu_torch.obs.devtel import get_devtel
    from karpenter_tpu_torch.solver.warmup import warmup_solver

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    solver = TorchSolver(device=dev)
    base_pods, base_catalog = workload.build_workload(
        FAULT["cold_base"]["pods"], FAULT["cold_base"]["types"],
        seed=FAULT["cold_base"]["seed"])
    clean_and_placed("(f) base window", solver.solve(
        SolveRequest(base_pods, base_catalog)), base_pods, base_catalog)
    catalog = workload.build_catalog(FAULT["cold_types"])
    windows = []
    for n in FAULT["cold_pods"]:
        pods, _ = workload.build_workload(n, FAULT["cold_types"],
                                          seed=FAULT["cold_seed"])
        problem = encode_mod.encode(pods, catalog)
        prep = solver._prepare(problem)
        windows.append((pods, catalog, problem, prep))
    tel = get_devtel()
    warm_s = 0.0
    if side == "with":
        t0 = time.perf_counter()
        warmup_solver(solver, catalog, shapes=[
            (prep.G_pad, prep.U_pad, prep.N, int(problem.group_count.sum()))
            for _, _, problem, prep in windows], batch_widths=())
        warm_s = time.perf_counter() - t0
    out = []
    for pods, catalog, problem, prep in windows:
        rec0 = tel.recompiles
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        plan = solver.solve_encoded(problem)
        cold_ms = (time.perf_counter() - t0) * 1e3
        recompiles = tel.recompiles - rec0
        clean_and_placed(f"(f) first window at {len(pods)} pods", plan,
                         pods, catalog)
        walls = []
        for _ in range(FAULT["warm"]):
            t0 = time.perf_counter()
            solver.solve_encoded(problem)
            walls.append(time.perf_counter() - t0)
        p50 = float(np.percentile(walls, 50)) * 1e3
        out.append({"pods": len(pods), "shape": [prep.G_pad, prep.O_pad,
                                                  prep.U_pad, prep.N],
                    "cold_ms": cold_ms, "warm_p50_ms": p50,
                    "ratio": cold_ms / p50,
                    "first_dispatches": recompiles})
    print(COLD_TAG + json.dumps({"side": side, "warmup_s": warm_s,
                                 "windows": out}), flush=True)
    return 0


def fault_warmup(dev, card: str) -> dict:
    """(f) The first window of each cold size beside its warm p50, in
    fresh processes of this script (``--cold-child``), run in the order
    FAULT["cold_sides"]: the same sizes, catalog and base window on both
    sides, which differ only in ``warmup_solver``.  Printed with the
    medians per side, not gated; a child that fails fails the run."""
    script = Path(__file__).resolve()
    runs = []
    for side in FAULT["cold_sides"]:
        proc = subprocess.run(
            [sys.executable, str(script), "--cold-child", side],
            cwd=script.parent, capture_output=True, text=True, timeout=600)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith(COLD_TAG)]
        if proc.returncode != 0 or len(lines) != 1:
            raise AssertionError(
                f"(f) the {side} child exited {proc.returncode}:\n"
                f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        run = json.loads(lines[0][len(COLD_TAG):])
        runs.append(run)
        say(f"fault (f) [{card}]: child {len(runs)}, {side} warmup_solver "
            f"(warmup {run['warmup_s'] * 1e3:.3f} ms): " + "; ".join(
                f"{w['pods']} pods {tuple(w['shape'])}: first "
                f"{w['cold_ms']:.4f} ms, warm p50 {w['warm_p50_ms']:.4f} "
                f"ms (x{w['ratio']:.3f}, {w['first_dispatches']} first "
                f"dispatches)" for w in run["windows"]))
    out = {"runs": runs}
    for side in ("without", "with"):
        ws = [w for r in runs if r["side"] == side for w in r["windows"]]
        out[side] = {"median_ratio": float(np.median([w["ratio"]
                                                      for w in ws])),
                     "median_cold_ms": float(np.median([w["cold_ms"]
                                                        for w in ws])),
                     "median_warm_p50_ms": float(np.median(
                         [w["warm_p50_ms"] for w in ws])),
                     "first_dispatches": sum(w["first_dispatches"]
                                             for w in ws),
                     "windows": len(ws)}
    say(f"fault (f) [{card}]: medians over {out['without']['windows']} "
        f"first windows a side: without warmup_solver x"
        f"{out['without']['median_ratio']:.3f} the warm p50 (first "
        f"{out['without']['median_cold_ms']:.4f} ms, warm "
        f"{out['without']['median_warm_p50_ms']:.4f} ms, "
        f"{out['without']['first_dispatches']} first dispatches), with it "
        f"x{out['with']['median_ratio']:.3f} (first "
        f"{out['with']['median_cold_ms']:.4f} ms, warm "
        f"{out['with']['median_warm_p50_ms']:.4f} ms, "
        f"{out['with']['first_dispatches']} first dispatches)")
    return out


def fault_kernels_per_window(dev, card: str, solver, request) -> dict:
    """(g) Kernels per window of the headline and the pref window with
    the guard and the profiler in place and with both taken out (a null
    guard, a profiler that never samples): equal, or the run fails;
    printed beside the previous slice's counts."""
    import contextlib

    from karpenter_tpu_torch.obs.prof import DeviceProfiler
    from karpenter_tpu_torch.solver import torch_backend

    pods, catalog = workload.build_workload(
        HEADLINE["pods"], HEADLINE["types"], seed=HEADLINE["seed"])
    pref_request = SolveRequest(workload.with_preferences(pods), catalog)
    pref_solver = TorchSolver(device=dev)
    pref_solver.solve(pref_request)
    runs = {"headline": (solver, request, "ffd_scan"),
            "pref": (pref_solver, pref_request, "ffd_scan_pref")}
    out = {}
    for label, (s, req, key) in runs.items():
        counts = {}
        for mode in ("guarded", "bare"):
            with contextlib.ExitStack() as stack:
                if mode == "bare":
                    bare = DeviceProfiler(interval=0)
                    stack.enter_context(_patched(
                        torch_backend, "device_guard", NullGuard))
                    stack.enter_context(_patched(
                        torch_backend, "get_profiler", lambda: bare))
                counts[mode] = kernels_per_call(
                    lambda: s.solve(req), f"fault_{label}_{mode}",
                    ffd_kernel.LAUNCHES, key, spans=5)
        if counts["guarded"] != counts["bare"]:
            raise AssertionError(f"(g) {label}: {counts['guarded']} kernels "
                                 f"per window guarded, {counts['bare']} "
                                 f"without the guard")
        out[label] = counts["guarded"]
        say(f"fault (g) [{card}]: {label} window: {counts['guarded']} "
            f"kernels per window with the guard and the profiler, "
            f"{counts['bare']} without (the previous slice's run: "
            f"{PR9_KERNELS[label]})")
    return out


class NullGuard:
    """``device_guard`` taken out: no board, no clock, the same fetch."""

    def __init__(self, *args, **kwargs):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def fetch(self, out, event=None):
        from karpenter_tpu_torch.faulttol.dispatch import host_copy

        if event is not None:
            event.synchronize()
        if isinstance(out, (tuple, list)):
            return tuple(host_copy(o) for o in out)
        return host_copy(out)


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def phase_fault(dev, card: str, pods, catalog) -> dict:
    """(s) The fault and profiling planes on the card, after every path:
    (a) guard and profiler overheads over FAULT["windows"] headline
    windows, the sampled split and the headline wall with the planes on
    and taken out in turns, (b) a real allocator OOM, (c) a
    launch error from the FFD library's C entry, (d) a probation walk
    with the torch probe, (e) the batch's OOM halving, (f) first windows
    of new signatures in fresh processes without and with warmup, (g) kernels per window with and without
    the planes.  Run it alone with ``phase_fault(dev, card_line(),
    *workload.build_workload(10_000, 500, seed=42))`` (the solver it
    makes builds the kernels)."""
    solver = TorchSolver(device=dev)
    request = SolveRequest(pods, catalog)
    problem = encode_mod.encode(pods, catalog)
    solver.solve(request)
    out = {"overheads": fault_overheads(dev, card, solver, request, problem),
           "planes_cost": fault_planes_cost(dev, card, solver, request),
           "real_oom": fault_real_oom(dev, card, solver, request, problem),
           "launch_error": fault_launch_error(dev, card, solver, request),
           "probation": fault_probation(dev, card),
           "oom_halving": fault_oom_halving(dev, card, pods, catalog),
           "warmup": fault_warmup(dev, card),
           "kernels_per_window": fault_kernels_per_window(
               dev, card, solver, request)}
    out["launches"] = out["overheads"]["launches"]
    fresh_planes()
    return out


# -- (u) the degraded modes ----------------------------------------------------

# (u5): rounds of turns, headline windows per arm in each round, and the
# plan_defects calls timed; (u4): the what-if menu's scenarios (plan_host
# solves them one at a time on the host)
DEGRADED = dict(rounds=10, per_round=5, defects_reps=20, whatif_k=4)
def degradation_marks() -> dict:
    """Every degradation breadcrumb of the process: the ``ERRORS``
    samples of kind ``degraded_*`` / ``*_fallback`` (among them each
    ``ResilientShardedService.degraded_windows`` and
    ``degraded_rebalances`` step), ``SERVING_WINDOWS{host_failover}``
    and ``OVERCOMMIT_SOLVES{degraded}`` (``solver/degraded.breadcrumbs``)."""
    return breadcrumbs()


def marks_moved(before: dict, after: dict) -> dict:
    return {k: after[k] - before.get(k, 0.0) for k in after
            if after[k] != before.get(k, 0.0)}


def gate_marks() -> dict:
    """The gate's marks: every degradation breadcrumb, every
    ``ERRORS{controller.*, reconcile}`` sample (a controller whose
    reconcile raised) and every ``ERRORS{gang|preempt|repack,
    invalid_plan}`` sample (a plan the controllers' validator refused)."""
    marks = degradation_marks()
    for (component, kind), v in metrics.ERRORS.samples().items():
        if (component.startswith("controller.") and kind == "reconcile") \
                or (component in ("gang", "preempt", "repack")
                    and kind == "invalid_plan"):
            marks[f"errors{{{component},{kind}}}"] = v
    return marks


def gated(label: str, fn, *args, **kwargs):
    """(u0) Run one phase; any degradation breadcrumb, failed reconcile or
    refused plan it moves fails the run (the degraded modes never fire
    on a path that must not degrade)."""
    before = gate_marks()
    out = fn(*args, **kwargs)
    moved = marks_moved(before, gate_marks())
    if moved:
        raise AssertionError(f"phase {label}: a degraded mode fired or a "
                             f"controller failed: {moved}")
    return out


class SiteInjector:
    """Faults the next dispatch of one guard site (``kernel``; None =
    whichever dispatch comes next) with ``kind``."""

    def __init__(self, kernel=None, kind="error"):
        self.kernel, self.kind = kernel, kind
        self.injected = 0

    def draw(self, kernel, candidates):
        if not self.injected and self.kernel in (None, kernel):
            self.injected = 1
            return self.kind, candidates[0]
        return None

    def probe_faults(self, device):
        return False


@contextlib.contextmanager
def injected(kernel=None, kind="error"):
    """One scripted fault at the next dispatch of ``kernel``; the health
    board is fresh before and after, so the fault quarantines nothing
    later."""
    from karpenter_tpu_torch import faulttol
    from karpenter_tpu_torch.faulttol import health as health_mod

    health_mod._BOARD = None
    inj = SiteInjector(kernel, kind)
    faulttol.install_injector(inj)
    try:
        yield inj
    finally:
        faulttol.clear_injector()
        health_mod._BOARD = None
    if not inj.injected:
        raise AssertionError(f"the scripted fault on {kernel!r} was never "
                             f"drawn")


def expect_marks(label: str, before: dict, want: dict) -> None:
    got = marks_moved(before, degradation_marks())
    if got != want:
        raise AssertionError(f"{label}: breadcrumbs moved {got}, want "
                             f"{want}")


def add_launches(total: dict, launches: dict) -> None:
    for k, v in launches.items():
        total[k] = total.get(k, 0) + v


def expect_fault(label: str, fn, *args, **kwargs) -> float:
    """Call ``fn`` while a scripted fault is armed: on the card it must
    raise ``DeviceFaultError`` and move no breadcrumb (no window leaves
    the card for a host oracle).  Returns its wall in ms."""
    from karpenter_tpu_torch.faulttol import DeviceFaultError

    before = degradation_marks()
    t0 = time.perf_counter()
    try:
        fn(*args, **kwargs)
    except DeviceFaultError:
        ms = (time.perf_counter() - t0) * 1e3
    else:
        raise AssertionError(f"{label}: the scripted fault did not raise")
    expect_marks(label, before, {})
    return ms


def degraded_make_solver(dev, request, main_plan, launches: dict) -> dict:
    """(u1) ``make_solver()`` on the headline: the plan of ``TorchSolver``
    without faults; a scripted ``"error"`` on the next dispatch raises
    ``DeviceFaultError`` out of the wrapped solver (a solver on the card
    never degrades to the host), moves no breadcrumb and leaves the
    resident store invalidated once; the next window runs on the card
    again."""
    from karpenter_tpu_torch import make_solver

    solver = make_solver(device=dev)
    plan = solver.solve(request)
    plans_equal("make_solver headline", plan, main_plan)
    if plan.backend.startswith("degraded:"):
        raise AssertionError(f"make_solver headline: {plan.backend}")
    res = make_solver(SolverOptions(resident="on"), device=dev)
    plans_equal("make_solver resident headline", res.solve(request),
                main_plan)
    inv = res.resident.invalidations
    with injected():
        fault_ms = expect_fault("faulted headline", res.solve, request)
    if res.resident.invalidations != inv + 1:
        raise AssertionError(f"faulted headline: the resident store was "
                             f"invalidated {res.resident.invalidations - inv}"
                             f" times, want once")
    reset_launches()
    plan = res.solve(request)
    got = launch_counts()
    require_launches(got, ["ffd_scan", "cost_sum"], "window after a fault")
    add_launches(launches, got)
    plans_equal("window after a fault", plan, main_plan)
    if res.resident.last_rebuild_reason != "dispatch_error":
        raise AssertionError(f"window after a fault rebuilt for "
                             f"{res.resident.last_rebuild_reason!r}")
    say(f"degraded (u1): make_solver() headline plan equal to "
        f"TorchSolver's ({plan.backend}); a scripted error on the next "
        f"dispatch raised DeviceFaultError out of make_solver's solver in "
        f"{fault_ms:.3f} ms, no breadcrumb, the resident store invalidated "
        f"once; the next window on the card (launches {got}), rebuilt for "
        f"dispatch_error")
    return {"fault_ms": fault_ms}


def strip_case(dev, label: str, route: str, request, program: str,
               launches: dict) -> dict:
    """(u2) One route strip at full width: the route's program raises a
    host-side error; the window re-runs on the FFD route (``ffd_scan``
    launched) with one breadcrumb, and its plan equals the CPU twin's
    (the stripped window on the CPU solver: the deterministic /
    unconstrained scan, the decode checks of the route still applied);
    the same window again takes the scan with no second breadcrumb.  A
    scripted ``DeviceFaultError`` on the route strips nothing, and
    ``ResilientSolver`` raises it on the card."""
    from karpenter_tpu_torch import make_solver
    from karpenter_tpu_torch.faulttol import DeviceFaultError
    from karpenter_tpu_torch.solver import torch_backend

    pods, catalog, pool = request.pods, request.catalog, request.nodepool
    crumbs = {f"errors{{solver,{route}_fallback}}": 1.0}
    if route == "stochastic":
        crumbs["overcommit_solves{degraded}"] = 1.0

    def broken(*a, **k):
        raise RuntimeError(f"scripted {route} program fault")

    # the encode memoizes an unchanged window's problem, whose cached
    # template the strip disarms: each step starts from a fresh one
    encode_mod._ENCODE_MEMO.clear()
    problem = encode_mod.encode(pods, catalog, pool)
    solver = TorchSolver(device=dev)
    with _patched(torch_backend, program, broken):
        before = degradation_marks()
        reset_launches()
        t0 = time.perf_counter()
        plan = solver.solve_encoded(problem)
        strip_ms = (time.perf_counter() - t0) * 1e3
        got = launch_counts()
        require_launches(got, ["ffd_scan"], f"{label} strip re-run")
        add_launches(launches, got)
        expect_marks(f"{label} strip", before, crumbs)
        # the CPU twin: the stripped window on the CPU solver, whose plan
        # is the FFD route's with the route's decode checks still applied
        want = TorchSolver(device="cpu").solve_encoded(problem)
        plans_equal(f"{label} strip", plan, want)
        if solver.last_stats["path"] != solver.path:
            raise AssertionError(f"{label} strip took "
                                 f"{solver.last_stats['path']!r}")
        mid = degradation_marks()
        reset_launches()
        t0 = time.perf_counter()
        again = solver.solve_encoded(problem)
        again_ms = (time.perf_counter() - t0) * 1e3
        got = launch_counts()
        require_launches(got, ["ffd_scan"], f"{label} after the strip")
        add_launches(launches, got)
        expect_marks(f"{label} after the strip", mid, {})
        plans_equal(f"{label} after the strip", again, want)
    # a device fault on the route: never stripped, raised by the wrapper
    encode_mod._ENCODE_MEMO.clear()
    problem = encode_mod.encode(pods, catalog, pool)
    with injected(route):
        expect_fault(f"{label} device fault", TorchSolver(device=dev)
                     .solve_encoded, problem)
    leaf = "sto" if route == "stochastic" else "aff"
    if any(getattr(t, leaf) is None for t in problem._prep_cache.values()):
        raise AssertionError(f"{label}: a device fault stripped the route")
    encode_mod._ENCODE_MEMO.clear()
    wrapped = make_solver(device=dev)
    with injected(route):
        fault_ms = expect_fault(f"{label} device fault through "
                                f"make_solver", wrapped.solve, request)
    return {"plan_nodes": len(want.nodes), "strip_ms": strip_ms,
            "again_ms": again_ms, "fault_ms": fault_ms}


def degraded_serving(dev, launches: dict) -> dict:
    """(u3) Phase (j)'s windows through ``ServingLoop``: a device fault
    at the kick and one at the fetch each fail the window over to the
    classic path, whose plan equals the classic plan."""
    seqs, catalog = churn_stream(SERVING)
    problems = [encode_mod.encode(p, catalog) for p in seqs[:3]]
    on = TorchSolver(SolverOptions(serving="on"), device=dev)
    off = TorchSolver(SolverOptions(serving="off"), device=dev)
    loop = on.serving
    loop.submit(problems[0]).result()
    before = degradation_marks()
    reset_launches()
    with injected("serving-kick"):
        kicked = loop.submit(problems[1]).result()
    pend = loop.submit(problems[2])
    with injected("serving-fetch"):
        fetched = pend.result()
    got = launch_counts()
    require_launches(got, ["ffd_scan", "cost_sum"], "serving failovers")
    add_launches(launches, got)
    plans_equal("serving kick failover", kicked,
                off.solve_encoded(problems[1]))
    plans_equal("serving fetch failover", fetched,
                off.solve_encoded(problems[2]))
    if loop.host_failovers != 2:
        raise AssertionError(f"serving: host_failovers "
                             f"{loop.host_failovers}, want 2")
    expect_marks("serving failovers", before,
                 {"serving_windows{host_failover}": 2.0})
    return {"host_failovers": loop.host_failovers}


def degraded_sharded(dev, pods, catalog, launches: dict) -> dict:
    """(u3) The pref window through ``make_solver(sharded=2)`` takes the
    host route (equal to the CPU service's host route).  A device fault
    at the sharded kick and one at the fetch raise out of
    ``ResilientShardedService`` on the card (``degraded_windows`` 0, the
    state invalidated), and so do the sharded serving loop's
    (``host_failovers`` 0); the next window runs on the card again."""
    from karpenter_tpu_torch import make_solver
    from karpenter_tpu_torch.serving.service import ShardedServingLoop
    from karpenter_tpu_torch.sharded.degraded import ResilientShardedService
    from karpenter_tpu_torch.sharded.service import ShardedSolveService

    S = SHARDED["shards"]
    pref = workload.with_preferences(pods)
    solver = make_solver(SolverOptions(sharded=S), device=dev)
    host0 = metrics.SHARDED_SOLVES.get("host")
    t0 = time.perf_counter()
    plan = solver.solve(SolveRequest(pref, catalog))
    host_ms = (time.perf_counter() - t0) * 1e3
    if plan.backend != "sharded-host" \
            or metrics.SHARDED_SOLVES.get("host") != host0 + 1:
        raise AssertionError(f"sharded pref window: backend {plan.backend}")
    want = ShardedSolveService(S, device="cpu").solve_window_host(
        catalog, pods=pref).merged()
    plans_equal("sharded pref window (host route)", plan, want)
    svc = ResilientShardedService(ShardedSolveService(S, device=dev))
    clean = svc.solve_window(catalog, pods=pods).merged()
    for site in ("sharded-solve", "sharded-fetch"):
        inv = svc.invalidations
        with injected(site):
            expect_fault(f"sharded window faulted at {site}",
                         svc.solve_window, catalog, pods=pods)
        if svc.invalidations != inv + 1:
            raise AssertionError(f"sharded {site}: the state was "
                                 f"invalidated {svc.invalidations - inv} "
                                 f"times, want once")
    if svc.degraded_windows:
        raise AssertionError(f"sharded: degraded_windows "
                             f"{svc.degraded_windows}, want 0")
    reset_launches()
    again = svc.solve_window(catalog, pods=pods)
    got = launch_counts()
    require_window_launches(got, "sharded window after a fault")
    add_launches(launches, got)
    plans_equal("sharded window after a fault", again.merged(), clean)
    loop = ShardedServingLoop(ShardedSolveService(S, device=dev),
                              capacity=SHARDED["capacity"])
    loop.submit(catalog, pods=pods).result()
    with injected("sharded-solve"):
        expect_fault("sharded serving kick fault", loop.submit, catalog,
                     pods=pods)
    pend = loop.submit(catalog, pods=pods)
    with injected("sharded-fetch"):
        expect_fault("sharded serving fetch fault", pend.result)
    if loop.host_failovers:
        raise AssertionError(f"sharded serving: host_failovers "
                             f"{loop.host_failovers}, want 0")
    plans_equal("sharded serving after the faults",
                loop.submit(catalog, pods=pods).result().merged(), clean)
    return {"host_route_ms": host_ms,
            "degraded_windows": svc.degraded_windows,
            "serving_host_failovers": loop.host_failovers}


def degraded_planes(dev, cases: dict) -> dict:
    """(u4) The gang, preemption, repack and what-if wrappers over their
    planners on the card: a clean plan passes the wrapper's gate equal to
    phase (t)'s greedy plans (the what-if plan on the device route), and
    a scripted fault at the planner's next dispatch raises out of the
    wrapper with no breadcrumb and no host plan."""
    from karpenter_tpu_torch.gang import (
        GangOptions, GangPlanner, ResilientGangPlanner,
    )
    from karpenter_tpu_torch.preempt import (
        PreemptionPlanner, ResilientPlanner,
    )
    from karpenter_tpu_torch.repack import (
        RepackOptions, RepackPlanner, ResilientRepacker,
    )

    gprob, gref = cases["gang"]
    pprob, victims, compat, opts, pref_plan = cases["preempt"]
    dprob, dref = cases["defrag"]
    planes = (
        ("gang", ResilientGangPlanner(GangPlanner(
            GangOptions(use_device="on"), device=dev)), (gprob,),
         gang_fingerprint, gref),
        ("preemption", ResilientPlanner(PreemptionPlanner(
            dataclasses.replace(opts, use_device="on"), device=dev)),
         (pprob, victims, compat), preempt_fingerprint, pref_plan),
        ("repack", ResilientRepacker(RepackPlanner(
            RepackOptions(use_device="on"), device=dev)), (dprob,),
         repack_fingerprint, dref))
    for name, wrapper, args, fingerprint, ref in planes:
        got = wrapper.plan(*args)
        if fingerprint(got) != fingerprint(ref) \
                or got.backend.startswith("degraded:"):
            raise AssertionError(f"{name} wrapper on the card: plan "
                                 f"({got.backend}) differs from the greedy "
                                 f"planner's")
        with injected():
            expect_fault(f"{name} wrapper faulted", wrapper.plan, *args)
    pods, catalog = workload.build_workload(WHATIF["pods"], WHATIF["types"])
    baseline = whatif.build_baseline(pods, catalog)
    menu = whatif_menu(baseline, catalog, DEGRADED["whatif_k"],
                       np.random.RandomState(WHATIF["menu_seed"]))
    wrapper = whatif.ResilientPlanner(whatif.WhatIfPlanner(device=dev))
    got = wrapper.plan(baseline, menu)
    if got.backend != "device" or wrapper.degraded_plans:
        raise AssertionError(f"what-if wrapper on the card: {got.backend}")
    with injected("whatif"):
        expect_fault("what-if wrapper faulted", wrapper.plan, baseline,
                     menu)
    if wrapper.degraded_plans:
        raise AssertionError("what-if wrapper on the card degraded a plan")
    return {"whatif_k": len(menu)}


def wrapper_cost(dev, card: str, request) -> dict:
    """(u5) The headline p50 through ``make_solver()`` and through
    ``TorchSolver`` in rounds of turns, and ``plan_defects`` alone on the
    headline plan (printed, not gated).  Under the (u0) gate: no timed
    window may degrade, so no wrapped plan's backend starts with
    ``degraded:`` and no breadcrumb moves."""
    from karpenter_tpu_torch import make_solver

    wrapped = make_solver(device=dev)
    direct = TorchSolver(device=dev)
    plan = direct.solve(request)
    wrapped.solve(request)
    walls = {"make_solver": [], "TorchSolver": []}
    ratios = []
    backends = set()
    before = degradation_marks()
    for r in range(DEGRADED["rounds"]):
        order = (("make_solver", wrapped), ("TorchSolver", direct))
        if r % 2:
            order = order[::-1]
        got = {}
        for name, s in order:
            xs = []
            for _ in range(DEGRADED["per_round"]):
                t0 = time.perf_counter()
                backends.add(s.solve(request).backend)
                xs.append(time.perf_counter() - t0)
            walls[name].extend(xs)
            got[name] = float(np.median(xs))
        ratios.append(got["make_solver"] / got["TorchSolver"])
    expect_marks("wrapper cost", before, {})
    if any(b.startswith("degraded:") for b in backends):
        raise AssertionError(f"wrapper cost: a timed window degraded "
                             f"({sorted(backends)})")
    defects = []
    for _ in range(DEGRADED["defects_reps"]):
        t0 = time.perf_counter()
        bad = plan_defects(plan, request)
        defects.append(time.perf_counter() - t0)
    if bad:
        raise AssertionError(f"plan_defects on the headline plan: {bad[:3]}")
    out = {"make_solver_p50_ms": p50_ms(walls["make_solver"]),
           "torch_solver_p50_ms": p50_ms(walls["TorchSolver"]),
           "ratio_median": float(np.median(ratios)),
           "ratios": ratios, "plan_defects_p50_ms": p50_ms(defects),
           "pods": len(request.pods)}
    say(f"timing [{card}]: degraded (u5) headline p50 through make_solver() "
        f"{out['make_solver_p50_ms']:.4f} ms against TorchSolver "
        f"{out['torch_solver_p50_ms']:.4f} ms ({DEGRADED['rounds']} rounds "
        f"of turns x {DEGRADED['per_round']} windows; median round ratio "
        f"{out['ratio_median']:.4f}, rounds {fmt_list(ratios)}); "
        f"plan_defects alone {out['plan_defects_p50_ms']:.4f} ms p50 at "
        f"{out['pods']} pods ({DEGRADED['defects_reps']} calls)")
    return out


def phase_degraded(dev, card: str, pods, catalog, cases: dict) -> dict:
    """(u) The degraded modes on the card, after the fault phase: (u1)
    ``make_solver()`` raising a faulted headline window, (u2) the
    stochastic and affinity route strips, (u3) the serving loop's
    failover, the sharded host route and the sharded wrappers raising,
    (u4) the planes' wrappers raising, (u5) the wrapper's cost.  Every
    scripted fault is drawn once and leaves the breadcrumbs it must, and
    only those: a window that would leave the card raises instead."""
    t_phase = time.perf_counter()
    launches: dict = {}
    request = SolveRequest(pods, catalog)
    main_plan = TorchSolver(device=dev).solve(request)
    out = {"make_solver": degraded_make_solver(dev, request, main_plan,
                                               launches)}
    scat = workload.build_catalog(HEADLINE["types"])
    pool = NodePool(name="default", overcommit=STOCHASTIC["overcommit"])
    out["stochastic_strip"] = strip_case(
        dev, "stochastic window", "stochastic", SolveRequest(
            workload.stochastic_pods(HEADLINE["pods"],
                                     seed=STOCHASTIC["seed"]), scat, pool),
        "solve_packed_stochastic", launches)
    out["affinity_strip"] = strip_case(
        dev, "affinity window", "affinity", SolveRequest(
            workload.affinity_bench_pods(
                AFFINITY["tag"], HEADLINE["pods"],
                np.random.RandomState(AFFINITY["rng_seed"])), scat),
        "solve_packed_affinity", launches)
    say(f"degraded (u2): the stochastic (seed {STOCHASTIC['seed']}) and "
        f"affinity (seed {AFFINITY['rng_seed']}) windows with their route "
        f"program raising: re-run on ffd_scan with one breadcrumb each, "
        f"plans equal to the CPU solver's on the stripped windows; "
        f"the same windows again on the scan with none; a device fault on "
        f"each route strips nothing and raises out of ResilientSolver on "
        f"the card; walls stochastic / affinity: the strip "
        f"{out['stochastic_strip']['strip_ms']:.3f} / "
        f"{out['affinity_strip']['strip_ms']:.3f} ms, the window again "
        f"{out['stochastic_strip']['again_ms']:.3f} / "
        f"{out['affinity_strip']['again_ms']:.3f} ms, the faulted window "
        f"{out['stochastic_strip']['fault_ms']:.3f} / "
        f"{out['affinity_strip']['fault_ms']:.3f} ms")
    out["serving"] = degraded_serving(dev, launches)
    out["sharded"] = degraded_sharded(dev, pods, catalog, launches)
    say(f"degraded (u3): ServingLoop kick and fetch faults failed over to "
        f"the classic path (host_failovers "
        f"{out['serving']['host_failovers']}, plans equal); the pref "
        f"window through make_solver(sharded={SHARDED['shards']}) on the "
        f"host route ({out['sharded']['host_route_ms']:.3f} ms), equal to "
        f"the CPU host route; sharded kick and fetch faults raised on the "
        f"card (degraded_windows {out['sharded']['degraded_windows']}, the "
        f"sharded serving loop's host_failovers "
        f"{out['sharded']['serving_host_failovers']}), the next windows "
        f"on the card")
    out["planes"] = degraded_planes(dev, cases)
    say("degraded (u4): the gang, preemption and repack wrappers over "
        "their planners on the card pass phase (t)'s greedy plans, the "
        "what-if wrapper its device plan (K = "
        f"{out['planes']['whatif_k']}); a scripted fault at each planner's "
        "next dispatch raised out of its wrapper, no breadcrumb, no host "
        "plan")
    out["cost"] = wrapper_cost(dev, card, request)
    out["launches"] = launches
    out["host_s"] = time.perf_counter() - t_phase
    say(f"degraded phase: {out['host_s']:.3f} s, launches {launches}")
    return out


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes of an input read once: a catalog expanded over the problems
    (stride 0) is one catalog."""
    n = int(t.numel() * t.element_size())
    if t.dim() > 1 and t.stride(0) == 0:
        n //= t.shape[0]
    return n


def scan_bound_ms(meta, compat, alloc, rank, N: int, assign, node_off):
    """The least time the card could take for the scan of C problems:
    the larger of the bytes it must move (inputs read once, outputs
    written once) over the HBM rate, and the scalar operations this run's
    data needs (open nodes at each group's step, every offering, per
    problem) over the scalar rate."""
    G, O = compat.shape[-2:]
    assign = assign.reshape(-1, G, N)
    node_off = node_off.reshape(-1, N)
    C = assign.shape[0]
    nbytes = sum(_read_bytes(t) for t in (meta, compat, alloc, rank)) \
        + 4 * C * (N + G * N + G)
    ops = 0
    for a, no in zip(assign, node_off):
        first = np.where((a > 0).any(axis=0), (a > 0).argmax(axis=0),
                         G)[no >= 0]
        open_before = np.searchsorted(np.sort(first), np.arange(G), "left")
        ops += OPS_PER_NODE * int(open_before.sum()) \
            + OPS_PER_OFFERING * G * O
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations"), nbytes, ops


def _is_launch(e) -> bool:
    """A host-side CUDA API record that starts one kernel
    (``cudaLaunchKernel``, ``cuLaunchKernel``, ``cudaLaunchKernelExC``,
    ...); its id is the CUPTI correlation id its kernel carries."""
    return e.name.startswith("cu") and "Launch" in e.name \
        and "HostFunc" not in e.name


def profile_spans(run, spans: int, tag: str) -> dict | None:
    """Device kernels and busy share of ``spans`` warm calls of ``run``,
    from a ``torch.profiler`` trace: each call is a ``tag`` range on the
    host.  A span's kernels are the kernel launches the host issued
    inside its range (any thread), each joined to its device kernel by
    correlation id; a launch whose device record the trace lost still
    counts, and a device kernel whose launch record it lost counts apart
    (``unattributed``).  The device's kernel/copy intervals inside the
    ranges are merged into busy time.  The profiler slows the host, so
    the busy share read here is a lower bound on the unprofiled one.
    Returns None when the trace holds no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(spans):
            with record_function(tag):
                run()
        # the last span's kernels end inside the trace
        torch.cuda.synchronize()
    events = prof.events()
    ranges = sorted((e.time_range.start, e.time_range.end) for e in events
                    if e.name == tag and e.device_type == DeviceType.CPU)
    device = [e for e in events
              if e.device_type == DeviceType.CUDA and e.name != tag]
    if not device or len(ranges) != spans:
        return None
    launches = [e for e in events
                if e.device_type == DeviceType.CPU and _is_launch(e)]
    kernel_ids = {e.id for e in device
                  if not e.name.startswith(("Memcpy", "Memset"))}
    per_span = [sorted({e.id for e in launches
                        if lo <= e.time_range.start <= hi})
                for lo, hi in ranges]
    in_spans = {i for ids in per_span for i in ids}
    launch_ids = {e.id for e in launches}
    busy = 0.0
    for lo, hi in ranges:
        cut = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                     for e in device)
        end = lo
        for s, t in cut:
            if t > max(s, end):
                busy += t - max(s, end)
                end = t
    span_us = sum(hi - lo for lo, hi in ranges)
    unattributed = len(kernel_ids - launch_ids)
    return {"spans": spans,
            "kernels_by_span": [len(ids) for ids in per_span],
            "kernels_per_span": (len(in_spans) + unattributed) / spans,
            "device_records_lost": len(in_spans - kernel_ids),
            "unattributed": unattributed,
            "device_events_per_span": len(device) / spans,
            "profiled_span_ms": span_us / spans / 1e3,
            "device_busy_ms": busy / spans / 1e3,
            "device_busy_share": busy / span_us}


def kernels_per_call(run, tag: str, counter: dict, key: str,
                     spans: int = 20, tries: int = 3) -> int:
    """The device kernels one call of ``run`` issues, an exact integer
    read from ``profile_spans``: every span must hold the same count, no
    device kernel may lack its launch record, and the spans must hold at
    least as many launches as ``counter[key]`` (a wrapper's LAUNCHES)
    grew by over the same calls.  A trace that falls short is taken
    again, up to ``tries`` times; then the call raises."""
    why = ""
    for _ in range(tries):
        before = counter[key]
        prof = profile_spans(run, spans, tag)
        grew = counter[key] - before
        if prof is None:
            why = "the trace holds no device events"
            continue
        counts = prof["kernels_by_span"]
        if prof["unattributed"] or len(set(counts)) != 1 \
                or sum(counts) < grew:
            why = (f"kernels by span {counts}, {prof['unattributed']} "
                   f"device kernels without a launch record, {grew} "
                   f"{key} launches counted")
            continue
        return counts[0]
    raise AssertionError(f"{tag}: kernels per call not read exactly from "
                         f"torch.profiler in {tries} traces: {why}")


def phase_timings(dev, solver, request, problem, card: str) -> dict:
    walls, stats = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        solver.solve(request)
        walls.append(time.perf_counter() - t0)
        stats.append(dict(solver.last_stats))
    p50 = float(np.percentile(walls, 50)) * 1e3
    host = {k: float(np.median([s[k] for s in stats])) * 1e3
            for k in ("prepare_s", "dispatch_s", "exec_fetch_s",
                      "decode_s", "wall_s")}

    # device phases of one window, on the window's own tensors
    prep = solver._prepare(problem)
    G, O, U, N = prep.G_pad, prep.O_pad, prep.U_pad, prep.N
    off_alloc, off_price, off_rank = solver.device_offerings(
        request.catalog, O)
    pinned = torch.from_numpy(prep.packed).pin_memory()
    packed = pinned.to(dev)
    meta, compat_i, rows_g = tp.unpack_problem(packed, off_alloc, G, O, U)
    meta3, compat3 = meta[None].contiguous(), compat_i[None].contiguous()
    node_off, assign, unplaced = (x[0] for x in ffd_kernel.ffd_scan(
        meta3, compat3, off_alloc, off_rank, N))
    out = tp.solve_packed_torch(packed, off_alloc, off_price, off_rank,
                                G=G, O=O, U=U, N=N, compact=prep.K,
                                dense16=prep.dense16, coo16=prep.coo16)
    host_out = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    phases = {
        "h2d": cuda_ms(lambda: packed.copy_(pinned, non_blocking=True), 50),
        "unpack": cuda_ms(lambda: tp.unpack_problem(packed, off_alloc, G, O,
                                                    U), 50),
        "kernel": cuda_ms(lambda: ffd_kernel.ffd_scan(
            meta3, compat3, off_alloc, off_rank, N), 50),
        "right_size_cost": cuda_ms(lambda: tp.cost_word(tp.finish_solve(
            meta, compat_i, node_off, assign, off_alloc, off_rank, True),
            off_price), 20),
        "pack_explain_telemetry": cuda_ms(lambda: tp.pack_result_telemetry(
            meta, rows_g, compat_i, node_off, assign, unplaced,
            off_price.sum(), off_alloc, prep.K, prep.dense16, prep.coo16),
            20),
        "d2h": cuda_ms(lambda: host_out.copy_(out, non_blocking=True), 50),
        "solve_packed_total": cuda_ms(lambda: tp.solve_packed_torch(
            packed, off_alloc, off_price, off_rank, G=G, O=O, U=U, N=N,
            compact=prep.K, dense16=prep.dense16, coo16=prep.coo16), 20),
    }
    plain_ms = cuda_ms(lambda: ffd_kernel.ffd_scan_reference(
        meta3, compat3, off_alloc, off_rank, N), 3, warm=1)
    bound_ms, bound_by, nbytes, ops = scan_bound_ms(
        meta3, compat3, off_alloc, off_rank, N, assign.cpu().numpy(),
        node_off.cpu().numpy())
    cs = cost_sum_timing("the main-path window", tp.finish_solve(
        meta, compat_i, node_off, assign, off_alloc, off_rank, True),
        off_price, card)

    # encode, cold (memo and signature caches cleared) and warm
    encode_mod._ENCODE_MEMO.clear()
    encode_mod.clear_sig_cache()
    t0 = time.perf_counter()
    encode_mod.encode(request.pods, request.catalog)
    enc_cold = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    encode_mod.encode(request.pods, request.catalog)
    enc_warm = (time.perf_counter() - t0) * 1e3

    say(f"timing [{card}]: p50 wall of 20 warm windows {p50:.4f} ms "
        f"(min {min(walls) * 1e3:.4f}, max {max(walls) * 1e3:.4f}); host "
        f"medians: prepare {host['prepare_s']:.4f} ms, dispatch "
        f"{host['dispatch_s']:.4f} ms, exec+fetch "
        f"{host['exec_fetch_s']:.4f} ms, decode {host['decode_s']:.4f} ms")
    say(f"timing [{card}]: encode cold {enc_cold:.3f} ms, warm (memo) "
        f"{enc_warm:.4f} ms")
    say(f"timing [{card}]: device phases of one window (CUDA events, "
        f"G={G} O={O} U={U} N={N}): " + ", ".join(
            f"{k} {v:.4f} ms" for k, v in phases.items()))
    prof = profile_spans(lambda: solver.solve(request), 5, "solve_window")
    if prof is None:
        say(f"profile [{card}]: torch.profiler recorded no device events; "
            f"launches and device busy share not measured")
    else:
        say(f"profile [{card}]: {prof['spans']} warm windows under "
            f"torch.profiler: {prof['kernels_per_span']:.1f} kernels and "
            f"{prof['device_events_per_span']:.1f} device events (kernels "
            f"+ copies) per window; device busy "
            f"{prof['device_busy_ms']:.4f} ms of a "
            f"{prof['profiled_span_ms']:.4f} ms profiled window (busy "
            f"share {prof['device_busy_share']:.4f})")
    say(f"timing [{card}]: ffd_scan kernel {phases['kernel']:.4f} ms "
        f"({phases['kernel'] / G * 1e3:.4f} us per group step, G={G}), "
        f"plain PyTorch version {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}: {nbytes} bytes, {ops} scalar ops); no single "
        f"PyTorch call computes the scan (library_ms null)")
    return {"p50_wall_ms": p50, "walls_ms": [w * 1e3 for w in walls],
            "host_ms": host, "device_phases_ms": phases, "profile": prof,
            "encode_cold_ms": enc_cold, "encode_warm_ms": enc_warm,
            "shape": {"G": G, "O": O, "U": U, "N": N},
            "ffd_scan": {"ms": phases["kernel"], "plain_ms": plain_ms,
                         "us_per_step": phases["kernel"] / G * 1e3,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "bytes": nbytes, "ops": ops},
            "cost_sum": cs,
            "ffd_scan_largest": largest_scan_ms(dev, card)}


def largest_scan_ms(dev, card: str) -> dict:
    """``ffd_scan``'s own time at the largest shape the checks run, G=2048
    O=4096 N=4096 (C=1), beside its plain version (one run) and bound."""
    G, O, N = 2048, 4096, 4096
    meta, compat, alloc, rank = (torch.from_numpy(x).to(dev) for x in
                                 scan_inputs(100, G, O))
    m, c = meta[None], compat[None]
    node_off, assign, _ = ffd_kernel.ffd_scan(m, c, alloc, rank, N)
    ms = cuda_ms(lambda: ffd_kernel.ffd_scan(m, c, alloc, rank, N), 10)
    plain_ms = cuda_ms(lambda: ffd_kernel.ffd_scan_reference(
        m, c, alloc, rank, N), 1, warm=0)
    bound_ms, bound_by, nbytes, ops = scan_bound_ms(
        m, c, alloc, rank, N, assign.cpu().numpy(), node_off.cpu().numpy())
    say(f"timing [{card}]: ffd_scan at the largest shape G={G} O={O} N={N}: "
        f"kernel {ms:.4f} ms ({ms / G * 1e3:.4f} us per group step), plain "
        f"PyTorch version {plain_ms:.4f} ms, bound {bound_ms:.6f} ms "
        f"({bound_by}: {nbytes} bytes, {ops} scalar ops)")
    return {"G": G, "O": O, "N": N, "ms": ms, "us_per_step": ms / G * 1e3,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes, "ops": ops}


def fleet_scan_ms(dev, fleet: dict, card: str) -> dict:
    """``ffd_scan_fleet``'s own time at C = 8 on the fleet's unpacked
    tensors (a catalog per cluster), beside its plain version and bound."""
    stacked, N, U = fleet["stacked"], fleet["N"], fleet["U"]
    C, G, O = stacked.compat.shape
    alloc, rank, _ = fleet["dev_catalog"]
    ins = torch.from_numpy(fleet["packed"][0]).to(dev)
    metas, compats, _ = torch.func.vmap(
        lambda p, a: tp.unpack_problem(p, a, G, O, U))(ins, alloc)
    metas = metas.contiguous()
    return scan_times(dev, f"fleet C={C} (a catalog per cluster)", N,
                      metas, compats, alloc, rank, card)


def stream_scan_ms(dev, solver, windows, card: str) -> dict:
    """``ffd_scan_fleet``'s own time at C = 16 on one stream batch's
    unpacked tensors (the headline catalog expanded, stride 0)."""
    preps = [solver._prepare(p) for _, p in windows[:STREAM["batch"]]]
    p0 = preps[0]
    G, O, U = p0.G_pad, p0.O_pad, p0.U_pad
    N = max(pr.N for pr in preps)
    off_alloc, _, off_rank = solver.device_offerings(windows[0][1].catalog,
                                                     O)
    rows = torch.from_numpy(np.stack([pr.packed for pr in preps])).to(dev)
    metas, compats, _ = torch.func.vmap(
        lambda p: tp.unpack_problem(p, off_alloc, G, O, U))(rows)
    C = rows.shape[0]
    return scan_times(dev, f"stream batch C={C} (one catalog, stride 0)",
                      N, metas.contiguous(), compats,
                      off_alloc.expand(C, O, 4), off_rank.expand(C, O),
                      card)


def scan_times(dev, label, N, metas, compats, alloc, rank, card) -> dict:
    node_off, assign, _ = ffd_kernel.ffd_scan_fleet(metas, compats, alloc,
                                                    rank, N)
    ms = cuda_ms(lambda: ffd_kernel.ffd_scan_fleet(metas, compats, alloc,
                                                   rank, N), 20)
    plain_ms = cuda_ms(lambda: ffd_kernel.ffd_scan_fleet_reference(
        metas, compats, alloc, rank, N), 1, warm=1)
    bound_ms, bound_by, nbytes, ops = scan_bound_ms(
        metas, compats, alloc, rank, N, assign.cpu().numpy(),
        node_off.cpu().numpy())
    C, G, O = compats.shape
    say(f"timing [{card}]: ffd_scan_fleet {label}, G={G} O={O} N={N}: "
        f"kernel {ms:.4f} ms ({ms / C:.4f} ms per problem, "
        f"{ms / G * 1e3:.4f} us per group step), plain PyTorch "
        f"version {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}: "
        f"{nbytes} bytes, {ops} scalar ops); no single PyTorch call "
        f"computes the scan (library_ms null)")
    return {"C": C, "G": G, "O": O, "N": N, "ms": ms,
            "us_per_step": ms / G * 1e3, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
            "ops": ops}


def phase_batched_timings(dev, fleet: dict, stream: dict, card: str) -> dict:
    """The fleet's single-shot and pipelined walls; the stream's
    amortized per-window wall at batch 1 and 16 beside the single-window
    p50 (turns ABBA, one process); the fleet kernel's own times; the
    stream's kernels per batch and device busy share."""
    stacked, N = fleet["stacked"], fleet["N"]
    kw = dict(num_nodes=N, device=dev, device_catalog=fleet["dev_catalog"],
              packed_inputs=fleet["packed"])
    walls = []
    for _ in range(10):
        t0 = time.perf_counter()
        fleet_solve_packed(stacked, **kw)
        walls.append(time.perf_counter() - t0)
    fleet_p50 = float(np.percentile(walls, 50)) * 1e3

    def fleet_pipelined(n: int, depth: int = 8) -> float:
        fins = []
        t0 = time.perf_counter()
        for _ in range(n):
            fins.append(fleet_solve_packed(stacked, async_only=True, **kw))
            if len(fins) > depth:
                fins.pop(0)()
        while fins:
            fins.pop(0)()
        return (time.perf_counter() - t0) / n * 1e3

    fleet_pipelined(8)
    fleet_pipe = fleet_pipelined(24)
    C = stacked.num_clusters
    say(f"timing [{card}]: fleet {C} x {FLEET['pods']} pods: single-shot "
        f"p50 wall {fleet_p50:.4f} ms (min {min(walls) * 1e3:.4f}, max "
        f"{max(walls) * 1e3:.4f}, 10 solves); pipelined (async_only, depth "
        f"8, 24 windows) {fleet_pipe:.4f} ms per fleet window, "
        f"{C * FLEET['pods'] / fleet_pipe * 1e3:.1f} pods/s")

    solver, windows, order = (stream["solver"], stream["windows"],
                              stream["order"])
    problem = windows[0][1]
    single = []
    for _ in range(20):
        t0 = time.perf_counter()
        solver.solve_encoded(problem)
        single.append(time.perf_counter() - t0)
    single_p50 = float(np.percentile(single, 50)) * 1e3

    def stream_ms(batch: int) -> float:
        t0 = time.perf_counter()
        n = sum(1 for _ in solver.solve_stream(
            (windows[i][1] for i in order), depth=STREAM["depth"],
            batch=batch))
        return (time.perf_counter() - t0) / n * 1e3

    runs = {1: [], STREAM["batch"]: []}
    batch_phases = []            # host phases of each run's last batch
    for b in (1, STREAM["batch"], STREAM["batch"], 1):
        runs[b].append(stream_ms(b))
        if b > 1:
            batch_phases.append({k: solver.last_stats[k] * 1e3 for k in (
                "wall_s", "dispatch_s", "exec_fetch_s", "decode_s")})
    amort = {b: float(np.mean(v)) for b, v in runs.items()}
    say(f"timing [{card}]: stream of {len(order)} windows at depth "
        f"{STREAM['depth']}: amortized per-window wall batch=1 "
        f"{amort[1]:.4f} ms (runs {', '.join(f'{x:.4f}' for x in runs[1])})"
        f", batch={STREAM['batch']} {amort[STREAM['batch']]:.4f} ms (runs "
        f"{', '.join(f'{x:.4f}' for x in runs[STREAM['batch']])}); "
        f"single-window solve_encoded p50 {single_p50:.4f} ms (20 solves)")
    say(f"timing [{card}]: the last batch of {STREAM['batch']} of each "
        f"batched run, host clock: " + "; ".join(
            f"dispatch {p['dispatch_s']:.4f} ms, exec+fetch "
            f"{p['exec_fetch_s']:.4f} ms, decode of the plans "
            f"{p['decode_s']:.4f} ms" for p in batch_phases))

    half = STREAM["batch"] * 2           # two batches per profiled stream
    sub = order[:half]
    profiles = {}
    for b in (1, STREAM["batch"]):
        prof = profile_spans(lambda: list(solver.solve_stream(
            (windows[i][1] for i in sub), depth=STREAM["depth"], batch=b)),
            1, f"stream_batch{b}")
        profiles[b] = prof
        if prof is None:
            say(f"profile [{card}]: stream batch={b}: torch.profiler "
                f"recorded no device events; not measured")
            continue
        units = len(sub) // b
        say(f"profile [{card}]: stream of {len(sub)} windows at batch={b} "
            f"under torch.profiler: "
            f"{prof['kernels_per_span'] / units:.1f} kernels per "
            f"{'batch' if b > 1 else 'window'} "
            f"({prof['kernels_per_span'] / len(sub):.1f} per window); "
            f"device busy {prof['device_busy_ms']:.4f} ms of a "
            f"{prof['profiled_span_ms']:.4f} ms profiled stream (busy share "
            f"{prof['device_busy_share']:.4f})")
    fleet_kernel = fleet_scan_ms(dev, fleet, card)
    stream_kernel = stream_scan_ms(dev, solver, windows, card)
    return {"fleet_p50_ms": fleet_p50, "fleet_walls_ms": [w * 1e3
                                                          for w in walls],
            "fleet_pipelined_ms": fleet_pipe,
            "single_window_p50_ms": single_p50,
            "stream_amortized_ms": amort, "stream_runs_ms": runs,
            "stream_batch_phases_ms": batch_phases,
            "stream_profiles": profiles,
            "ffd_scan_fleet": fleet_kernel,
            "ffd_scan_fleet_stream": stream_kernel}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--json-out", type=Path, default=None,
                        help="also write every measurement to this file")
    parser.add_argument("--cold-child", choices=("with", "without"),
                        default=None,
                        help="run one side of the fault phase's cold "
                             "windows (f) and exit; the phase starts these")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this "
              "script needs one CUDA card", file=sys.stderr)
        return 2
    if args.cold_child is not None:
        return cold_child(args.cold_child)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the batched paths run their rows through torch.func.vmap: an op with
    # no batching rule in this torch would fall back to a loop over the
    # rows, with this warning, which those paths must never do
    warnings.filterwarnings(
        "error", message=".*not yet implemented the batching rule")
    card = card_line()
    say(card)
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python "
        f"{sys.version.split()[0]}")

    t0 = time.perf_counter()
    build_s = cuda_build.build_all()
    say(f"build: {len(build_s)} kernel(s) in "
        f"{time.perf_counter() - t0:.3f} s wall: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in build_s.items()))
    for name in build_s:
        report = cuda_build.library_path(name).with_suffix(".ptxas.txt")
        for line in report.read_text().splitlines():
            if "registers" in line or "spill" in line:
                say(f"ptxas {name}: {line.strip()}")

    pods, catalog = workload.build_workload(
        HEADLINE["pods"], HEADLINE["types"], seed=HEADLINE["seed"])
    # (u0): every phase but the fault phase (s) and the degraded phase
    # (u) runs under the gate: a degradation breadcrumb it moves fails the
    # run
    tally = new_tally()
    checks = {"ffd_scan": gated("kernel checks", phase_kernel_checks, dev,
                                catalog, tally),
              "ffd_scan_fleet": gated("fleet kernel checks",
                                      phase_fleet_kernel_checks, dev,
                                      catalog, tally)}
    design = gated("design checks", phase_design_checks, dev, tally)
    checks["ffd_scan_pref"] = gated("pref kernel checks",
                                    phase_pref_kernel_checks, dev, catalog,
                                    tally)
    checks["cost_sum"] = gated("cost_sum checks", phase_cost_sum_checks, dev)
    solver, request, problem, main_plan, launches, stats, cold_s, err = \
        gated("(a) main path", phase_main_path, dev, pods, catalog, tally)
    checks["ffd_scan"]["max_abs_err"] = max(
        checks["ffd_scan"]["max_abs_err"], err, design["max_abs_err"])
    checks["ffd_scan_fleet"]["max_abs_err"] = max(
        checks["ffd_scan_fleet"]["max_abs_err"], design["max_abs_err"])
    checks["design"] = design
    fleet = gated("(b) fleet", phase_fleet, dev)
    stream = gated("(c) stream", phase_stream, dev, catalog)
    zone = gated("(d) zone", phase_zone, dev, pods, catalog)
    # the timings come before the routes' phases, as in the earlier
    # slices; the order does not move them beyond the host's drift
    # (tools/torch_headline_aftereffect.py)
    timing = gated("timings", phase_timings, dev, solver, request, problem,
                   card)
    timing.update(gated("batched timings", phase_batched_timings, dev,
                        fleet, stream, card))
    flat = gated("(e) flat", phase_flat, dev, card)
    affinity = gated("(f) affinity", phase_affinity, dev, card)
    stochastic = gated("(g) stochastic", phase_stochastic, dev, card)
    pref = gated("(h) pref", phase_pref, dev, card, tally)
    checks["ffd_scan_pref"]["max_abs_err"] = max(
        checks["ffd_scan_pref"]["max_abs_err"], pref["max_abs_err"])
    # the pref window's own scan counts toward the per-group coverage
    checks["coverage"] = require_design_coverage(tally)
    resident = gated("(i) resident", phase_resident, dev, card)
    serving = gated("(j) serving", phase_serving, dev, card)
    fleet_resident = gated("(k) fleet resident", phase_fleet_resident, dev,
                           fleet)
    whatif_run = gated("(l) what-if", phase_whatif, dev, card)
    gang = gated("(m) gang", phase_gang, dev, card)
    preempt = gated("(n) preempt", phase_preempt, dev, card)
    sharded = gated("(o) sharded", phase_sharded, dev, card, pods, catalog)
    sharded_churn = gated("(p) sharded churn", phase_sharded_churn, dev,
                          card, catalog)
    sharded_serving = gated("(q) sharded serving", phase_sharded_serving,
                            dev, card, catalog)
    repack = gated("(r) repack", phase_repack, dev, card)
    oracles = gated("(t) oracles", phase_oracles, dev, card, solver,
                    request)
    intake = gated("(v) intake", phase_intake, dev, card, pods, catalog,
                   main_plan)
    provision = gated("(w) provisioning loop", phase_provision, dev, card,
                      pods)
    controllers = gated("(x) controllers", phase_controllers, dev, card,
                        pods)
    sidecar_run = gated("(y) sidecar", phase_sidecar, dev, card, pods,
                        catalog)
    chaos_run = gated("(z) chaos", phase_chaos, dev, card)
    whatif_service = gated("(l2) what-if service", phase_whatif_service,
                           dev, card, pods, catalog)
    iks_run = gated("(w7) iks", phase_provision_iks, dev, card, pods)
    http_run = gated("(w8) http", phase_provision_http, dev, card, pods,
                     provision.pop("plan"))
    say(f"gate (u0): no degradation breadcrumb moved in any phase (a)-(t) "
        f"but (s), nor in (v), (w1)-(w5), (x1)-(x5), (y), (z), (l2), "
        f"(w7) or (w8), no "
        f"controller's "
        f"reconcile failed and no plan was refused; "
        f"sharded_solves_total{{host}} "
        f"{metrics.SHARDED_SOLVES.get('host')} (the host route, not a "
        f"fallback; not gated)")
    fault = phase_fault(dev, card, pods, catalog)
    provision_fault = phase_provision_fault(dev, card, pods)
    controllers_fault = phase_controllers_fault(dev, card, pods)
    sidecar_fault = phase_sidecar_fault(dev, card, pods, catalog)
    chaos_fault = phase_chaos_fault(dev, card)
    whatif_fault = phase_whatif_fault(dev, card, pods, catalog)
    degraded = phase_degraded(dev, card, pods, catalog,
                              oracles.pop("cases"))
    checks["ffd_scan_fleet"]["max_abs_err"] = max(
        checks["ffd_scan_fleet"]["max_abs_err"], sharded["scan"]
        ["max_abs_err"], sharded_churn["scan"]["max_abs_err"])
    checks["cost_sum"]["max_abs_err"] = max(
        checks["cost_sum"]["max_abs_err"],
        timing["cost_sum"]["max_abs_err"],
        whatif_run["cost_sum"]["max_abs_err"])
    checks["segment_sum"] = {"max_abs_err": flat["segment_sum"]["max_abs_err"],
                             "calls": flat["segment_sum"]["calls"]}
    timing["segment_sum"] = flat["segment_sum"]
    timing["ffd_scan_pref"] = pref["ffd_scan_pref"]
    timing["presence_sum"] = pref["presence_sum"]
    checks["presence_sum"] = {"max_abs_err": pref["presence_sum"]
                              ["max_abs_err"],
                              "cases": pref["presence_sum"]["cases"]}
    # launches per kernel over the paths that run it
    path_launches = {"main": launches, "fleet": fleet["launches"],
                     "stream": stream["launches"], "zone": zone["launches"],
                     "flat": flat["launches"],
                     "affinity": affinity["launches"],
                     "stochastic": stochastic["launches"],
                     "pref": pref["route"]["launches"],
                     "resident": resident["launches"],
                     "serving": serving["launches"],
                     "fleet_resident": fleet_resident["launches"],
                     "whatif": whatif_run["launches"],
                     "gang": gang["launches"],
                     "preempt": preempt["launches"],
                     "sharded": sharded["launches"],
                     "sharded_churn": sharded_churn["launches"],
                     "sharded_serving": sharded_serving["launches"],
                     "repack": repack["launches"],
                     "intake": intake["launches"],
                     "provision": provision["launches"],
                     "controllers": controllers["launches"],
                     "sidecar": sidecar_run["launches"],
                     "chaos": chaos_run["launches"],
                     "whatif_service": whatif_service["launches"],
                     "iks": iks_run["launches"],
                     "http": http_run["launches"],
                     "fault": fault["launches"],
                     "degraded": degraded["launches"]}
    total = {name: sum(pl.get(name, 0) for pl in path_launches.values())
             for name in KERNELS}
    say(f"launches per path: {path_launches}; over all paths {total}")

    record = []
    for name, meta in KERNELS.items():
        t = timing[name]
        record.append({"name": name, **meta, "launches": total[name],
                       "max_abs_err": checks[name]["max_abs_err"],
                       "ms": t["ms"], "plain_ms": t["plain_ms"],
                       "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                       "library_ms": t.get("library_ms"),
                       "device_ms": t.get("device_ms"),
                       "kernels_per_call": t.get("kernels_per_call")})
    if args.json_out is not None:
        args.json_out.parent.mkdir(parents=True, exist_ok=True)
        args.json_out.write_text(json.dumps({
            "card": card, "torch": torch.__version__, "build_s": build_s,
            "checks": checks, "launches": path_launches,
            "main_path_stats": {
                k: v for k, v in stats.items() if k != "telemetry"},
            "telemetry": stats.get("telemetry"), "cold_solve_s": cold_s,
            "fleet": {"N": fleet["N"], "nodes": fleet["nodes"],
                      "cold_s": fleet["cold_s"]},
            "stream_first_wall_s": stream["first_wall_s"],
            "zone": {"wall_s": zone["wall_s"],
                     "last_batch": zone["last_batch"]},
            "routes": {"flat": flat["windows"], "affinity": affinity,
                       "stochastic": stochastic, "pref": pref},
            "resident": resident, "serving": serving,
            "fleet_resident": fleet_resident, "whatif": whatif_run,
            "gang": gang, "preempt": preempt, "sharded": sharded,
            "sharded_churn": sharded_churn,
            "sharded_serving": sharded_serving, "repack": repack,
            "oracles": oracles, "intake": intake, "provision": provision,
            "provision_fault": provision_fault,
            "controllers": controllers,
            "controllers_fault": controllers_fault,
            "sidecar": sidecar_run, "sidecar_fault": sidecar_fault,
            "chaos": chaos_run, "chaos_fault": chaos_fault,
            "whatif_service": whatif_service, "whatif_fault": whatif_fault,
            "iks": iks_run, "http": http_run, "fault": fault,
            "degraded": degraded,
            "timing": timing, "kernels": record}, indent=1, default=str))
    say(json.dumps({"kernels": record}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
