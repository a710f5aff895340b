"""The last public members the port carries, each against the reference's:
``SliceTable.free_grid`` / ``fits`` and ``clear_topology_cache``
(``gang/topology.py``), ``ShardRouter.component_of``,
``EncodedProblem.has_preferences``, ``affinity_enabled`` and
``AffinityIndex.req_mat`` / ``anti_mat``."""

from __future__ import annotations

import numpy as np
import pytest

import bench
import karpenter_tpu.affinity as j_aff
import karpenter_tpu.apis.pod as j_pod
import karpenter_tpu.apis.requirements as j_req
import karpenter_tpu.gang.topology as j_topo
from karpenter_tpu.sharded.router import ShardRouter as JShardRouter
from karpenter_tpu.solver import encode as j_encode

import karpenter_tpu_torch.affinity as t_aff
import karpenter_tpu_torch.apis.pod as t_pod
import karpenter_tpu_torch.apis.requirements as t_req
import karpenter_tpu_torch.gang.topology as t_topo
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.sharded.router import ShardRouter, signature_key
from karpenter_tpu_torch.solver.encode import encode as t_encode

from tests.test_torch_affinity import _bench_windows
from tests.test_torch_affinity import catalogs as aff_catalogs  # noqa: F401
from tests.test_torch_gang import catalogs as gang_catalogs  # noqa: F401
from tests.test_torch_pref import build_pods, pref_specs
from tests.test_torch_pref import catalogs as pref_catalogs  # noqa: F401


@pytest.mark.parametrize("shape", [(2, 2), (2, 4)])
def test_slice_table_free_grid_and_fits_equal_reference(gang_catalogs,
                                                        shape):
    """``tests/test_gang.py``'s free-grid case on both packages, then
    random occupancies."""
    jcat, tcat = gang_catalogs
    jtab, ttab = j_topo.slice_table(jcat, shape), t_topo.slice_table(tcat,
                                                                     shape)
    O = tcat.num_offerings
    assert ttab.masks.shape[0] == O
    with_placements = ttab.count > 0
    assert with_placements.any()
    occ = np.zeros(O, dtype=np.uint64)
    assert (ttab.fits(occ) == with_placements).all()
    full = np.full(O, np.uint64(0xFFFFFFFFFFFFFFFF))
    assert not ttab.fits(full).any()
    rng = np.random.RandomState(sum(shape))
    for occ in (occ, full, rng.randint(0, 2 ** 62, size=O,
                                       dtype=np.int64).astype(np.uint64)):
        np.testing.assert_array_equal(ttab.free_grid(occ),
                                      jtab.free_grid(occ))
        np.testing.assert_array_equal(ttab.fits(occ), jtab.fits(occ))
    assert t_topo.slice_table(tcat, shape) is ttab


def test_clear_topology_cache_empties_all_three(gang_catalogs):
    jcat, tcat = gang_catalogs
    for topo, cat in ((j_topo, jcat), (t_topo, tcat)):
        table = topo.slice_table(cat, (2, 2))
        topo.rank_chips((4, 4), 0b110011)
        assert topo._PLACEMENT_CACHE and topo._TABLE_CACHE \
            and topo._RANK_CACHE
        topo.clear_topology_cache()
        assert not (topo._PLACEMENT_CACHE or topo._TABLE_CACHE
                    or topo._RANK_CACHE)
        assert topo.slice_table(cat, (2, 2)) is not table


def test_component_of_equals_reference():
    tpods = workload.affinity_bench_pods("aff", 300,
                                         np.random.RandomState(19))
    jpods = bench._affinity_bench_pods("aff", 300, np.random.RandomState(19))
    tr, jr = ShardRouter(4), JShardRouter(4)
    assert tr.bind_components(tpods) == jr.bind_components(jpods) > 0
    keys = sorted({signature_key(p) for p in tpods})
    assert keys == sorted({p.signature_key() for p in jpods})
    comps = [tr.component_of(k) for k in keys]
    assert comps == [jr.component_of(k) for k in keys]
    assert any(len(c) > 1 for c in comps)
    assert tr.component_of("no-such-key") == jr.component_of(
        "no-such-key") == ("no-such-key",)


def test_has_preferences_equals_reference(pref_catalogs):
    jcat, tcat = pref_catalogs[12]
    specs = pref_specs(40, 3, 4)
    plain = [(n, c, m, ()) for n, c, m, _ in specs]
    for sp in (specs, plain):
        jprob = j_encode(build_pods(sp, j_pod, j_req), jcat)
        tprob = t_encode(build_pods(sp, t_pod, t_req), tcat)
        assert tprob.has_preferences == jprob.has_preferences \
            == (sp is specs)


@pytest.mark.parametrize("seed", [0, 3])
def test_affinity_enabled_and_edge_matrices_equal_reference(aff_catalogs,
                                                            seed):
    _, _, jprob, tprob = _bench_windows(aff_catalogs, seed)
    assert t_aff.affinity_enabled(tprob) and j_aff.affinity_enabled(jprob)
    np.testing.assert_array_equal(tprob.aff.req_mat, jprob.aff.req_mat)
    np.testing.assert_array_equal(tprob.aff.anti_mat, jprob.aff.anti_mat)
    assert tprob.aff.req_mat.dtype == np.int32
    assert (tprob.aff.anti_mat == tprob.aff.anti_mat.T).all()
    assert tprob.aff.req_mat.sum() + tprob.aff.anti_mat.sum() > 0
    jcat, tcat = aff_catalogs
    plain = [t_pod.PodSpec(f"p{i}", requests=t_pod.ResourceRequests(
        500, 1024, 0, 1)) for i in range(4)]
    assert not t_aff.affinity_enabled(t_encode(plain, tcat))
