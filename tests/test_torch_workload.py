"""``karpenter_tpu_torch.workload`` and the port's ``encode`` against the
reference's headline data path.

The port builds the headline window (catalog + pending pods) from a
seed without the reference package; for the same seed it must produce
the reference ``bench.build_workload``'s ``CatalogArrays`` field by field
and the same pods, and the port's encoder must produce the reference's
``EncodedProblem`` field by field — at a small size and once at the
headline 10k pods x 500 types.
"""

import numpy as np
import pytest

import bench
from karpenter_tpu.solver import encode as j_encode
from karpenter_tpu_torch import workload
from karpenter_tpu_torch.carry import CATALOG_FIELDS
from karpenter_tpu_torch.solver import encode as t_encode


def _pod_view(p):
    return (p.name, p.namespace, p.requests.as_tuple(), p.node_selector,
            tuple(r.signature for r in p.required_requirements),
            tuple((t.key, t.operator, t.value, t.effect)
                  for t in p.tolerations),
            tuple((c.max_skew, c.topology_key, c.when_unsatisfiable,
                   c.label_selector) for c in p.topology_spread),
            p.priority)


def assert_catalogs_equal(jc, tc):
    for f in CATALOG_FIELDS + ("type_torus",):
        a, b = getattr(jc, f), getattr(tc, f)
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert list(a) == list(b), f
    np.testing.assert_array_equal(jc.offering_alloc(), tc.offering_alloc())
    np.testing.assert_array_equal(jc.offering_rank_price(),
                                  tc.offering_rank_price())


def assert_problems_equal(jp, tp):
    for f in ("group_req", "group_count", "group_cap", "group_prio",
              "group_gang", "group_min", "label_rows", "label_idx"):
        a, b = getattr(jp, f), getattr(tp, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(jp.compat, tp.compat)
    assert [g.pod_names for g in jp.groups] == \
        [g.pod_names for g in tp.groups]
    assert [(g.pinned_zone, g.cap_per_node, g.spread_origin is None)
            for g in jp.groups] == \
        [(g.pinned_zone, g.cap_per_node, g.spread_origin is None)
         for g in tp.groups]
    assert jp.rejected == tp.rejected
    assert jp.rejected_reasons == tp.rejected_reasons
    assert (jp.pref_rows is None) == (tp.pref_rows is None)
    assert (jp.aff is None) == (tp.aff is None)
    assert (jp.group_var is None) == (tp.group_var is None)


@pytest.mark.parametrize("num_types,seed", [(20, 7), (60, 3)])
def test_small_workload_matches_reference(num_types, seed):
    jpods, jcat = bench.build_workload(400, num_types, seed=seed)
    tpods, tcat = workload.build_workload(400, num_types, seed=seed)
    assert_catalogs_equal(jcat, tcat)
    assert [_pod_view(p) for p in jpods] == [_pod_view(p) for p in tpods]
    assert_problems_equal(j_encode(jpods, jcat), t_encode(tpods, tcat))


def test_profile_ladder_and_prices_match_reference():
    from karpenter_tpu.cloud.fake import generate_profiles, profile_price

    for count in (5, 30, 500):
        jp, tp = generate_profiles(count), workload.generate_profiles(count)
        assert [(p.name, p.cpu, p.memory_gib, p.gpu, p.supports_spot)
                for p in jp] == [(p.name, p.cpu, p.memory_gib, p.gpu,
                                  p.supports_spot) for p in tp]
        assert [profile_price(p) for p in jp] == \
            [workload.profile_price(p) for p in tp]


def test_headline_window_matches_reference():
    """10k pods x 500 types, seed 42: the window chip_smoke.py solves."""
    jpods, jcat = bench.build_workload(10_000, 500, seed=42)
    tpods, tcat = workload.build_workload(10_000, 500, seed=42)
    assert_catalogs_equal(jcat, tcat)
    assert tcat.num_offerings == 3000
    jp, tp = j_encode(jpods, jcat), t_encode(tpods, tcat)
    assert_problems_equal(jp, tp)
    assert tp.num_groups == 54
