"""The port's sketches against exact neighbourhoods (the counterparts of
tests/test_sketch.py's sketch-vs-exact-set oracles, reference
test_hashing.py:101-177), on the CPU, on the reference test suite's
30-node BA graph (tests/conftest.py ``ba_graph``), for 1, 2 and 3 hops,
with the stacks built by the plan route and by the scatter route.

  * cardinalities within 4 of the exact closed k-hop neighbourhood sizes
    (HLL in its linear-counting regime on a small graph);
  * every subgraph feature within 4 of the exact (d_u, d_v) region count;
  * the two routes' stacks bit-equal to each other.
"""

import numpy as np
import pytest
import torch

from subgraph_sketching_tpu_torch.ops.segment_scan import SortedSegmentPlan
from subgraph_sketching_tpu_torch.sketch.elph import (
    build_hash_tables, subgraph_features,
)
from subgraph_sketching_tpu_torch.sketch.params import (
    LABEL_LOOKUP, SketchParams,
)
from test_sketch import exact_k_hop_sets

N = 30
ROUTES = ["plan", "scatter"]


def _build(ba_graph, params, route):
    plan = (SortedSegmentPlan(ba_graph, N, device="cpu") if route == "plan"
            else None)
    return build_hash_tables(ba_graph, N, params, plan=plan, device="cpu")


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("max_hops", [1, 2, 3])
def test_cards_match_exact_neighbourhoods(ba_graph, max_hops, route):
    params = SketchParams(max_hops=max_hops)
    sk = _build(ba_graph, params, route)
    exact = exact_k_hop_sets(ba_graph, N, max_hops)
    cards = sk.cards.numpy()
    for k in range(max_hops):
        true = np.array([len(s) for s in exact[k]], dtype=np.float32)
        np.testing.assert_allclose(cards[:, k], true, atol=4.0)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("max_hops", [1, 2, 3])
def test_subgraph_features_match_exact_counts(ba_graph, max_hops, route):
    """Every inclusion-exclusion feature approximates the exact disjoint
    (d_u, d_v) region count."""
    params = SketchParams(max_hops=max_hops, use_zero_one=True)
    sk = _build(ba_graph, params, route)
    exact = exact_k_hop_sets(ba_graph, N, max_hops)
    links = np.array([[0, 1], [3, 7], [10, 20], [5, 29]], dtype=np.int64)
    feats = subgraph_features(torch.from_numpy(links), sk, params).numpy()

    def exact_region(u, v, du, dv):
        # nodes at exactly hop du from u and exactly dv from v (0: outside
        # the max_hops neighbourhood)
        hood_u = [{u}] + [exact[h][u] for h in range(max_hops)]
        hood_v = [{v}] + [exact[h][v] for h in range(max_hops)]

        def at_exact(hoods, d):
            if d == 0:
                return set(range(N)) - hoods[max_hops]
            return hoods[d] - hoods[d - 1]
        return len(at_exact(hood_u, du) & at_exact(hood_v, dv))

    for li, (u, v) in enumerate(links):
        for col, (du, dv) in LABEL_LOOKUP[max_hops].items():
            true = exact_region(int(u), int(v), du, dv)
            assert abs(feats[li, col] - true) <= 4.0, (
                f"link ({u},{v}) feature ({du},{dv}): "
                f"got {feats[li, col]:.2f}, exact {true}")


@pytest.mark.parametrize("max_hops", [1, 2, 3])
def test_plan_and_scatter_routes_agree(ba_graph, max_hops):
    params = SketchParams(max_hops=max_hops)
    plan, scatter = (_build(ba_graph, params, r) for r in ROUTES)
    for a, b in zip(plan, scatter):
        assert torch.equal(a, b)
