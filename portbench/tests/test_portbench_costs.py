"""The cost model at small shapes against hand counts of its formulas."""

from __future__ import annotations

import pytest

from portbench.costs.as241_ops import AS241_OPS
from portbench.costs.bound import bound
from portbench.costs.gn_walk_flops import gn_iteration_flops, gn_walk_flops, irls_iteration_flops
from portbench.costs.k1_bound_ms import k1_bound_ms, k1_work
from portbench.costs.k3c_bound_ms import k3c_bound_ms, k3c_work
from portbench.costs.mlp_flops import mlp_forward_flops, mlp_param_count
from portbench.costs.peaks import F32_FLOP_PER_S, HBM_BYTES_PER_S, INT32_OP_PER_S
from portbench.costs.replay_flops import replay_flops
from portbench.costs.sobol_int_ops import sobol_int_ops


def test_sobol_int_ops_by_hand():
    # 64 paths: warps 0 and 1 (popcounts 0, 1), each + 12; 13 a path; 2 dims
    assert sobol_int_ops(64, 2) == 2 * ((0 + 12) + (1 + 12) + 13 * 64)
    assert sobol_int_ops(1, 1) == 12 + 13


def test_as241_and_bound():
    assert AS241_OPS == pytest.approx(33.6)
    assert bound(HBM_BYTES_PER_S, 0, 0) == (pytest.approx(1000.0), "bytes")
    assert bound(0, INT32_OP_PER_S, 0.5 * F32_FLOP_PER_S) == (pytest.approx(1000.0),
                                                               "operations")


def test_k1_work_by_hand():
    b, i, f = k1_work(32, 4, 2)
    assert b == 4 * 32 * 4 + 3 * 32 * 4
    assert i == sobol_int_ops(32, 4)
    assert f == pytest.approx(32 * (4 * (6 + 33.6) + 2 * 2))
    assert k1_bound_ms(32, 4, 2)[0] == pytest.approx(bound(b, i, f)[0])


@pytest.mark.parametrize("inversion, trips", [(True, 10.0), (False, 0.0)])
def test_k3c_work_by_hand(inversion, trips):
    b, i, f = k3c_work(32, 4, 2, False, inversion, trips)
    assert b == 4 * 4 * 32 * 4 + 3 * 3 * 32 * 4
    assert i == sobol_int_ops(32, 12)
    step = (2 if inversion else 3) * 33.6 + 3 + 7 + 11
    assert f == pytest.approx(32 * 4 * step + trips * 7)
    assert k3c_bound_ms(32, 4, 2, False, inversion, trips)[0] == pytest.approx(bound(b, i, f)[0])


def test_the_card_bounds_of_the_kernel_table():
    # PERF.md's kernel table: K1 0.311 ms at 1M x 364; K3c 2.564 ms at 1M x 1,000
    assert k1_bound_ms(1 << 20, 364, 7) == (pytest.approx(0.311, abs=5e-4), "operations")
    assert k3c_bound_ms(1 << 20, 1000, 25, False, True, 1385 * (1 << 20))[0] == pytest.approx(
        2.564, abs=5e-3)


def test_mlp_and_gn_flops_by_hand():
    assert mlp_param_count(1) == 16 + 72 + 18 == 106
    assert mlp_param_count(3) == 32 + 72 + 18 == 122
    assert mlp_forward_flops(1) == 2 * (8 + 64 + 16)
    n, p, fwd = 10, 106, 176
    it = 2 * n * p * p + 2 * n * p + n * 5 * fwd + (2 * p ** 3) // 3
    assert gn_iteration_flops(n, p, fwd) == it
    assert irls_iteration_flops(n, p, fwd) == it + n * p + 4 * n
    assert gn_walk_flops(n, 3, 5, 2, 1, False) == (5 + 2 * 2) * it
    assert gn_walk_flops(n, 3, 5, 2, 1, True) == (5 + 2 * 2) * (2 * it + n * p + 4 * n)
    assert replay_flops(4, 3, 1) == 4 * 3 * (176 + 12)
