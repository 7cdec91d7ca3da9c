"""The reference's direction numbers are SciPy's, not the program's: its table
and its unscrambled points are held against ``scipy.stats.qmc.Sobol``, which
builds the Joe-Kuo directions from its own embedded initial numbers with its
own recursion. SciPy draws the points in Gray-code order: its point ``i`` is
the reference's natural-order point ``i ^ (i >> 1)``."""

from __future__ import annotations

import warnings

import numpy as np
import pytest
import torch

from portbench.reference import sobol

qmc = pytest.importorskip("scipy.stats.qmc")
DIMS = sobol.directions("cpu").shape[0]


def _scipy(n_points: int) -> np.ndarray:
    """SciPy's first ``n_points`` unscrambled points as 32-bit words, ``(n, DIMS)``."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # a point count that is not a power of two
        u = qmc.Sobol(d=DIMS, scramble=False, bits=32).random(n_points)
    return np.rint(u * 2.0 ** 32).astype(np.int64)


def _reference_words(idx: np.ndarray) -> np.ndarray:
    """The reference's unscrambled words at rows ``idx``, every dimension."""
    dirs = sobol.directions("cpu").numpy()
    acc = np.zeros((idx.shape[0], DIMS), dtype=np.int64)
    for k in range(int(idx.max()).bit_length()):
        acc ^= np.where(((idx >> k) & 1)[:, None].astype(bool), dirs[None, :, k], 0)
    return acc


def test_the_table_is_scipys_joe_kuo_table():
    engine = qmc.Sobol(d=DIMS, scramble=False, bits=32)
    table = getattr(engine, "_sv", None)
    if table is None:
        pytest.skip("this SciPy keeps its direction numbers under another name")
    assert np.array_equal(np.asarray(table, dtype=np.int64), sobol.directions("cpu").numpy())


@pytest.mark.parametrize("n_points", [1 << 12])
def test_unscrambled_points_are_scipys_in_gray_code_order(n_points):
    i = np.arange(n_points, dtype=np.int64)
    assert np.array_equal(_reference_words(i ^ (i >> 1)), _scipy(n_points))


def test_the_scramble_keeps_each_points_stratum():
    """Owen scrambling permutes within each dyadic interval: the first 2^m
    scrambled points of a dimension still fall one into each of 2^m bins."""
    m = 10
    idx = torch.arange(1 << m, dtype=torch.int64)
    u = sobol.Points(idx, torch.full_like(idx, 2 ** 31 + 11)).uniforms(range(0, DIMS, 97))
    bins = torch.floor(u.double() * (1 << m)).to(torch.int64)
    for col in bins.T:
        assert torch.equal(torch.sort(col)[0], torch.arange(1 << m))
