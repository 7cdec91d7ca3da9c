"""``tools/torch_heston_greeks.py`` on the CPU at a tiny size: each run line
reports ``risk.heston_greeks`` at its arguments and its gaps to the oracle of
``chip_smoke.heston_greeks_oracle``; the split line's gap is the difference of
the float32 and float64 ``vega_xi`` means, and its two parts add up to it."""

import io
import json
import pathlib
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread_and_one_quadrature():
    """One intra-op thread for this module (512-path runs; under the suite's
    parallel workers every worker's default pool oversubscribes the machine),
    and the oracle's 2,048-node Gauss-Legendre rule computed once rather than
    once a characteristic-function price (13 prices an oracle; the same nodes
    and weights, so the same oracle)."""
    rule = np.polynomial.legendre.leggauss(2048)
    leggauss = np.polynomial.legendre.leggauss

    def cached(n):
        return tuple(a.copy() for a in rule) if n == 2048 else leggauss(n)

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(np.polynomial.legendre, "leggauss", cached)
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def lines():
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(ROOT / "tools"))
        mp.syspath_prepend(str(ROOT))
        import torch_heston_greeks as tool

        buf = io.StringIO()
        with redirect_stdout(buf):
            assert tool.main(["--device", "cpu", "--paths", "512", "--runs", "float64:77:8",
                              "float32:77:8", "--split", "float32:77:8"]) == 0
    return buf.getvalue().splitlines()


def test_runs_report_the_entry_point_and_its_gaps(lines):
    """Each run line: ``heston_greeks``' means and standard errors at its
    arguments (rtol 1e-12: the same call), each gap the estimate over the
    oracle less one (``rtol`` bands) or their difference (``atol`` bands)."""
    import chip_smoke
    from orp_tpu_torch.risk import heston_greeks

    oracle = chip_smoke.heston_greeks_oracle()
    assert lines[-1] == "cpu"
    for line, dtype in zip(lines[:2], (torch.float64, torch.float32)):
        run = json.loads(line)
        assert (run["dtype"], run["seed"], run["steps"], run["paths"]) == (
            str(dtype).removeprefix("torch."), 77, 8, 512)
        want = heston_greeks(512, 100.0, 100.0, 0.08, 1.0, **chip_smoke.HESTON_GREEKS,
                             n_steps=8, seed=77, dtype=dtype, device="cpu")
        assert set(run["greeks"]) == set(oracle)
        for name, g in run["greeks"].items():
            ref, how, lim = oracle[name]
            assert g["got"] == pytest.approx(want[name], rel=1e-12)
            assert g["se"] == pytest.approx(want["se"][name], rel=1e-12)
            gap = g["got"] - ref if how == "atol" else g["got"] / ref - 1
            assert g[how] == pytest.approx(gap, rel=1e-12) and g["band"] == lim
            assert g["inside"] == (abs(gap) <= lim)


def test_split_adds_up(lines):
    """The split's ``vega_xi`` means are the two runs' (rtol 1e-6: the per-path
    tangents summed in float64 there, in the run's dtype here), its gap their
    difference, and the floored and never-floored parts sum to the gap."""
    f64, f32, split = (json.loads(line) for line in lines[:3])
    assert split["vega_xi"] == pytest.approx(f32["greeks"]["vega_xi"]["got"], rel=1e-6)
    assert split["vega_xi_f64"] == pytest.approx(f64["greeks"]["vega_xi"]["got"], rel=1e-12)
    assert split["gap"] == pytest.approx(split["vega_xi"] - split["vega_xi_f64"], abs=1e-12)
    assert split["gap_from_floored"] + split["gap_from_never_floored"] == pytest.approx(
        split["gap"], abs=1e-12)
    assert 0.0 <= split["floored_share"] <= 1.0 and split["floored_differ"] >= 0
