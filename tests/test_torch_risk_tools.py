"""Port parity: the rest of the risk and utility modules against the JAX
package, on the CPU: ``risk/analytics.discounted_payoff_compare`` and
``to_frames``, ``risk/plots.py``, ``calib/``, ``utils/flops.py``,
``utils/debug.py`` and ``utils/profiling.py``.

Tolerances and why:
- ``calib``: bitwise (the same host NumPy float64 code);
- ``to_frames``: the frames equal (the same pandas construction from the same
  report fields);
- ``discounted_payoff_compare``: float64 ``rtol=1e-12`` (means reduced in
  another order), float32 ``rtol=1e-6``;
- ``utils/flops``: the shared counting functions equal; ``gn_iteration_flops``
  within 0.5-2x of ``FlopCounterMode``'s count of one LM iteration of
  ``train/gn._GNProblem`` at 4,096 rows (the band of
  ``tests/test_flops.py::test_gn_fit_flops_vs_xla_cost_analysis``; measured
  1.03).
"""

import sys

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from torch.utils.flop_counter import FlopCounterMode  # noqa: E402

from orp_tpu import calib as jcalib  # noqa: E402
from orp_tpu.risk import analytics as janalytics  # noqa: E402
from orp_tpu.utils import flops as jflops  # noqa: E402
from orp_tpu_torch import calib  # noqa: E402
from orp_tpu_torch.risk import analytics, discounted_payoff_compare, plots, to_frames  # noqa: E402
from orp_tpu_torch.utils import flops, timed, trace  # noqa: E402
from orp_tpu_torch.utils.debug import checked, nan_debug  # noqa: E402


def _prices() -> np.ndarray:
    """``examples/stochastic_vol_calibration.py``'s synthetic series: 2,520
    closes of a random walk from ``default_rng(7)``."""
    rng = np.random.default_rng(7)
    return 100 * np.exp(np.cumsum(rng.normal(0.0003, 0.010, size=2520)))


def test_calib_equals_jax_bitwise():
    """Every function of ``calib/cir.py`` on the same series: bitwise."""
    p = _prices()
    r = calib.log_returns(p)
    assert np.array_equal(r, jcalib.log_returns(p))
    sig = calib.rolling_volatility(r, window=40)
    assert np.array_equal(sig, jcalib.rolling_volatility(r, window=40))
    assert calib.annualized_drift(p, 10.0) == jcalib.annualized_drift(p, 10.0)
    got, want = calib.estimate_cir_params(sig), jcalib.estimate_cir_params(sig)
    assert (got.a, got.b, got.c) == (want.a, want.b, want.c)
    fit, jfit = calib.calibrate_prices(p), jcalib.calibrate_prices(p)
    assert fit.as_dict() == jfit.as_dict()
    assert isinstance(fit.params, calib.CIRParams) and isinstance(fit, calib.CalibrationFit)


@pytest.mark.parametrize("call", [
    lambda m: m.CIRParams(a=0.001, b=0.01, c=0.5),
    lambda m: m.estimate_cir_params([0.1, 0.2]),
    lambda m: m.estimate_cir_params([0.1, -0.2, 0.3]),
    lambda m: m.estimate_cir_params(np.linspace(0.1, 0.5, 50) ** 2),
    lambda m: m.rolling_volatility(np.zeros(10), window=40),
    lambda m: m.calibrate_prices(np.ones((4, 50))),
    lambda m: m.calibrate_prices(np.ones(20)),
    lambda m: m.calibrate_prices(-np.ones(60)),
])
def test_calib_refusals_equal_jax(call):
    with pytest.raises(ValueError) as want:
        call(jcalib)
    with pytest.raises(ValueError) as got:
        call(calib)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("dtype, tol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
def test_discounted_payoff_compare_matches_jax(dtype, tol):
    rng = np.random.default_rng(3)
    values = rng.normal(10.0, 2.0, (512, 14))
    payoff = np.maximum(rng.normal(100.0, 15.0, 512) - 100.0, 0.0)
    times = np.linspace(0.0, 1.0, 14)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    want = janalytics.discounted_payoff_compare(jnp.asarray(values.astype(np_dt)),
                                                jnp.asarray(payoff.astype(np_dt)), 0.05,
                                                jnp.asarray(times.astype(np_dt)))
    got = discounted_payoff_compare(torch.tensor(values, dtype=dtype),
                                    torch.tensor(payoff, dtype=dtype), 0.05,
                                    torch.tensor(times, dtype=dtype))
    assert set(got) == set(want) == {"mean_value", "discounted_payoff"}
    for key in got:
        assert isinstance(got[key], np.ndarray) and got[key].dtype == want[key].dtype
        np.testing.assert_allclose(got[key], want[key], rtol=tol, atol=0.0, err_msg=key)
    # times as a host array beside ledgers on the (here CPU) device
    host = discounted_payoff_compare(torch.tensor(values, dtype=dtype),
                                     torch.tensor(payoff, dtype=dtype), 0.05, times)
    np.testing.assert_allclose(host["discounted_payoff"], want["discounted_payoff"], rtol=1e-6)


def _report_fields(with_times: bool) -> dict:
    rng = np.random.default_rng(11)
    n_dates, qs = 5, (0.01, 0.5, 0.99)
    fan = dict(qs=np.asarray(qs), bands=rng.normal(size=(n_dates + 1, 3)),
               mean=rng.normal(size=n_dates + 1))
    return dict(
        v0=10.4, phi0=0.6, psi0=0.4, discounted_payoff=10.39,
        var_by_date=rng.normal(size=(n_dates, 3)), var_overall=rng.normal(size=3),
        var_qs=(0.98, 0.99, 0.995), residual_stats={"mean": 0.0, "std": 1.0, "min": -3.0,
                                                    "max": 3.0},
        fan=fan, holdings={"phi_by_date": rng.normal(size=n_dates),
                           "psi_by_date": rng.normal(size=n_dates), "phi0": 0.6, "psi0": 0.4},
        train_loss=rng.random(n_dates), train_mae=rng.random(n_dates),
        train_mape=rng.random(n_dates), epochs_ran=rng.integers(1, 9, n_dates),
        times=np.linspace(0.0, 1.0, n_dates + 1) if with_times else None)


@pytest.mark.parametrize("with_times", [True, False])
def test_to_frames_equals_jax(with_times):
    """The four frames equal JAX's from the same report fields, with and
    without the knot times."""
    fields = _report_fields(with_times)
    fan = fields.pop("fan")
    want = janalytics.to_frames(janalytics.HedgeReport(fan=janalytics.FanChart(**fan), **fields))
    got = to_frames(analytics.HedgeReport(fan=analytics.FanChart(**fan), **fields))
    assert set(got) == set(want) == {"var", "holdings", "fan", "errors"}
    for key in got:
        pd.testing.assert_frame_equal(got[key], want[key])


def test_pandas_and_matplotlib_are_imported_lazily():
    """``import orp_tpu_torch.risk`` (and its plots module) loads neither
    pandas nor matplotlib: the card's machine has neither."""
    import subprocess

    code = ("import sys, orp_tpu_torch.risk, orp_tpu_torch.risk.plots, orp_tpu_torch.calib\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('pandas', 'matplotlib')]\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr


def test_all_charts_render():
    """Every chart under the Agg backend from a CPU-trained port report, the
    ledgers passed as tensors."""
    import matplotlib.pyplot as plt

    from orp_tpu_torch.api import EuropeanConfig, SimConfig, TrainConfig, european_hedge

    res = european_hedge(EuropeanConfig(), SimConfig(n_paths=512, T=1.0, dt=0.25,
                                                     rebalance_every=1),
                         TrainConfig(dual_mode="mse_only", optimizer="gauss_newton"),
                         device="cpu")
    r, bw = res.report, res.backward
    axes = [plots.fan_chart(r, res.times),
            plots.holdings_violins(bw.phi, bw.psi, res.times),
            plots.residual_scatter(bw.var_residuals[:, -1], torch.full((512,), 100.0)),
            plots.var_over_time(r, torch.tensor(res.times)),
            plots.training_error_curve(r, res.times)]
    for ax in axes:
        assert ax.figure is not None
        ax.figure.canvas.draw()
    plt.close("all")
    assert set(to_frames(r)) == {"var", "holdings", "fan", "errors"}


def test_flop_counts_equal_jax_and_the_model():
    """The counting functions equal JAX's; ``mlp_param_count`` is the port
    model's own count; ``phase_report`` has JAX's keys, against the card's
    peaks."""
    from orp_tpu_torch.models import HedgeMLP

    for f, h in ((1, 2), (3, 2), (5, 6)):
        assert flops.mlp_param_count(f, n_outputs=h) == jflops.mlp_param_count(f, n_outputs=h)
        assert flops.mlp_forward_flops(f, n_outputs=h) == jflops.mlp_forward_flops(f, n_outputs=h)
    assert flops.mlp_param_count(1) == HedgeMLP(n_features=1).n_params() == 106
    assert flops.mlp_param_count(3) == HedgeMLP(n_features=3).n_params()
    assert flops.gn_iteration_flops(4096, 106, 176) == jflops.gn_iteration_flops(4096, 106, 176)
    assert flops.gn_walk_flops(1 << 20, 52, 150, 75) == jflops.gn_walk_flops(1 << 20, 52, 150, 75)
    assert flops.adam_walk_flops(1 << 20, 52, 120, 30) == \
        jflops.adam_walk_flops(1 << 20, 52, 120, 30)
    assert flops.sim_flops(1 << 20, 364) == jflops.sim_flops(1 << 20, 364)
    total = flops.gn_walk_flops(1 << 20, 52, 150, 75)
    rep = flops.phase_report(total, 27.4)
    assert set(rep) == set(jflops.phase_report(1e12, 1.0))
    assert rep["mfu_bf16_peak"] == round(total / 27.4 / 989e12, 5)
    assert rep["mfu_f32_ceiling"] == round(total / 27.4 / 67e12, 5)
    assert flops.mfu(67e12, 1.0, flops.PEAK_F32_H100) == pytest.approx(1.0)


def test_gn_iteration_flops_vs_flop_counter():
    """One LM iteration of ``_GNProblem`` at 4,096 rows: the analytic count
    within 0.5-2x of ``FlopCounterMode``'s (the Gram dominates both)."""
    from orp_tpu_torch.models import HedgeMLP
    from orp_tpu_torch.train import gn

    n = 4096
    model = HedgeMLP(n_features=1)
    params = model.init(torch.Generator().manual_seed(0))
    feats = torch.linspace(0.5, 1.5, n)[:, None]
    prices = torch.stack([feats[:, 0], torch.ones(n)], dim=-1)
    targets = torch.clamp(feats[:, 0] - 1.0, min=0.0)
    problem = gn._GNProblem(model, feats, prices, targets, gn.GNConfig(n_iters=8))
    problem.start(model.flatten(params))
    with FlopCounterMode(display=False) as counter:
        problem.iterate()
    counted = counter.get_total_flops()
    model_flops = flops.gn_iteration_flops(n, flops.mlp_param_count(1), flops.mlp_forward_flops(1))
    ratio = model_flops / counted
    assert 0.5 < ratio < 2.0, (model_flops, counted, ratio)


def test_nan_debug_raises_naming_the_op():
    x = torch.tensor([1.0, -1.0])
    assert torch.isnan(torch.log(x)).any()  # outside the mode: no raise
    with nan_debug():
        torch.exp(x)  # clean ops pass
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(x)
        with pytest.raises(FloatingPointError, match=r"invalid value \(nan\)"):
            torch.zeros(2) / torch.zeros(2)
    torch.log(x)  # the mode is gone after the block


def test_checked_records_the_first_error_and_throws():
    def fn(x):
        y = torch.sqrt(x)       # NaN at -1
        return torch.log(y) + 1.0 / x

    err, out = checked(fn)(torch.tensor([4.0, -1.0]))
    assert out.shape == (2,) and torch.isnan(out[1])
    assert "nan generated by primitive: aten.sqrt" in err.get()
    with pytest.raises(FloatingPointError, match="aten.sqrt"):
        err.throw()
    err, _ = checked(lambda x: 1.0 / x)(torch.tensor([0.0, 2.0]))
    assert "inf generated by primitive: aten" in err.get()
    clean, out = checked(lambda x: x * 2.0)(torch.tensor([1.0, 2.0]))
    assert clean.get() is None and out.tolist() == [2.0, 4.0]
    clean.throw()  # nothing to raise


def test_timed_returns_the_result_and_trace_names_a_span():
    out, seconds = timed(lambda a, b: {"sum": a + b, "n": 3}, torch.ones(4), b=torch.ones(4))
    assert out["n"] == 3 and out["sum"].tolist() == [2.0] * 4 and seconds >= 0.0
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with trace("orp/simulate"):
            torch.ones(8) * 2.0
    assert any(e.key == "orp/simulate" for e in prof.key_averages())
