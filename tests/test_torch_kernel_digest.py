"""``tools/torch_kernel_digest.py`` on the CPU, where every wrapper runs its
plain version: the runs name every kernel of the port (K1 stored every 7
steps and every step, K3a, K3b, K3c in its four variants, K2 in f32 and
bf16), and a digest is deterministic and moves when one element moves. A
stub of ``chip_smoke.py``'s constants keeps the shapes tiny."""

import importlib.util
import pathlib
import types

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent

SMOKE = types.SimpleNamespace(
    N_FULL=64, N_STEPS=14, STORE=7, OOS_SEED=4321, PENSION_STEPS=8, PENSION_STORE=4,
    HESTON=dict(s0=100.0, mu=0.08, v0=0.0225, kappa=1.5, theta=0.0225, xi=0.25, rho=-0.6),
    PENSION=dict(y0=1.0, mu=0.08, sigma=0.15, l0=0.01, mort_c=0.075, eta=0.000597,
                 n0=10000.0),
    PENSION_SV=dict(y0=1.0, mu=0.08, sigma=None, l0=0.01, mort_c=0.075, eta=0.000597,
                    n0=10000.0, sv=True, v0=0.15, cir_a=0.00336, cir_b=0.15431,
                    cir_c=0.01583))

KERNEL_RUNS = ["fused_gbm", "fused_gbm_dense", "heston_euler", "heston_qe",
               "pension_const_inversion", "pension_const_normal", "pension_sv_inversion",
               "pension_sv_normal", "mixed_head_f32", "mixed_head_bf16",
               "mixed_head_f32_4096", "mixed_head_bf16_4096", "mixed_head_f32_pension",
               "mixed_head_bf16_pension"]


def _tool():
    spec = importlib.util.spec_from_file_location("_kernel_digest",
                                                  ROOT / "tools" / "torch_kernel_digest.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tool():
    return _tool()


@pytest.fixture(scope="module")
def calls(tool):
    return tool.runs(SMOKE, "cpu")


def test_runs_name_every_kernel(calls):
    assert sorted(calls) == sorted(KERNEL_RUNS)


@pytest.mark.parametrize("name", KERNEL_RUNS)
def test_digest_is_deterministic_and_moves_with_one_element(tool, calls, name):
    outs = calls[name]()
    whole, each = tool.digest(outs)
    assert len(whole) == 64 and sorted(each) == sorted(outs)
    assert tool.digest(calls[name]()) == (whole, each)
    key = sorted(outs)[0]
    moved = dict(outs)
    flat = outs[key].clone().reshape(-1)
    flat[flat.numel() // 2] = torch.nextafter(flat[flat.numel() // 2].float(),
                                              torch.tensor(float("inf"))).to(flat.dtype)
    if torch.equal(flat, outs[key].reshape(-1)):  # a bf16 step below one spacing
        flat[flat.numel() // 2] = -flat[flat.numel() // 2] - 1
    moved[key] = flat.reshape(outs[key].shape)
    whole2, each2 = tool.digest(moved)
    assert whole2 != whole and each2[key] != each[key]
    assert all(each2[k] == each[k] for k in outs if k != key)


def test_k1_runs_are_the_smoke_shapes_and_seed(calls):
    from orp_tpu_torch.qmc import fused_gbm

    sparse, dense = calls["fused_gbm"]()["S"], calls["fused_gbm_dense"]()["S"]
    assert sparse.shape == (SMOKE.N_FULL, SMOKE.N_STEPS // SMOKE.STORE + 1)
    assert dense.shape == (SMOKE.N_FULL, SMOKE.N_STEPS + 1)
    # the same steps, stored every step or every STORE steps: the same knots
    assert torch.equal(dense[:, ::SMOKE.STORE], sparse)
    want = fused_gbm.gbm_log_plain(SMOKE.N_FULL, SMOKE.N_STEPS, s0=100.0, drift=0.08,
                                   sigma=0.15, dt=1.0 / SMOKE.N_STEPS, seed=SMOKE.OOS_SEED,
                                   store_every=SMOKE.STORE)
    assert torch.equal(sparse, want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_k2_runs_are_the_smoke_rows_and_the_pension_shape(calls, dtype):
    """The 4,096-row run is the head of the north-star run's rows; the pension
    run is 3 features, 40 dates, 2 finite outputs a row."""
    full = calls[f"mixed_head_{dtype}"]()["out"]
    small = calls[f"mixed_head_{dtype}_4096"]()["out"]
    pension = calls[f"mixed_head_{dtype}_pension"]()["out"]
    assert full.shape == (SMOKE.N_FULL, 2) and small.shape == (min(SMOKE.N_FULL, 4096), 2)
    assert torch.equal(small, full[:4096])
    assert pension.shape == (SMOKE.N_FULL, 2) and bool(torch.isfinite(pension).all())
