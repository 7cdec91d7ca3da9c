"""Port parity: the walk's resilience plane (checkpoint/resume, the NaN sentinel
and its trainer ladder, ``orp_tpu_torch/utils/checkpoint.py``,
``utils/atomic.py``, ``guard/``) against the reference's chaos suite
(``tests/test_guard.py``) and against the JAX package.

Tolerances and why:
- kill-and-resume, the torn save and the clean guarded walk: bitwise (the
  resumed walk restores the saved bits and its fits draw from generators
  seeded by ``(seed, date, leg)`` alone; the guard's flag rides in the date's
  host read and changes no number);
- the guarded walk against JAX's under one ``FaultPlan``, in float64, from the
  same initial params: ``rtol=1e-7`` as the unguarded walks
  (``tests/test_torch_walk.py``); both packages poison the same rows, and the
  sanitized target's fill (the finite mean) differs by reduction order only;
- ``_final_solve_date`` in float64 on the same inputs: ``rtol=1e-9`` (one
  ridge solve of a 9-wide system, reduction order only); ``gram_cond`` in
  float64: ``rtol=1e-8`` (the port's closed-form Jacobian against JAX's
  autodiff, then an eigenvalue ratio of a well-conditioned Gram).
"""

import dataclasses
import os
import pathlib
import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from orp_tpu import guard as jguard
from orp_tpu.models.mlp import HedgeMLP as JHedgeMLP
from orp_tpu.train import backward as jbackward
from orp_tpu.train import losses as JL
from orp_tpu.train.gn import gram_cond as jgram_cond
from orp_tpu_torch import api as tapi
from orp_tpu_torch import guard
from orp_tpu_torch.guard import FaultInjector, FaultPlan, sentinel
from orp_tpu_torch.models import HedgeMLP
from orp_tpu_torch.train import BackwardConfig, backward_induction, gram_cond
from orp_tpu_torch.train import backward as tbackward
from orp_tpu_torch.utils import atomic, latest_step, load_checkpoint

BASE = dict(epochs_first=30, epochs_warm=15, dual_mode="mse_only", batch_size=512)


def _setup(n_paths: int = 512, n_steps: int = 4, dtype=np.float32):
    """GBM paths (numpy, seeded), the reference suite's shapes: features S/S0,
    prices S/S0 and B/S0, the call payoff / S0."""
    dt = 1.0 / n_steps
    z = np.random.default_rng(1).standard_normal((n_paths, n_steps))
    log_s = np.cumsum((0.08 - 0.02) * dt + 0.2 * np.sqrt(dt) * z, axis=1)
    s = np.concatenate([np.ones((n_paths, 1)), np.exp(log_s)], axis=1)
    b = np.exp(0.08 * np.linspace(0.0, 1.0, n_steps + 1))
    return tuple(a.astype(dtype) for a in (s[:, :, None], s, b, np.maximum(s[:, -1] - 1.0, 0.0)))


def _walk(args, *, initial_params=None, dtype=torch.float32, **cfg):
    model = HedgeMLP(n_features=1, constrain_self_financing=True, dtype=dtype)
    return backward_induction(model, *(torch.tensor(a) for a in args),
                              BackwardConfig(**{**BASE, **cfg}), initial_params=initial_params)


def _assert_same(a, b, params: bool = True):
    for name in ("values", "phi", "psi", "var_residuals"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    if params:
        for k in a.params1_by_date:
            assert torch.equal(a.params1_by_date[k], b.params1_by_date[k]), k
    np.testing.assert_array_equal(a.train_loss, b.train_loss)
    np.testing.assert_array_equal(a.epochs_ran, b.epochs_ran)


# -- kill-and-resume -----------------------------------------------------------


@pytest.mark.parametrize("kill_after", [0, 2])
def test_kill_and_resume_bitwise_equal(tmp_path, kill_after):
    args = _setup()
    full = _walk(args)
    ckdir = str(tmp_path / "walk")
    with guard.faults(FaultPlan(kill_after_step=kill_after)) as inj:
        with pytest.raises(guard.WalkKilled):
            _walk(args, checkpoint_dir=ckdir)
    assert inj.log == [("train/kill", f"step={kill_after}")]
    assert latest_step(ckdir) == kill_after
    _assert_same(full, _walk(args, checkpoint_dir=ckdir))


def test_finished_walk_resumes_without_fitting(tmp_path, monkeypatch):
    """A complete directory replays every date from disk: no fit runs, and the
    result equals the walk that wrote it."""
    args = _setup()
    ckdir = str(tmp_path / "done")
    full = _walk(args, checkpoint_dir=ckdir)
    monkeypatch.setattr(tbackward, "_date_body", lambda *a, **k: pytest.fail("fitted"))
    _assert_same(full, _walk(args, checkpoint_dir=ckdir))


def _step_file(ckdir: pathlib.Path, step: int) -> pathlib.Path:
    return ckdir / f"orp_step_{step}.npz"


def test_truncated_checkpoint_detected_and_refused(tmp_path):
    args = _setup()
    ckdir = tmp_path / "trunc"
    _walk(args, checkpoint_dir=str(ckdir))
    blob = _step_file(ckdir, 1)
    blob.write_bytes(blob.read_bytes()[: blob.stat().st_size // 2])
    with pytest.raises(ValueError, match="refusing to resume"):
        _walk(args, checkpoint_dir=str(ckdir))


def test_bitflipped_checkpoint_refused(tmp_path):
    args = _setup()
    ckdir = tmp_path / "rot"
    _walk(args, checkpoint_dir=str(ckdir))
    blob = _step_file(ckdir, 1)
    blob.write_bytes(FaultInjector(FaultPlan(seed=5)).corrupt_bytes(blob.read_bytes()))
    with pytest.raises(ValueError, match="refusing to resume"):
        _walk(args, checkpoint_dir=str(ckdir))


def test_rewritten_checkpoint_fails_its_digest(tmp_path):
    """A step that the storage layer reads happily (a valid file with other
    values) is caught by the integrity digest."""
    args = _setup()
    ckdir = tmp_path / "rewrite"
    _walk(args, checkpoint_dir=str(ckdir))
    blob = _step_file(ckdir, 1)
    with np.load(blob) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["v_col"] = arrays["v_col"] * np.float32(1.0001)
    with open(blob, "wb") as f:
        np.savez(f, **arrays)
    with pytest.raises(ValueError, match="failed its integrity check"):
        load_checkpoint(ckdir, 1)
    with pytest.raises(ValueError, match="refusing to resume"):
        _walk(args, checkpoint_dir=str(ckdir))


def test_missing_digest_refused(tmp_path):
    args = _setup()
    ckdir = tmp_path / "nodigest"
    _walk(args, checkpoint_dir=str(ckdir))
    (ckdir / "orp_digest_0.sha256").unlink()
    with pytest.raises(ValueError, match="integrity digest"):
        _walk(args, checkpoint_dir=str(ckdir))


def test_torn_save_recomputes_one_date_not_the_directory(tmp_path, recwarn):
    args = _setup()
    full = _walk(args)
    ckdir = tmp_path / "torn"
    _walk(args, checkpoint_dir=str(ckdir))
    (ckdir / "orp_digest_3.sha256").unlink()  # the torn-save on-disk state
    assert latest_step(ckdir) == 3
    resumed = _walk(args, checkpoint_dir=str(ckdir))
    assert any("recomputed on resume" in str(w.message) for w in recwarn.list)
    _assert_same(full, resumed)
    assert (ckdir / "orp_digest_3.sha256").exists()  # the recomputed date saved again


def test_fingerprint_mismatch_refused(tmp_path):
    """Another path count, or a warm start into a cold-started directory, is
    another run: the directory refuses it."""
    ckdir = str(tmp_path / "fp")
    _walk(_setup(), checkpoint_dir=ckdir)
    with pytest.raises(ValueError, match="different run config"):
        _walk(_setup(n_paths=256), checkpoint_dir=ckdir)
    model = HedgeMLP(n_features=1, constrain_self_financing=True)
    warm = {k: v.numpy() for k, v in model.init(torch.Generator().manual_seed(9)).items()}
    with pytest.raises(ValueError, match="different run config"):
        _walk(_setup(), checkpoint_dir=ckdir, initial_params=(warm, None))


def test_jax_written_checkpoint_dir_refused(tmp_path):
    """A directory the JAX package wrote (orbax steps, its own fingerprint) is
    refused by the port's fingerprint check with a clean ValueError."""
    args = _setup()
    ckdir = str(tmp_path / "jax")
    jbackward.backward_induction(
        JHedgeMLP(n_features=1, constrain_self_financing=True, dtype=jnp.float32),
        *(jnp.asarray(a) for a in args),
        jbackward.BackwardConfig(**{**BASE, "epochs_first": 2, "epochs_warm": 1},
                                 checkpoint_dir=ckdir))
    with pytest.raises(ValueError, match="different run config"):
        _walk(args, checkpoint_dir=ckdir)


@pytest.mark.parametrize("write, data", [(atomic.atomic_write_text, "guard"),
                                         (atomic.atomic_write_bytes, b"\x00guard")])
def test_atomic_write_leaves_no_temp_file(tmp_path, monkeypatch, write, data):
    target = tmp_path / "side" / "run_fingerprint.txt"
    write(target, data)
    before = target.read_bytes()

    def fail(fd):
        raise OSError("disk full")

    monkeypatch.setattr(os, "fsync", fail)
    with pytest.raises(OSError, match="disk full"):
        write(target, data * 2)
    assert sorted(p.name for p in target.parent.iterdir()) == ["run_fingerprint.txt"]
    assert target.read_bytes() == before


# -- the NaN sentinel and the trainer ladder -----------------------------------


@pytest.fixture
def guard_log(monkeypatch):
    """The sentinel's hooks, recorded (the warning is still raised)."""
    log = {"nan": [], "degrade": []}
    nan_event = sentinel.record_nan_event

    def on_nan(t, trainer, where):
        log["nan"].append((t, trainer))
        nan_event(t, trainer, where)

    monkeypatch.setattr(sentinel, "record_nan_event", on_nan)
    monkeypatch.setattr(sentinel, "record_degrade", lambda t, to: log["degrade"].append((t, to)))
    return log


def test_nan_injection_degrades_only_that_date(recwarn, guard_log):
    args = _setup()
    clean = _walk(args)
    with guard.faults(FaultPlan(seed=3, nan_dates=frozenset({1}), nan_frac=0.02)) as inj:
        res = _walk(args, nan_guard=True)
    assert any("guard: non-finite" in str(w.message) for w in recwarn.list)
    assert [site for site, _ in inj.log] == ["train/fit_target"]
    # step 1 of a 4-date walk is date t=2; no other date saw an event
    assert guard_log["nan"] == [(2, "adam")]
    assert guard_log["degrade"] == [(2, "gauss_newton")]
    assert torch.isfinite(res.values).all() and torch.isfinite(res.phi).all()
    assert torch.equal(clean.values[:, 3], res.values[:, 3])
    assert torch.equal(clean.phi[:, 3], res.phi[:, 3])
    v_clean, v_got = float(clean.v0.mean()), float(res.v0.mean())
    assert abs(v_got - v_clean) <= 0.05 * abs(v_clean)


def test_nan_guard_clean_path_bitwise_and_silent(guard_log):
    args = _setup(n_steps=3)
    off = _walk(args)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        on = _walk(args, nan_guard=True)
    assert guard_log == {"nan": [], "degrade": []}
    _assert_same(off, on)


def test_nan_guard_budget_exhausted_raises(recwarn):
    args = _setup(n_steps=3)
    with guard.faults(FaultPlan(seed=3, nan_dates=frozenset({0}), nan_frac=0.02)):
        with pytest.raises(RuntimeError, match="still non-finite"):
            _walk(args, nan_guard=True, nan_retries=0)


@pytest.mark.parametrize("trainer", ["adam", "gauss_newton", "final_solve", "sgd"])
@pytest.mark.parametrize("budget", [-1, 0, 1, 2, 3])
def test_degradation_ladder_equals_reference(trainer, budget):
    if trainer == "sgd":
        for ladder in (guard.degradation_ladder, jguard.degradation_ladder):
            with pytest.raises(ValueError, match="unknown trainer"):
                ladder(trainer, budget)
        return
    assert guard.degradation_ladder(trainer, budget) == jguard.degradation_ladder(trainer, budget)
    assert guard.TRAINER_LADDER == jguard.TRAINER_LADDER


@pytest.mark.parametrize("values", [[1.0, np.nan, 3.0, np.inf], [1.0, 2.0],
                                    [np.nan, -np.inf], [0.5, -np.inf, 2.25, 4.0, np.nan]])
def test_sanitize_target_equals_reference(values):
    got, n_bad = guard.sanitize_target(torch.tensor(values, dtype=torch.float64))
    want, j_bad = jguard.sanitize_target(jnp.asarray(values, jnp.float64))
    assert n_bad == j_bad
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)
    if n_bad == 0:
        assert got.shape == (len(values),)


def test_fault_injector_poisons_the_reference_rows():
    plan = dict(seed=3, nan_dates=frozenset({1}), nan_frac=0.02)
    target = np.linspace(0.0, 1.0, 512)
    got = FaultInjector(FaultPlan(**plan)).corrupt_target(1, torch.tensor(target))
    want = jguard.FaultInjector(jguard.FaultPlan(**plan)).corrupt_target(1, jnp.asarray(target))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
    assert int(torch.isnan(got).sum()) == 10
    inj = FaultInjector(FaultPlan(**plan))
    assert inj.corrupt_target(0, torch.tensor(target)) is not None and inj.log == []
    with guard.faults(FaultPlan()):
        with pytest.raises(RuntimeError, match="do not nest"):
            with guard.faults(FaultPlan()):
                pass
    assert guard.active() is None


# -- the guarded walk against the JAX package's ---------------------------------


def _jax_init(n_features: int, dtype, bias) -> tuple[dict, dict]:
    ks = jax.random.split(jax.random.key(1234), 3)
    m = JHedgeMLP(n_features=n_features, dtype=dtype)
    return tuple({k: np.asarray(v) for k, v in m.init(ks[i], bias_init=bias).items()}
                 for i in (0, 1))


@pytest.mark.parametrize("cfg, rungs", [
    (dict(optimizer="gauss_newton", gn_iters_first=12, gn_iters_warm=6), ["final_solve"]),
    (dict(epochs_first=12, epochs_warm=6, batch_size=128, shuffle=False), ["gauss_newton"]),
])
def test_guarded_walk_matches_jax_in_f64(cfg, rungs, guard_log, recwarn):
    """The same ``FaultPlan`` poisons the same rows in both packages; the
    ladder lands on the same rung and the walks agree."""
    args = _setup(n_paths=256, dtype=np.float64)
    init = _jax_init(1, jnp.float64, (0.1, 0.0))
    full = dict(BASE, **cfg, dual_mode="separate", nan_guard=True)
    plan = dict(seed=3, nan_dates=frozenset({1}), nan_frac=0.02)
    with jguard.faults(jguard.FaultPlan(**plan)):
        want = jbackward.backward_induction(
            JHedgeMLP(n_features=1, dtype=jnp.float64), *(jnp.asarray(a) for a in args),
            jbackward.BackwardConfig(**full), initial_params=init)
    with guard.faults(FaultPlan(**plan)):
        got = backward_induction(HedgeMLP(n_features=1, dtype=torch.float64),
                                 *(torch.tensor(a) for a in args), BackwardConfig(**full),
                                 initial_params=init)
    assert guard_log["degrade"] == [(2, r) for r in rungs]
    for k in ("values", "phi", "psi", "var_residuals"):
        np.testing.assert_allclose(getattr(got, k).numpy(), np.asarray(getattr(want, k)),
                                   rtol=1e-7, atol=1e-10, err_msg=k)
    for which in ("params1_by_date", "params2_by_date"):
        for k, v in getattr(want, which).items():
            np.testing.assert_allclose(getattr(got, which)[k].numpy(), np.asarray(v),
                                       rtol=1e-7, atol=1e-9, err_msg=f"{which} {k}")
    np.testing.assert_allclose(got.train_loss, want.train_loss, rtol=1e-7)
    np.testing.assert_array_equal(got.epochs_ran, want.epochs_ran)


def test_final_solve_date_matches_jax_in_f64():
    args = _setup(n_paths=256, dtype=np.float64)
    feats, s, b, term = args
    init = _jax_init(1, jnp.float64, (0.1, 0.0))[0]
    t = 2
    prices = np.stack([s, np.broadcast_to(b, s.shape)], -1)
    target = term * 0.9
    want = jbackward._final_solve_date(
        JHedgeMLP(n_features=1, dtype=jnp.float64), jbackward.BackwardConfig(**BASE),
        {k: jnp.asarray(v) for k, v in init.items()}, jnp.asarray(feats[:, t]),
        jnp.asarray(prices[:, t]), jnp.asarray(prices[:, t + 1]), jnp.asarray(target),
        JL.make_loss("mse"), jbackward._date_outputs)
    got = tbackward._final_solve_date(
        HedgeMLP(n_features=1, dtype=torch.float64), BackwardConfig(**BASE),
        {k: torch.tensor(v) for k, v in init.items()}, torch.tensor(feats[:, t]),
        torch.tensor(prices[:, t]), torch.tensor(prices[:, t + 1]),
        torch.tensor(target))
    for k, v in want[0].items():
        np.testing.assert_allclose(got[0][k].numpy(), np.asarray(v), rtol=1e-9, err_msg=k)
    assert got[1] is got[0]
    for i in (2, 3, 4):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]), rtol=1e-9, atol=1e-12)
    for k in ("final_loss", "mae", "mape"):
        np.testing.assert_allclose(float(got[5][k]), float(want[5][k]), rtol=1e-9, err_msg=k)
    assert int(got[5]["n_epochs_ran"]) == want[5]["n_epochs_ran"] == 0


@pytest.mark.parametrize("n_features", [1, 3])
def test_gram_cond_matches_jax_in_f64(n_features):
    rng = np.random.default_rng(7)
    n = 3000  # past max_rows=2048: both read the first 2048 rows
    feats = rng.lognormal(0.0, 0.2, (n, n_features))
    prices = np.stack([feats[:, 0], np.full(n, 1.05)], -1)
    params = {k: np.asarray(v) for k, v in JHedgeMLP(n_features=n_features, dtype=jnp.float64)
              .init(jax.random.key(3), bias_init=(0.5, 0.5)).items()}
    want = jgram_cond(JHedgeMLP(n_features=n_features, dtype=jnp.float64),
                      {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(feats),
                      jnp.asarray(prices))
    got = gram_cond(HedgeMLP(n_features=n_features, dtype=torch.float64),
                    {k: torch.tensor(v) for k, v in params.items()}, torch.tensor(feats),
                    torch.tensor(prices))
    assert np.isfinite(got) and got > 1.0
    np.testing.assert_allclose(got, want, rtol=1e-8)


# -- the configs refuse the fused walk with the host loop's plane ----------------


@pytest.mark.parametrize("extra, match", [(dict(checkpoint_dir="ckpt"), "checkpointing"),
                                          (dict(nan_guard=True), "NaN sentinel")])
@pytest.mark.parametrize("config", [BackwardConfig, tapi.TrainConfig])
def test_configs_refuse_fused_with_the_host_loop_plane(config, extra, match):
    with pytest.raises(ValueError, match=match):
        config(fused=True, **extra)
    assert config(**extra).nan_retries == 2  # each alone is accepted
    assert dataclasses.replace(config(), fused=True).fused
