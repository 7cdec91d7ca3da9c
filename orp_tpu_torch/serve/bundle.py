"""Framework-neutral hedge-policy bundles (counterpart of ``orp_tpu/serve/bundle.py``).

Layout::

    <dir>/bundle.json   model architecture + combine semantics + metadata
                        (the fields of the JAX package's orp-bundle-v2)
    <dir>/policy.npz    stacked per-date params ``params1/w0`` ... (and
                        ``params2/...`` for dual policies) + per-date fit metrics

numpy arrays, not a framework's checkpoint, carry the weights, so a policy
trained by the JAX package is served here unchanged: :func:`policy_from_numpy`
builds the port's policy from the JAX package's ``params1_by_date`` as numpy
arrays. Loading verifies the params' shapes against the recorded model.

:func:`export_bundle` writes a trained ``PipelineResult`` as a bundle with its
``run_fingerprint.txt`` (``utils/fingerprint.policy_fingerprint``, refused on
a mismatched re-export and verified by :func:`load_bundle` where present) and
``bundle.json``'s ``baseline``: the training-feature sketch, the pinned
validation set and the training hedge-error level (``obs/quality.py``), as the
JAX package's export writes them. The committed bundles carry neither file nor
baseline and load as before, their baseline fields ``None``.

``export_bundle(..., store=, tenant=)`` also publishes the export into a
content-addressed store (``store/catalog.py``), and :func:`load_bundle` takes a
``store://<root>#<tenant>[@version]`` URI, as the JAX package's do. The store
only hashes and copies files, so it holds the port's ``.npz`` bundles and the
JAX package's orbax ones alike.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np
import torch

from orp_tpu_torch.models.mlp import HedgeMLP
from orp_tpu_torch.train.backward import BackwardResult
from orp_tpu_torch.utils.atomic import atomic_write_text
from orp_tpu_torch.utils.fingerprint import (policy_fingerprint, read_fingerprint,
                                             verify_fingerprint, verify_policy_compat,
                                             write_fingerprint)

FORMAT = "orp-bundle-npz-v1"
META = "bundle.json"
POLICY = "policy.npz"
METRICS = ("train_loss", "train_mae", "train_mape", "epochs_ran")
_DTYPES = {"float32": torch.float32, "float64": torch.float64, "bfloat16": torch.bfloat16}  # orp: noqa[ORP001] -- serialization table must name every loadable dtype


@dataclasses.dataclass
class PolicyBundle:
    """A deployable hedge policy: what ``european_oos`` and ``HedgeEngine`` read."""

    model: HedgeMLP
    backward: BackwardResult   # params-only; per-date params as CPU tensors
    times: np.ndarray          # rebalance-knot times (n_dates+1,)
    adjustment_factor: float
    dual_mode: str
    holdings_combine: str
    cost_of_capital: float
    sim_seed: int | None       # training path seed; european_oos refuses it
    # what export_bundle records (None on a bundle written without it):
    fingerprint: str | None = None
    feature_sketch: object | None = None       # obs.quality.FeatureSketch
    validation: object | None = None           # obs.quality.ValidationSpec
    hedge_error_baseline: float | None = None  # normalised units
    # the bundle dir when it ships an AOT set (<dir>/aot/aot.json, aot/bundle_exec.py);
    # HedgeEngine installs its libraries and captures its bucket graphs at construction
    aot_dir: pathlib.Path | None = None

    @property
    def n_dates(self) -> int:
        return len(self.times) - 1


def model_meta(model: HedgeMLP) -> dict:
    names = {v: k for k, v in _DTYPES.items()}
    return {"n_features": model.n_features, "hidden": list(model.hidden),
            "negative_slope": model.negative_slope,
            "constrain_self_financing": model.constrain_self_financing,
            "init_scale": model.init_scale, "dtype": names[model.dtype],
            "n_hedge_assets": model.n_hedge_assets}


def model_from_meta(meta: dict) -> HedgeMLP:
    if meta["dtype"] not in _DTYPES:
        raise ValueError(f"bundle records unsupported model dtype {meta['dtype']!r} "
                         f"(known: {sorted(_DTYPES)})")
    return HedgeMLP(
        n_features=int(meta["n_features"]),
        hidden=tuple(int(h) for h in meta["hidden"]),
        negative_slope=float(meta["negative_slope"]),
        constrain_self_financing=bool(meta["constrain_self_financing"]),
        init_scale=float(meta["init_scale"]),
        dtype=_DTYPES[meta["dtype"]],
        n_hedge_assets=int(meta["n_hedge_assets"]))


def policy_from_numpy(meta: dict, params1: dict, params2: dict | None = None) -> PolicyBundle:
    """The port's policy from per-date params given as numpy arrays.

    ``meta`` holds the ``bundle.json`` fields (``model``, ``times``,
    ``adjustment_factor``, ``dual_mode``, ``holdings_combine``,
    ``cost_of_capital``, ``sim_seed``) and optionally the per-date fit
    metrics; ``params1``/``params2`` map ``w{i}``/``b{i}`` to ``(D, ...)``."""
    model = model_from_meta(meta["model"])
    times = np.asarray(meta["times"], np.float64)
    n_dates = len(times) - 1

    def to_t(p):
        return None if p is None else {
            k: torch.as_tensor(np.array(v, dtype=np.float32)).to(model.dtype)
            for k, v in p.items()}

    p1, p2 = to_t(params1), to_t(params2)
    verify_policy_compat("policy_from_numpy", model, n_dates, p1)
    if p2 is not None:
        verify_policy_compat("policy_from_numpy (params2)", model, n_dates, p2)
    # per-date fit metrics are optional: unknown losses are NaN, epochs 0
    state = {k: np.asarray(meta[k]) if k in meta else
             np.zeros(n_dates, np.int64) if k == "epochs_ran" else np.full(n_dates, np.nan)
             for k in METRICS}
    state["params1_by_date"] = p1
    if p2 is not None:
        state["params2_by_date"] = p2
    return PolicyBundle(
        model=model, backward=BackwardResult.from_policy_state(state), times=times,
        adjustment_factor=float(meta["adjustment_factor"]), dual_mode=meta["dual_mode"],
        holdings_combine=meta["holdings_combine"],
        cost_of_capital=float(meta["cost_of_capital"]), sim_seed=meta.get("sim_seed"))


def save_bundle(directory, meta: dict, params1: dict, params2: dict | None = None,
                metrics: dict | None = None) -> PolicyBundle:
    """Write ``bundle.json`` + ``policy.npz``; returns the loaded-equivalent policy."""
    d = pathlib.Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    meta = {**meta, "format": FORMAT, "n_dates": len(meta["times"]) - 1}
    arrays = {f"params1/{k}": np.asarray(v, np.float32) for k, v in params1.items()}
    if params2 is not None:
        arrays.update({f"params2/{k}": np.asarray(v, np.float32) for k, v in params2.items()})
    for k, v in (metrics or {}).items():
        arrays[k] = np.asarray(v)
    policy = policy_from_numpy({**meta, **(metrics or {})}, params1, params2)
    np.savez(d / POLICY, **arrays)
    atomic_write_text(d / META, json.dumps(meta, indent=1, sort_keys=True))
    return policy


def load_bundle(directory) -> PolicyBundle:
    """Load and shape-verify a bundle written by :func:`save_bundle`.

    ``directory`` may also be a ``store://<root>#<tenant>[@version]`` URI: the
    tenant's manifest is resolved from the catalog, its blobs digest-verified
    and materialized into the store's shared warm directory, and the load
    proceeds from there, bitwise a load of the published directory."""
    if isinstance(directory, str) and directory.startswith("store://"):
        from orp_tpu_torch.store.catalog import open_store, parse_store_uri

        root, tenant_name, version = parse_store_uri(directory)
        return open_store(root).load(tenant_name, version)
    d = pathlib.Path(directory)
    meta_file = d / META
    if not meta_file.exists():
        raise ValueError(f"{d} is not a policy bundle (no {META})")
    meta = json.loads(meta_file.read_text())
    if meta.get("format") != FORMAT:
        raise ValueError(f"{d}: unsupported bundle format {meta.get('format')!r} "
                         f"(this loader reads {FORMAT})")
    with np.load(d / POLICY) as z:
        params1 = {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith("params1/")}
        params2 = {k.split("/", 1)[1]: z[k] for k in z.files if k.startswith("params2/")}
        metrics = {k: z[k] for k in METRICS if k in z.files}
    if int(meta["n_dates"]) != len(meta["times"]) - 1:
        raise ValueError(f"{d}: n_dates {meta['n_dates']} disagrees with "
                         f"{len(meta['times'])} knot times")
    policy = policy_from_numpy({**meta, **metrics}, params1, params2 or None)
    fp = None
    if read_fingerprint(d) is not None:
        fp = _fingerprint(policy.model, policy.n_dates, meta)
        verify_fingerprint(d, fp, what="bundle dir")
    sketch = validation = err0 = None
    baseline = meta.get("baseline")
    if baseline:
        from orp_tpu_torch.obs.quality import FeatureSketch, ValidationSpec

        if baseline.get("sketch"):
            sketch = FeatureSketch.from_meta(baseline["sketch"])
        if baseline.get("validation"):
            validation = ValidationSpec.from_meta(baseline["validation"])
        err0 = baseline.get("hedge_error")
    has_aot = (d / "aot" / "aot.json").exists()
    return dataclasses.replace(policy, fingerprint=fp, feature_sketch=sketch,
                               validation=validation,
                               hedge_error_baseline=None if err0 is None else float(err0),
                               aot_dir=d if has_aot else None)


def _fingerprint(model, n_dates: int, meta: dict) -> str:
    return policy_fingerprint(model, n_dates, dual_mode=meta["dual_mode"],
                              holdings_combine=meta["holdings_combine"],
                              cost_of_capital=float(meta["cost_of_capital"]))


def _host(params: dict | None) -> dict | None:
    return None if params is None else {
        k: (v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in params.items()}


def export_bundle(result, directory, *, store=None, tenant: str | None = None) -> PolicyBundle:
    """Export a trained ``PipelineResult`` (it must carry its ``model`` and
    per-date params) as a bundle under ``directory``: ``bundle.json`` with
    the baseline the pipelines attach (``feature_sketch``, ``validation``,
    ``hedge_error_baseline``), ``policy.npz`` and ``run_fingerprint.txt``.
    Re-exporting the same policy config over a bundle overwrites it; another
    config refuses, as a checkpoint directory does. Returns the loaded
    equivalent ``PolicyBundle``.

    With ``store`` (a ``BundleStore`` or its root directory) the finished
    export is also published into the content-addressed catalog under
    ``tenant`` (default: the bundle directory's name), for replicas to load
    as ``store://<root>#<tenant>``."""
    model = getattr(result, "model", None)
    if model is None:
        raise ValueError("result carries no model (PipelineResult.model is None)")
    bw = result.backward
    times = np.asarray(result.times, np.float64)
    n_dates = len(times) - 1
    verify_policy_compat("export_bundle", model, n_dates, bw.params1_by_date)
    meta = {"model": model_meta(model), "times": times.tolist(),
            "adjustment_factor": float(result.adjustment_factor),
            "dual_mode": result.dual_mode, "holdings_combine": result.holdings_combine,
            "cost_of_capital": float(result.cost_of_capital), "sim_seed": result.sim_seed}
    fp = _fingerprint(model, n_dates, meta)
    d = pathlib.Path(directory)
    if (d / META).exists():
        verify_fingerprint(d, fp, what="bundle dir")
    sketch = getattr(result, "feature_sketch", None)
    validation = getattr(result, "validation", None)
    err0 = getattr(result, "hedge_error_baseline", None)
    if sketch is not None or validation is not None:
        meta["baseline"] = {
            "sketch": None if sketch is None else sketch.to_meta(),
            "validation": None if validation is None else validation.to_meta(),
            "hedge_error": None if err0 is None else float(err0)}
    metrics = {k: np.asarray(getattr(bw, k)) for k in METRICS}
    policy = save_bundle(d, meta, _host(bw.params1_by_date), _host(bw.params2_by_date),
                         metrics)
    write_fingerprint(d, fp)
    if store is not None:
        from orp_tpu_torch.store.catalog import open_store

        st = store if hasattr(store, "publish") else open_store(store)
        st.publish(tenant if tenant is not None else d.name, d)
    return dataclasses.replace(policy, fingerprint=fp, feature_sketch=sketch,
                               validation=validation,
                               hedge_error_baseline=None if err0 is None else float(err0))
