"""Serving precision tiers: f32 (exact), bf16, int8 weights with f32 accumulate
(counterpart of ``orp_tpu/serve/precision.py``).

``f32``
    The engine as it always served: ``prepare_params`` is the engine's cast to
    the model's dtype and ``eval_model`` the model itself, so no bit moves.
``bf16``
    Params, features, prices and the whole forward run in bfloat16 (the model
    is replaced by ``HedgeMLP.with_dtype(torch.bfloat16)``). Operations round
    to bf16 as the JAX package's compiled program does: the dots reduce in f32
    and round once (``utils/precision.full_f32`` pins cuBLAS to that), the
    LeakyReLU slope and the cost of capital are rounded to bf16 first
    (``utils/precision.typed_scalar``), and ``serve/megakernel.serve_outputs``
    leaves the roundings that XLA leaves out. Outputs are f32.
``int8``
    Weight-only quantization: per-date, per-tensor symmetric absmax int8
    weights with an f32 scale, dequantized to f32 after the date gather; the
    forward then runs in f32. Biases stay in the model's dtype.

Reduced tiers are not bitwise the f32 tier; ``serve/bench.PRECISION_BANDS``
bounds how far they may serve from it. Two bf16 computations of the same
forward that sum a dot's f32 partials in different orders round apart on a few
elements; :func:`bf16_agreement` measures that (the share of equal elements
and the largest gap in bf16 spacings), and :data:`BF16_RULE` is what the port
holds such pairs to.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: the valid tiers, in decreasing precision order
TIERS = ("f32", "bf16", "int8")

#: two bf16 results of one forward agree when at least this share of elements
#: is bitwise equal and every element is within this many bf16 spacings
BF16_RULE = {"equal_share": 0.999, "max_ulps": 4.0}

#: the keys of a quantized weight's dict
_QKEYS = frozenset({"q", "scale"})


@dataclasses.dataclass(frozen=True)
class PrecisionPolicy:
    """One serving precision tier (frozen and hashable)."""

    tier: str = "f32"

    def __post_init__(self):
        if self.tier not in TIERS:
            raise ValueError(f"precision tier {self.tier!r} not in {TIERS}")

    @property
    def is_f32(self) -> bool:
        return self.tier == "f32"

    def eval_dtype(self, model) -> torch.dtype:
        """The dtype request rows are evaluated in."""
        return torch.bfloat16 if self.tier == "bf16" else model.dtype


def normalize_precision(precision) -> PrecisionPolicy:
    """Accept a tier string or a :class:`PrecisionPolicy`."""
    if isinstance(precision, PrecisionPolicy):
        return precision
    return PrecisionPolicy(str(precision))


def eval_model(model, tier: str):
    """The model the tier runs: the bf16 replica for ``bf16``, else ``model``
    (int8 dequantizes to f32 and runs the f32 model)."""
    if tier == "bf16":
        return model.with_dtype(torch.bfloat16)
    return model


def is_quantized(node) -> bool:
    return isinstance(node, dict) and set(node) == _QKEYS


def _tensor(x, dtype: torch.dtype) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.array(x))
    return t.to(dtype)


def quantize_tensor(x, *, accum_dtype: torch.dtype = torch.float32) -> dict:
    """Per-date, per-tensor symmetric absmax int8 quantization of a date-stacked
    ``(D, ...)`` weight: ``{"q": int8, "scale": accum_dtype (D, 1, ...)}``.

    The same operations as the JAX package, in the same dtype: ``absmax / 127``
    (an all-zero date gets scale 1), ``round`` half to even, clip to +-127."""
    x = _tensor(x, accum_dtype)
    axes = tuple(range(1, x.ndim))
    absmax = torch.amax(torch.abs(x), dim=axes, keepdim=True) if axes else torch.abs(x)
    scale = torch.where(absmax > 0, absmax / 127.0, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(accum_dtype)}


def dequantize_params(tree: dict) -> dict:
    """Every ``{"q", "scale"}`` node becomes ``q * scale`` in the scale's dtype
    (f32, the accumulate dtype); other leaves pass through."""
    return {k: (v["q"].to(v["scale"].dtype) * v["scale"] if is_quantized(v) else v)
            for k, v in tree.items()}


def gather_date(tree: dict, t) -> dict:
    """Date ``t``'s slice of every leaf of a date-stacked params dict, quantized
    nodes included (``scale`` keeps its broadcast shape). ``t`` is an int, or a
    0-d integer tensor on the params' device (a CUDA graph's date: the slices
    are then gathered copies, the same values, read with no host sync)."""
    if isinstance(t, torch.Tensor):
        idx = t.reshape(1)
        at = lambda x: x.index_select(0, idx).squeeze(0)  # noqa: E731
    else:
        at = lambda x: x[t]  # noqa: E731
    return {k: ({n: at(x) for n, x in v.items()} if is_quantized(v) else at(v))
            for k, v in tree.items()}


def prepare_params(params_by_date: dict | None, tier: str, *,
                   model_dtype: torch.dtype = torch.float32, device=None) -> dict | None:
    """Tier-transform a date-stacked params dict (numpy arrays or tensors) into
    contiguous tensors on ``device``.

    ``f32``: the cast to ``model_dtype``. ``bf16``: every leaf cast to bf16.
    ``int8``: each weight (``w*``) quantized per date and tensor; biases stay
    ``model_dtype``."""
    if params_by_date is None:
        return None
    if tier not in TIERS:
        raise ValueError(f"precision tier {tier!r} not in {TIERS}")

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(device).contiguous() if device is not None else t.contiguous()

    out = {}
    for k, x in params_by_date.items():
        if tier == "int8" and k.startswith("w"):
            out[k] = {n: put(v) for n, v in quantize_tensor(x, accum_dtype=model_dtype).items()}
        else:
            out[k] = put(_tensor(x, torch.bfloat16 if tier == "bf16" else model_dtype))
    return out


def bf16_agreement(got, want) -> dict:
    """How far ``got`` is from ``want`` (arrays or tensors of one shape, any
    float dtype): the share of bitwise-equal elements, the count that differ,
    and the largest ``|got - want|`` in bf16 spacings at ``|want|`` (2^-7 of
    its power of two; normal bf16 range), and whether that meets
    :data:`BF16_RULE`."""
    g = np.asarray(got.float().cpu() if isinstance(got, torch.Tensor) else got, np.float64)
    w = np.asarray(want.float().cpu() if isinstance(want, torch.Tensor) else want, np.float64)
    if g.shape != w.shape:
        raise ValueError(f"shapes differ: {g.shape} vs {w.shape}")
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    spacing = np.exp2(np.floor(np.log2(np.maximum(np.abs(w), 2.0 ** -126))) - 7)
    gap = np.where(same, 0.0, np.abs(g - w) / spacing)
    out = {"equal_share": float(same.mean()) if same.size else 1.0,
           "n_differ": int((~same).sum()),
           "max_ulps": float(np.nan_to_num(gap, nan=np.inf).max()) if gap.size else 0.0}
    out["ok"] = (out["equal_share"] >= BF16_RULE["equal_share"]
                 and out["max_ulps"] <= BF16_RULE["max_ulps"])
    return out
