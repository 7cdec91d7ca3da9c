"""Mixed-date head forward: one kernel for a block whose rows sit at different dates.

Counterpart of ``orp_tpu/serve/megakernel.py::mixed_head_forward`` (the Pallas
``_head_kernel``) and its wrapper ``_eval_core_mixed``. Row ``r`` runs the
hedge MLP under the params of its own date ``dates[r]``: HIGHEST-precision
f32 dots, LeakyReLU between layers, raw head outputs ``(B, n_outputs)``.

- :func:`mixed_head_forward` is the wrapper: the CUDA kernel
  (``csrc/mixed_head.cu``: one thread per row, every date's params staged in
  shared memory, a per-row gather of its date's weights) for CUDA tensors,
  :func:`mixed_head_plain` for CPU tensors. On the card it launches the
  kernel or raises; it never falls back.
- :func:`mixed_head_plain` is the JAX kernel's math in plain PyTorch: the
  full-block forward under each date's params, rows committed by date mask.

The kernel takes layer counts up to ``MAX_LAYERS`` and every width (features,
hidden, outputs) up to ``MAX_WIDTH``, with all dates' params within
``MAX_SMEM_BYTES`` of shared memory; the wrapper raises above those caps.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from orp_tpu_torch.train.backward import _split_holdings
from orp_tpu_torch.utils import cuda_build

MAX_LAYERS = 4
MAX_WIDTH = 16
MAX_SMEM_BYTES = 232_448  # what one block may use on sm_90


def _layer_sizes(model) -> tuple[int, ...]:
    return (model.n_features, *model.hidden, model.n_outputs)


def pack_head_params(model, params_by_date: dict) -> torch.Tensor:
    """``(D, P)`` f32: per date ``w0`` (row-major ``(f0, h0)``), ``b0``, ``w1``, ..."""
    n_layers = len(model.hidden) + 1
    parts = []
    for i in range(n_layers):
        w, b = params_by_date[f"w{i}"], params_by_date[f"b{i}"]
        parts += [w.reshape(w.shape[0], -1), b]
    return torch.cat(parts, dim=1).to(torch.float32).contiguous()


def mixed_head_plain(model, params_by_date: dict, dates: torch.Tensor,
                     feats: torch.Tensor) -> torch.Tensor:
    """Per-date masked forward over the whole block (the Pallas kernel's math).
    Rows whose date is outside ``[0, D)`` stay NaN, as in the CUDA kernel."""
    n_layers = len(model.hidden) + 1
    n_dates = int(params_by_date["w0"].shape[0])
    dates = dates.reshape(-1, 1)
    out = torch.full((feats.shape[0], model.n_outputs), float("nan"), dtype=feats.dtype,
                     device=feats.device)
    for d in range(n_dates):
        x = feats
        for i in range(n_layers):
            x = x @ params_by_date[f"w{i}"][d] + params_by_date[f"b{i}"][d]
            if i < n_layers - 1:
                x = torch.where(x >= 0, x, model.negative_slope * x)
        out = torch.where(dates == d, x, out)
    return out


def _kernel() -> ctypes.CDLL:
    lib = cuda_build.load("mixed_head")
    fn = lib.orp_mixed_head_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_head_shape(model, n_dates: int) -> None:
    """Raise when ``model`` over ``n_dates`` dates exceeds the kernel's caps."""
    sizes = _layer_sizes(model)
    if len(sizes) - 1 > MAX_LAYERS or max(sizes) > MAX_WIDTH:
        raise ValueError(
            f"mixed_head kernel takes at most {MAX_LAYERS} layers of width <= "
            f"{MAX_WIDTH}; model has layer sizes {sizes}")
    smem = 4 * n_dates * model.n_params()
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"mixed_head kernel stages all {n_dates} dates' params in shared memory: "
            f"{smem} bytes exceed {MAX_SMEM_BYTES}")


def mixed_head_forward(model, params_by_date: dict, dates: torch.Tensor,
                       feats: torch.Tensor, *, packed: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Raw head outputs ``(B, n_outputs)`` where row ``r`` uses date ``dates[r]``'s params.

    ``dates``: int32 ``(B,)`` (or ``(B, 1)``) in ``[0, D)``; ``feats``: f32
    ``(B, n_features)``; ``params_by_date``: ``{w{i}: (D, f_i, h_i), b{i}: (D, h_i)}``
    on the same device. ``packed`` is ``pack_head_params``'s result, for
    callers that keep it across calls. A date outside ``[0, D)`` yields NaN
    rows on the card (the engine validates dates on the host)."""
    dates = dates.reshape(-1)
    if feats.device.type == "cpu":
        return mixed_head_plain(model, params_by_date, dates, feats)
    if feats.device.type != "cuda":
        raise ValueError(f"mixed_head_forward runs on cuda or cpu, not {feats.device}")
    n, f = feats.shape
    n_dates = int(params_by_date["w0"].shape[0])
    check_head_shape(model, n_dates)
    if packed is None:
        packed = pack_head_params(model, params_by_date)
    if f != model.n_features or dates.shape[0] != n:
        raise ValueError(f"feats {tuple(feats.shape)} / dates {tuple(dates.shape)} do "
                         f"not match {model.n_features} features, one date per row")
    for name, t, dt in (("dates", dates, torch.int32), ("feats", feats, torch.float32),
                        ("params", packed, torch.float32)):
        if t.device != feats.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {dt} tensor on {feats.device}; "
                             f"got {t.dtype} on {t.device}")
    if packed.shape != (n_dates, model.n_params()):
        raise ValueError(f"packed params {tuple(packed.shape)} != "
                         f"{(n_dates, model.n_params())}")
    out = torch.empty((n, model.n_outputs), dtype=torch.float32, device=feats.device)
    if n == 0:
        return out
    sizes = (ctypes.c_int * (MAX_LAYERS + 1))(*_layer_sizes(model))
    lib = _kernel()
    with torch.cuda.device(feats.device):
        rc = lib.orp_mixed_head_launch(
            dates.data_ptr(), feats.data_ptr(), packed.data_ptr(), out.data_ptr(), n,
            n_dates, len(model.hidden) + 1, sizes, float(model.negative_slope),
            torch.cuda.current_stream(feats.device).cuda_stream)
    cuda_build.check(lib, rc, "mixed_head")
    mixed_head_forward.launches += 1
    return out


mixed_head_forward.launches = 0


def _constrain(model, x: torch.Tensor) -> torch.Tensor:
    """``HedgeMLP.holdings``' head tail on the kernel's raw outputs."""
    if model.constrain_self_financing:
        phi = x[..., 0]
        return torch.stack([phi, 1.0 - phi], dim=-1)
    return x


def _eval_core_mixed(model, p1_all, p2_all, dates, feats, prices, cost_of_capital, *,
                     dual_mode, holdings_combine, packed1=None, packed2=None):
    """The mixed-date twin of ``engine._eval_core`` (f32 tier): per-ROW date
    indices, the head through the kernel, the dual-mode combines after it
    (``prices_t1 = 0``, so only value and holdings survive)."""
    h1 = _constrain(model, mixed_head_forward(model, p1_all, dates, feats, packed=packed1))
    p = prices.to(model.dtype)
    if dual_mode == "mse_only":
        comb = h1
        v = torch.sum(h1 * p, dim=-1)
    else:
        h2 = _constrain(model, mixed_head_forward(model, p2_all, dates, feats,
                                                  packed=packed2))
        g = torch.sum(h1 * p, dim=-1)
        h = torch.sum(h2 * p, dim=-1)
        v = g + cost_of_capital * (h - g)
        if dual_mode == "shared":
            comb = h2
        elif holdings_combine == "py":
            comb = h1 + cost_of_capital * (h1 - h2)
        else:
            comb = h1 + cost_of_capital * (h2 - h1)
    phi, psi = _split_holdings(comb)
    return phi, psi, v


def loop_of_buckets(engine, dates, states, prices=None):
    """One bucketed ``engine.evaluate`` per DISTINCT date, rows scattered back:
    the fragmentation baseline the mixed-date kernel replaces."""
    dates = np.asarray(dates, np.int64).reshape(-1)
    states = np.asarray(states)
    n = states.shape[0]
    phi = psi = v = None
    for d in np.unique(dates):
        m = dates == d
        p_, s_, v_ = engine.evaluate(int(d), states[m], None if prices is None else prices[m])
        if phi is None:
            phi = np.zeros((n, *p_.shape[1:]), p_.dtype)
            psi = np.zeros((n, *s_.shape[1:]), s_.dtype)
            v = np.zeros((n, *v_.shape[1:]), v_.dtype) if v_ is not None else None
        phi[m] = p_
        psi[m] = s_
        if v is not None:
            v[m] = v_
    return phi, psi, v
