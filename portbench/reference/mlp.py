"""The hedge network in plain PyTorch: features -> Dense(8, LeakyReLU 0.3) ->
Dense(8, LeakyReLU 0.3) -> Dense(2) = holdings (phi, psi), and the portfolio
value ``V = phi * price_risky + psi * price_bond``.

Params are a dict ``{"w0": (f, 8), "b0": (8,), ..., "w2": (8, 2), "b2": (2,)}``
and flatten in sorted-name order (``b0, b1, b2, w0, w1, w2``). The initial
params are ``N(0, 1) * 0.1`` weights from a CPU ``torch.Generator`` seeded with
the configuration's seed, drawn layer by layer, zero biases, and the output
bias set to the configuration's starting holdings.
"""

from __future__ import annotations

import math

import torch

SLOPE = 0.3
HIDDEN = (8, 8)
NAMES = ("b0", "b1", "b2", "w0", "w1", "w2")


def check_model(model: dict) -> None:
    """Raise unless a configuration's ``model`` block is the network this file
    computes: its hidden sizes, slope, free two-output head and parameter count
    (``init_scale`` is passed to :func:`init`)."""
    want = {"hidden": list(HIDDEN), "negative_slope": SLOPE, "n_outputs": 2,
            "constrain_self_financing": False,
            "n_params": sum(math.prod(s) for s in shapes(model["n_features"]).values())}
    bad = {k: (model.get(k), v) for k, v in want.items() if model.get(k) != v}
    if bad:
        raise ValueError(f"the reference network differs from the configuration's model "
                         f"(key: (file, reference)): {bad}")


def shapes(n_features: int, hidden=(8, 8), n_outputs: int = 2) -> dict[str, tuple]:
    sizes = (n_features, *hidden, n_outputs)
    out = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        out[f"w{i}"], out[f"b{i}"] = (a, b), (b,)
    return {k: out[k] for k in sorted(out)}


def init(n_features: int, seed: int, bias: tuple[float, float], scale: float = 0.1) -> dict:
    gen = torch.Generator().manual_seed(seed)
    sizes = (n_features, 8, 8, 2)
    params = {}
    for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
        params[f"w{i}"] = torch.randn((a, b), generator=gen, dtype=torch.float32) * scale
        params[f"b{i}"] = torch.zeros(b, dtype=torch.float32)
    params["b2"] = torch.tensor(bias, dtype=torch.float32)
    return params


def flatten(params: dict) -> torch.Tensor:
    return torch.cat([params[k].reshape(-1) for k in NAMES])


def unflatten(theta: torch.Tensor, n_features: int) -> dict:
    out, off = {}, 0
    for k, shape in shapes(n_features).items():
        out[k] = theta[off:off + math.prod(shape)].reshape(shape)
        off += math.prod(shape)
    return out


def _layers(params: dict, x: torch.Tensor):
    trace = []
    for i in range(2):
        z = x @ params[f"w{i}"] + params[f"b{i}"]
        trace.append((x, z))
        x = torch.where(z >= 0, z, SLOPE * z)
    return trace, x


def holdings(params: dict, x: torch.Tensor) -> torch.Tensor:
    """``(n, 2)`` holdings at features ``x (n, f)``."""
    return _layers(params, x)[1] @ params["w2"] + params["b2"]


def value(params: dict, x: torch.Tensor, prices: torch.Tensor) -> torch.Tensor:
    return torch.sum(holdings(params, x) * prices, dim=-1)


def value_jacobian(params: dict, x: torch.Tensor, prices: torch.Tensor):
    """``(value (n,), J (n, P))``: the value and its gradient in the flat params,
    by the chain rule (slope 1 at ``z >= 0``)."""
    trace, h = _layers(params, x)
    out = h @ params["w2"] + params["b2"]
    val = torch.sum(out * prices, dim=-1)
    n = x.shape[0]
    cols = {}
    g = prices                                                 # dV/d(out)
    cols["w2"] = (h[:, :, None] * g[:, None, :]).reshape(n, -1)
    cols["b2"] = g
    delta = g @ params["w2"].T
    for i in (1, 0):
        x_in, z = trace[i]
        dz = torch.where(z >= 0, delta, SLOPE * delta)
        cols[f"w{i}"] = (x_in[:, :, None] * dz[:, None, :]).reshape(n, -1)
        cols[f"b{i}"] = dz
        delta = dz @ params[f"w{i}"].T
    return val, torch.cat([cols[k] for k in NAMES], dim=1)
