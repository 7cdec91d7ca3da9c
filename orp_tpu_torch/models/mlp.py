"""The (phi, psi) hedge network (counterpart of ``orp_tpu/models/mlp.py``).

A frozen dataclass holding the architecture plus pure functions over a params
dict ``{"w0": (f, h0), "b0": (h0,), ...}``: features -> Dense(8, LeakyReLU 0.3)
-> Dense(8, LeakyReLU 0.3) -> Dense(n_outputs) -> holdings, and the Dot head
``V = sum_j holdings_j * prices_j``. The constrained head returns
``(phi, 1 - phi)`` from one output; ``n_hedge_assets > 1`` is the vector
hedge (one phi per risky asset, then the bond).

Training adds :meth:`HedgeMLP.init` (the JAX law from a ``torch.Generator``;
JAX's threefry bits cannot be reproduced, so parity runs pass JAX-initialised
params in), :meth:`HedgeMLP.solve_readout` (the closed-form ridge readout) and
:meth:`HedgeMLP.value_jacobian`, the per-sample value gradient in closed form
that the Gauss-Newton fit squares into its Gram. Params flatten in sorted-key
order, the order of JAX's ``ravel_pytree``.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from orp_tpu_torch.parallel.mesh import path_means
from orp_tpu_torch.utils.precision import full_f32, typed_scalar

Params = dict


@dataclasses.dataclass(frozen=True)
class HedgeMLP:
    """Config + pure forward of the hedge network."""

    n_features: int
    hidden: tuple[int, ...] = (8, 8)
    negative_slope: float = 0.3
    constrain_self_financing: bool = False
    init_scale: float = 0.1
    dtype: torch.dtype = torch.float32
    n_hedge_assets: int = 1

    def __post_init__(self):
        if self.constrain_self_financing and self.n_hedge_assets != 1:
            raise ValueError(
                "psi = 1 - phi is a two-instrument normalisation; "
                f"n_hedge_assets={self.n_hedge_assets} needs the free head")

    @property
    def n_outputs(self) -> int:
        if self.constrain_self_financing:
            return 1
        return self.n_hedge_assets + 1

    @property
    def layer_sizes(self) -> tuple[int, ...]:
        return (self.n_features, *self.hidden, self.n_outputs)

    def with_dtype(self, dtype) -> "HedgeMLP":
        """The same architecture computing in ``dtype``."""
        if dtype == self.dtype:
            return self
        return dataclasses.replace(self, dtype=dtype)

    def _hidden(self, params: Params, features: torch.Tensor):
        """Each hidden layer's input and pre-activation, and the last activations."""
        x, trace = features.to(self.dtype), []
        for i in range(len(self.hidden)):
            z = x @ params[f"w{i}"] + params[f"b{i}"]
            trace.append((x, z))
            x = torch.where(z >= 0, z, typed_scalar(self.negative_slope, z.dtype) * z)
        return trace, x

    def last_hidden(self, params: Params, features: torch.Tensor) -> torch.Tensor:
        """Activations feeding the final layer: ``(n, hidden[-1])``."""
        return self._hidden(params, features)[1]

    def head(self, params: Params, features: torch.Tensor) -> torch.Tensor:
        """The last layer's raw outputs ``(n, n_outputs)``, before the
        constrained head's ``(phi, 1 - phi)``."""
        last = len(self.hidden)
        return self.last_hidden(params, features) @ params[f"w{last}"] + params[f"b{last}"]

    def holdings(self, params: Params, features: torch.Tensor) -> torch.Tensor:
        """Forward to the holdings layer: ``(n, n_instruments)`` (phi..., psi)."""
        x = self.head(params, features)
        if self.constrain_self_financing:
            phi = x[..., 0]
            return torch.stack([phi, 1.0 - phi], dim=-1)
        return x

    def value(self, params: Params, features: torch.Tensor, prices: torch.Tensor) -> torch.Tensor:
        """Portfolio value ``V = sum_j holdings_j * prices_j``."""
        return torch.sum(self.holdings(params, features) * prices.to(self.dtype), dim=-1)

    def n_params(self) -> int:
        sizes = self.layer_sizes
        return sum((a + 1) * b for a, b in zip(sizes[:-1], sizes[1:]))

    def param_shapes(self) -> dict[str, tuple[int, ...]]:
        """``{name: shape}`` in the flat order (sorted names, as ``ravel_pytree``)."""
        sizes = self.layer_sizes
        shapes = {}
        for i, (a, b) in enumerate(zip(sizes[:-1], sizes[1:])):
            shapes[f"w{i}"], shapes[f"b{i}"] = (a, b), (b,)
        return {k: shapes[k] for k in sorted(shapes)}

    def flatten(self, params: Params) -> torch.Tensor:
        return torch.cat([params[k].reshape(-1) for k in self.param_shapes()])

    def unflatten(self, theta: torch.Tensor) -> Params:
        out, off = {}, 0
        for k, shape in self.param_shapes().items():
            out[k] = theta[off:off + math.prod(shape)].reshape(shape)
            off += math.prod(shape)
        return out

    def init(self, generator: torch.Generator | None = None,
             bias_init: tuple[float, ...] | None = None) -> Params:
        """Weights ``N(0, 1) * init_scale`` drawn from ``generator``, zero biases;
        ``bias_init`` warm-starts the output bias (one value per output: ``(phi0,
        psi0)`` for the 2-instrument head, only ``phi0`` for the constrained one)."""
        if bias_init is not None and len(bias_init) < self.n_outputs:
            raise ValueError(f"bias_init has {len(bias_init)} entries; this head needs "
                             f"{self.n_outputs} (one per output)")
        sizes = self.layer_sizes
        params = {}
        for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            params[f"w{i}"] = torch.randn((fan_in, fan_out), generator=generator,
                                          dtype=self.dtype) * self.init_scale
            params[f"b{i}"] = torch.zeros(fan_out, dtype=self.dtype)
        if bias_init is not None:
            params[f"b{len(sizes) - 2}"] = torch.tensor(bias_init[:self.n_outputs],
                                                        dtype=self.dtype)
        return params

    def value_jacobian(self, params: Params, features: torch.Tensor, prices: torch.Tensor,
                       out: torch.Tensor | None = None):
        """``(value (n,), J (n, P))``: the portfolio value and its gradient in the
        flat params (:meth:`flatten`'s order), per sample, by the chain rule
        through the Dot head, the readout and each LeakyReLU (slope 1 at
        ``z >= 0``, JAX's ``where`` gradient). ``out`` receives ``J`` when given."""
        trace, x = self._hidden(params, features)
        last = len(self.hidden)
        h = x @ params[f"w{last}"] + params[f"b{last}"]
        p = prices.to(self.dtype)
        if self.constrain_self_financing:
            phi = h[..., 0]
            value = torch.sum(torch.stack([phi, 1.0 - phi], dim=-1) * p, dim=-1)
            g = (p[..., 0] - p[..., 1])[:, None]       # dV/dphi
        else:
            value = torch.sum(h * p, dim=-1)
            g = p                                      # dV/dh_j = price_j
        n = h.shape[0]
        J = torch.empty((n, self.n_params()), dtype=self.dtype,
                        device=h.device) if out is None else out
        offsets, off = {}, 0
        for k, shape in self.param_shapes().items():
            offsets[k] = off
            off += math.prod(shape)

        def put(i, x_in, dz):
            a, b = x_in.shape[1], dz.shape[1]
            ow, ob = offsets[f"w{i}"], offsets[f"b{i}"]
            torch.mul(x_in[:, :, None], dz[:, None, :], out=J[:, ow:ow + a * b].view(n, a, b))
            J[:, ob:ob + b].copy_(dz)

        put(last, x, g)
        delta = g @ params[f"w{last}"].T
        for i in range(last - 1, -1, -1):
            x_in, z = trace[i]
            dz = torch.where(z >= 0, delta, self.negative_slope * delta)
            put(i, x_in, dz)
            delta = dz @ params[f"w{i}"].T
        return value, J

    def solve_readout(self, params: Params, features: torch.Tensor, prices: torch.Tensor,
                      targets: torch.Tensor, ridge: float = 1e-3, mesh=None) -> Params:
        """Closed-form least squares for the final layer, hidden layers fixed,
        shrunk toward the incoming readout: minimises ``|X theta - y|^2/n + lam
        |theta - theta0|^2`` with ``lam = ridge * tr(G)/dim``, so the training
        MSE never rises. Runs under full f32 (normal equations square the
        condition number; TF32 is the hazard here). Under a paths ``mesh`` the
        rows are this rank's block and the normal equations are the ranks'
        means, summed across the mesh."""
        full_f32()
        dt = self.dtype
        h = self.last_hidden(params, features)                   # (n, H)
        p = prices.to(dt)
        y = targets.to(dt)
        n = h.shape[0]
        hb = torch.cat([h, torch.ones((n, 1), dtype=dt, device=h.device)], dim=1)
        if self.constrain_self_financing:
            d = p[..., 0] - p[..., 1]
            X = hb * d[:, None]                                  # (n, H+1)
            y = y - p[..., 1]
            out_cols = 1
        else:
            X = (hb[:, :, None] * p[:, None, :]).reshape(n, -1)  # (n, (H+1)k)
            out_cols = p.shape[-1]
        g = X.T @ X / n
        c = X.T @ y / n
        g, c = path_means(mesh, g, c)
        dim = g.shape[0]
        last = len(self.hidden)
        theta0 = torch.cat([params[f"w{last}"], params[f"b{last}"][None, :]],
                           dim=0).to(dt).reshape(-1)             # (dim,) i-major
        lam = ridge * (torch.trace(g) / dim) + 1e-12
        eye = torch.eye(dim, dtype=dt, device=g.device)
        theta = torch.linalg.solve_ex(g + lam * eye, c + lam * theta0)[0]
        theta = theta.reshape(dim // out_cols, out_cols)
        return {**params, f"w{last}": theta[:-1], f"b{last}": theta[-1]}
