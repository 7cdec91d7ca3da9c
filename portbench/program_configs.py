"""The program's config objects from a configuration file and the traffic's
path count: the only place the benchmark spells the program's config types."""

from __future__ import annotations

from orp_tpu_torch.api import (ActuarialConfig, EuropeanConfig, HedgeRunConfig, MarketConfig,
                               SimConfig, TrainConfig)
from orp_tpu_torch.models.mlp import HedgeMLP
from orp_tpu_torch.train.gn import GNConfig, GNPinballConfig


def check_fixed(cfg: dict) -> None:
    """Raise unless the sizes the program takes from its own defaults, not from
    its config objects, are the file's: the ``gn`` block (``GNConfig`` and, for
    the quantile leg, ``GNPinballConfig``) and the ``model`` block
    (``HedgeMLP``)."""
    mse, q = GNConfig(), GNPinballConfig()
    want = {k: getattr(mse, k) for k in ("init_lambda", "lambda_up", "lambda_down",
                                         "min_rel_improve", "ridge")}
    want.update(quantile_init_lambda=q.init_lambda, weight_floor=q.weight_floor)
    bad = {f"gn.{k}": (v, want.get(k)) for k, v in cfg["gn"].items() if want.get(k) != v}
    model = HedgeMLP(n_features=cfg["model"]["n_features"])
    mine = {"hidden": list(model.hidden), "negative_slope": model.negative_slope,
            "init_scale": model.init_scale, "n_outputs": model.n_outputs,
            "constrain_self_financing": model.constrain_self_financing,
            "n_params": model.n_params()}
    bad.update({f"model.{k}": (cfg["model"].get(k), v) for k, v in mine.items()
                if cfg["model"].get(k) != v})
    if bad:
        raise ValueError(f"{cfg['name']}: the file differs from what the program runs "
                         f"(key: (file, program)): {bad}")


def train_config(cfg: dict) -> TrainConfig:
    check_fixed(cfg)
    tr = cfg["train"]
    return TrainConfig(dual_mode=tr["dual_mode"], holdings_combine=tr["holdings_combine"],
                       cost_of_capital=tr["cost_of_capital"], quantile=tr["quantile"],
                       optimizer=tr["optimizer"], gn_iters_first=tr["gn_iters_first"],
                       gn_iters_warm=tr["gn_iters_warm"], fused=tr["fused"], seed=tr["seed"])


def euro_configs(cfg: dict, n_paths: int):
    """``(EuropeanConfig, seed -> SimConfig, TrainConfig)``; the seed is the
    risky asset's Sobol stream."""
    euro = EuropeanConfig(s0=cfg["s0"], strike=cfg["strike"], r=cfg["r"], sigma=cfg["sigma"],
                          option_type=cfg["option_type"],
                          constrain_self_financing=cfg["model"]["constrain_self_financing"])

    def sim(seed: int) -> SimConfig:
        return SimConfig(n_paths=n_paths, T=cfg["T"], dt=cfg["T"] / cfg["n_steps"],
                         rebalance_every=cfg["rebalance_every"], seed_fund=seed,
                         engine=cfg["engine"])

    return euro, sim, train_config(cfg)


def pension_config(cfg: dict, n_paths: int, seed: int) -> HedgeRunConfig:
    """The pension run; ``seed`` is the system's Sobol stream (every factor)."""
    return HedgeRunConfig(
        market=MarketConfig(y0=cfg["y0"], mu=cfg["mu"], r=cfg["r"], sigma=cfg["sigma"]),
        actuarial=ActuarialConfig(n0=cfg["n0"], premium=cfg["premium"],
                                  guarantee=cfg["guarantee"], age=cfg["age"], l0=cfg["l0"],
                                  mort_c=cfg["mort_c"], eta=cfg["eta"]),
        sim=SimConfig(n_paths=n_paths, T=cfg["T"], dt=cfg["T"] / cfg["n_steps"],
                      rebalance_every=cfg["rebalance_every"], seed=seed,
                      binomial_mode=cfg["binomial_mode"], engine=cfg["engine"]),
        train=train_config(cfg))
