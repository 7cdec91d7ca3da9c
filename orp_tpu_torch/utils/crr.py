"""Cox-Ross-Rubinstein binomial oracle for Bermudan/American options
(counterpart of ``orp_tpu/utils/crr.py``, copied).

Host-side NumPy f64 (an oracle, not a compute path — same policy as
``utils/black_scholes.py``/``utils/heston.py``). It pins the port's LSM
pricer (``train/lsm.py``).
"""

from __future__ import annotations

import math

import numpy as np


def crr_price(
    s0: float,
    k: float,
    r: float,
    sigma: float,
    T: float,
    *,
    kind: str = "put",
    exercise: str = "american",
    n_steps: int = 2000,
    exercise_every: int | None = None,
) -> float:
    """Binomial price. ``exercise``: "european" | "american" | "bermudan"
    (Bermudan exercises only every ``exercise_every`` tree steps, so choose
    ``n_steps`` divisible by the number of exercise dates)."""
    if kind not in ("call", "put"):
        raise ValueError(f"kind must be 'call' or 'put', got {kind!r}")
    if exercise not in ("european", "american", "bermudan"):
        raise ValueError(f"unknown exercise style {exercise!r}")
    if exercise == "bermudan":
        if not exercise_every or n_steps % exercise_every:
            raise ValueError(
                "bermudan needs exercise_every dividing n_steps "
                f"(got {exercise_every}, {n_steps})"
            )
    dt = T / n_steps
    u = math.exp(sigma * math.sqrt(dt))
    d = 1.0 / u
    disc = math.exp(-r * dt)
    p = (math.exp(r * dt) - d) / (u - d)
    if not 0.0 < p < 1.0:
        raise ValueError("CRR no-arbitrage violated: refine n_steps")

    j = np.arange(n_steps + 1)
    s_t = s0 * u ** (n_steps - j) * d ** j
    sign = 1.0 if kind == "call" else -1.0
    v = np.maximum(sign * (s_t - k), 0.0)
    for step in range(n_steps - 1, -1, -1):
        v = disc * (p * v[:-1] + (1.0 - p) * v[1:])
        can_exercise = exercise == "american" or (
            exercise == "bermudan" and step > 0 and step % exercise_every == 0
        )
        if can_exercise:
            s_t = s0 * u ** (step - np.arange(step + 1)) * d ** np.arange(step + 1)
            v = np.maximum(v, np.maximum(sign * (s_t - k), 0.0))
    return float(v[0])
