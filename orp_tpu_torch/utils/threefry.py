"""Threefry-2x32 keys and JAX's binomial sampler in plain tensor ops (the JAX package's ``jax.random`` draws of exact thinning).

The JAX package draws exact thinning's survivors as
``jax.random.binomial(fold_in(fold_in(key(seed), t), path_index), n, p)``
(``orp_tpu/sde/kernels.py::_binomial_step``): a path's draw at step ``t`` is a
function of ``(seed, t, global path index)`` alone, so a prefix of the paths,
or a shard of them, draws what the same paths draw in the whole run. This
module computes the same counter-based stream:

- :func:`threefry2x32`: the 20-round Threefry-2x32 block of
  ``jax/_src/prng.py`` (``_threefry2x32_lowering``), each 32-bit word held in
  an ``int64`` tensor (torch has no ``uint32`` arithmetic) and masked where
  its high bits would reach the low ones;
- :func:`seed_key`, :func:`fold_in` and the splits and uniforms of the
  partitionable threefry (``jax_threefry_partitionable``, on by default): a
  split of ``num`` keys hashes the counters ``(0, j)``, a scalar draw the
  counter ``(0, 0)``;
- :func:`binomial`: ``jax.random._binomial`` in float64 (the JAX package
  feeds it float64 when x64 is on): inversion by geometric waiting times where
  ``n q <= 10``, BTRS (transformed rejection) elsewhere, ``q = min(p, 1 - p)``.
  Each path's loop runs until that path accepts, as JAX's batched
  ``while_loop`` runs it; the rows still looping are compacted after every
  round, so a round costs what its live rows cost.

Every path reads only its own key, so a path's count does not depend on the
other paths of the call. Where ``q == 0`` (``p`` rounded to exactly 0 or 1)
JAX's inversion loop never ends; here such a row takes its limit, zero
successes of ``q``.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_COUNTERS: dict = {}
#: inversion rounds between the host's reads of whether any row still loops
_ROUNDS_PER_READ = 2


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of counter words ``(x0, x1)`` under key ``(k0,
    k1)``; every word is a uint32 value in an ``int64`` tensor or a Python
    int, and tensors broadcast. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    # x0 is masked once, at the end: an add carries only upward, so its low 32
    # bits are the word's, and its high bits (< 2^38 after 26 adds) reach x1
    # only through the xor, after which x1 is masked
    x0 = x0 + ks[0]
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = (((x1 << r) | (x1 >> (32 - r))) ^ x0) & _M32
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0 & _M32, x1


def seed_key(seed: int) -> tuple[int, int]:
    """``jax.random.key(seed)``'s words: the seed's high and low 32 bits."""
    return (seed >> 32) & _M32, seed & _M32


def fold_in(key, data):
    """``jax.random.fold_in``: the key ``threefry2x32(key, (0, data))``;
    ``data`` a Python int or an index tensor (one key per entry)."""
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _M32
        return threefry2x32(key[0], key[1], torch.zeros_like(data), data)
    return threefry2x32(key[0], key[1], 0, data & _M32)


def _hash_lanes(keys, counters):
    """One threefry pass over lanes: ``keys`` a list of ``(k0, k1)`` row
    tensors, ``counters`` the matching tuple of low counter words (the high
    word is 0). Returns the lanes' output words, each ``(n,)``."""
    k0 = torch.stack([k[0] for k in keys], dim=1)
    k1 = torch.stack([k[1] for k in keys], dim=1)
    ctr = _COUNTERS.get((counters, k0.device))
    if ctr is None:  # made once per device: a host-to-device copy syncs the card
        ctr = _COUNTERS[counters, k0.device] = torch.tensor(counters, device=k0.device)
    y0, y1 = threefry2x32(k0, k1, 0, ctr)
    return [(y0[:, j], y1[:, j]) for j in range(len(keys))]


def _uniform64(bits) -> torch.Tensor:
    """``jax.random.uniform(key, (), float64)`` from the key's hash of counter
    ``(0, 0)``: the top 52 of its 64 bits as the mantissa of ``[1, 2)``, less 1."""
    b0, b1 = bits
    return ((b0 << 20) | (b1 >> 12)).to(torch.float64) * 2.0 ** -52  # orp: noqa[ORP001] -- jax.random's float64 uniform is f64 by definition (exact thinning's words, bitwise JAX's)


def uniform64(k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, (), float64)`` of each row's key."""
    return _uniform64(threefry2x32(k0, k1, 0, 0))


def _stirling_tail(k: torch.Tensor) -> torch.Tensor:
    """``jax.random._stirling_approx_tail``: the table below 10, the series above."""
    table = torch.tensor(
        [0.0810614667953272, 0.0413406959554092, 0.0276779256849983, 0.02079067210376509,
         0.0166446911898211, 0.0138761288230707, 0.0118967099458917, 0.0104112652619720,
         0.00925546218271273, 0.00833056343336287], dtype=k.dtype, device=k.device)
    use_table = k <= 9
    k = torch.clamp(k, 0.0, 9.0)
    kp1sq = (k + 1) * (k + 1)
    approx = (1.0 / 12 - (1.0 / 360 - 1.0 / 1260 / kp1sq) / kp1sq) / (k + 1)
    return torch.where(use_table, table[torch.floor(k).to(torch.int64)], approx)


def _inversion(k0, k1, count, q):
    """Successes of ``Binomial(count, q)`` by summing geometric waiting times
    until they pass ``count`` (``jax.random._binomial_inversion``). Round
    ``j`` splits key ``j`` into ``(sub, key j+1)`` and draws a uniform from
    ``sub``; one threefry pass hashes round ``j``'s uniform and round
    ``j+1``'s split together. A row that has passed its count stops counting
    (as in JAX's batched loop); the live rows are compacted, and the host
    reads whether any is left, every :data:`_ROUNDS_PER_READ` rounds."""
    out = torch.empty_like(count)
    pos = torch.arange(count.shape[0], device=count.device)
    log1mq = torch.log1p(-q)
    num = torch.zeros_like(count)
    total = torch.zeros_like(count)
    sub, key = _hash_lanes([(k0, k1)] * 2, (0, 1))
    while True:
        for _ in range(_ROUNDS_PER_READ):
            live = total <= count
            bits, sub, key = _hash_lanes([sub, key, key], (0, 0, 1))
            step = torch.ceil(torch.log(_uniform64(bits)) / log1mq)
            num = torch.where(live, num + 1, num)
            total = torch.where(live, total + step, total)
        out.index_copy_(0, pos, num - 1)
        idx = (total <= count).nonzero().squeeze(1)
        if not idx.numel():
            return out
        count, log1mq, num, total, pos = (x.index_select(0, idx)
                                          for x in (count, log1mq, num, total, pos))
        sub, key = ((w[0].index_select(0, idx), w[1].index_select(0, idx)) for w in (sub, key))


def _btrs(k0, k1, count, q):
    """Successes of ``Binomial(count, q)`` by transformed rejection
    (``jax.random._btrs``, Hormann 1993), for ``count q > 10``."""
    out = torch.empty_like(count)
    pos = torch.arange(count.shape[0], device=count.device)
    stddev = torch.sqrt(count * q * (1 - q))
    b = 1.15 + 2.53 * stddev
    a = -0.0873 + 0.0248 * b + 0.01 * q
    c = count * q + 0.5
    v_r = 0.92 - 4.2 / b
    r = q / (1 - q)
    alpha = (2.83 + 5.1 / b) * stddev
    m = torch.floor((count + 1) * q)
    consts = [count, b, a, c, v_r, r, alpha, m]
    # round j's two uniforms and round j+1's three-way split share a pass
    key, sub_u, sub_v = _hash_lanes([(k0, k1)] * 3, (0, 1, 2))
    while pos.numel():
        count, b, a, c, v_r, r, alpha, m = consts
        bits_u, bits_v, key, sub_u, sub_v = _hash_lanes(
            [sub_u, sub_v, key, key, key], (0, 0, 0, 1, 2))
        u = _uniform64(bits_u) - 0.5
        v = _uniform64(bits_v)
        us = 0.5 - torch.abs(u)
        accept1 = (us >= 0.07) & (v <= v_r)
        k = torch.floor((2 * a / us + b) * u + c)
        reject = (k < 0) | (k > count)
        v = torch.log(v * alpha / (a / (us * us) + b))
        ub = ((m + 0.5) * torch.log((m + 1) / (r * (count - m + 1)))
              + (count + 1) * torch.log((count - m + 1) / (count - k + 1))
              + (k + 0.5) * torch.log(r * (count - k + 1) / (k + 1))
              + _stirling_tail(m) + _stirling_tail(count - m)
              - _stirling_tail(k) - _stirling_tail(count - k))
        accept = accept1 | (~reject & (v <= ub))
        out[pos[accept]] = k[accept]
        live = ~accept
        pos = pos[live]
        key, sub_u, sub_v = ((w[0][live], w[1][live]) for w in (key, sub_u, sub_v))
        consts = [x[live] for x in consts]
    return out


def binomial(k0: torch.Tensor, k1: torch.Tensor, count: torch.Tensor,
             prob: torch.Tensor) -> torch.Tensor:
    """``jax.random.binomial(key, count, prob)`` per row, in float64, with row
    ``i``'s key ``(k0[i], k1[i])``: ``jax.random._binomial``'s regimes and its
    NaN / inf rules. Returns float64 counts."""
    count, prob = count.to(torch.float64), prob.to(torch.float64)  # orp: noqa[ORP001] -- jax.random._binomial draws in f64 (exact thinning's counts, bitwise JAX's)
    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    count_nan_or_neg = torch.isnan(count) | (count < 0.0)
    count_inf = torch.isinf(count)
    q_is_nan = torch.isnan(q)
    q_l_0 = q < 0.0
    q = torch.where(q_is_nan | q_l_0, torch.full_like(q, 0.01), q)
    use_inversion = count_nan_or_neg | (count * q <= 10.0)
    count = torch.floor(count)
    invalid = q_l_0 | q_is_nan | count_nan_or_neg
    # rows whose count is fixed without a draw: no trials, no success chance,
    # or a NaN / inf result; the rest loop, each on its own key
    fixed = invalid | count_inf | (count == 0) | (q == 0)
    samples = torch.zeros_like(count)
    for rows, sampler in ((use_inversion & ~fixed, _inversion), (~use_inversion & ~fixed, _btrs)):
        idx = rows.nonzero().squeeze(1)
        if idx.numel():
            samples[idx] = sampler(k0[idx], k1[idx], count[idx], q[idx])
    samples = torch.where(invalid, torch.full_like(samples, float("nan")), samples)
    samples = torch.where(count_inf & ~invalid, torch.full_like(samples, float("inf")), samples)
    return torch.where(p_lt_half | count_nan_or_neg | q_is_nan | count_inf, samples,
                       count - samples)
