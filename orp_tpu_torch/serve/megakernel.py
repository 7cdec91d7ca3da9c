"""Mixed-date head forward: one kernel for a block whose rows sit at different dates.

Counterpart of ``orp_tpu/serve/megakernel.py::mixed_head_forward`` (the Pallas
``_head_kernel``) and its wrapper ``_eval_core_mixed``. Row ``r`` runs the
hedge MLP under the params of its own date ``dates[r]``: dots, bias adds and
LeakyReLU between layers, raw head outputs ``(B, n_outputs)``, in f32 or bf16.

- :func:`mixed_head_forward` is the wrapper: the CUDA kernel
  (``csrc/mixed_head.cu``: a persistent grid over row tiles, every date's
  params staged once per block in a padded shared layout, each tile's rows
  count-sorted by date so that a thread runs four rows of one date on one
  load of each weight; an f32 and a bf16 entry point) for CUDA tensors,
  :func:`mixed_head_plain` for CPU tensors. On the card it launches the kernel
  or raises; it never falls back.
- :func:`head_plan` is the kernel's launch plan, computed here so that the
  CPU tests reach it: the padded layout, the row tile, the date buckets and
  the shared-memory offsets.
- :func:`mixed_head_plain` is the JAX kernel's math in plain PyTorch: the
  full-block forward under each date's params, rows committed by date mask.
  In bf16 every operation rounds to bf16, as the JAX package's does: the dot
  reduces in f32 and rounds once, the bias add rounds, and the LeakyReLU
  multiplies by the slope rounded to bf16 and rounds.
- :func:`mixed_head_bf16_order` is the bf16 kernel's arithmetic in plain
  PyTorch, its f32 dot sums in the kernel's input order: the bf16 kernel
  equals it bitwise, where the plain version's matmul sums in an order of its
  own and may round a hidden unit apart.

The kernel takes layer counts up to ``MAX_LAYERS`` and every width (features,
hidden, outputs) up to ``MAX_WIDTH``, with all dates' params within
``MAX_SMEM_BYTES`` of shared memory at the params' element size; the wrapper
raises above those caps.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from orp_tpu_torch.serve.precision import dequantize_params, eval_model
from orp_tpu_torch.train.backward import _split_holdings
from orp_tpu_torch.utils import cuda_build
from orp_tpu_torch.utils.precision import typed_scalar

MAX_LAYERS = 4
MAX_WIDTH = 16
MAX_SMEM_BYTES = 232_448  # what one block may use on sm_90
TILE_ROWS = 2048  # the most rows a tile holds (kTile in csrc/mixed_head.cu)
_THREADS = 256    # threads a block (kThreads): also the most date buckets
_GROUP = 4        # the most rows a thread runs together (kMaxGroup)
#: ``head_plan``'s fields in the order of the kernel's ``struct Plan``; a
#: list-valued field takes ``MAX_LAYERS`` (``sizes``: ``MAX_LAYERS + 1``) ints
PLAN_FIELDS = ("n_layers", "sizes", "per_date", "src_off", "staged", "stride", "w_off", "ld",
               "b_off", "tile", "shift", "n_bins", "o_cnt", "o_perm", "o_dates", "o_feats",
               "o_out", "smem")
#: the dtypes the kernel computes in, and their C entry points
ENTRY = {torch.float32: "orp_mixed_head_launch", torch.bfloat16: "orp_mixed_head_bf16_launch"}


def _layer_sizes(model) -> tuple[int, ...]:
    return (model.n_features, *model.hidden, model.n_outputs)


def pack_head_params(model, params_by_date: dict) -> torch.Tensor:
    """``(D, P)`` in the params' dtype: per date ``w0`` (row-major ``(f0, h0)``),
    ``b0``, ``w1``, ..."""
    n_layers = len(model.hidden) + 1
    parts = []
    for i in range(n_layers):
        w, b = params_by_date[f"w{i}"], params_by_date[f"b{i}"]
        parts += [w.reshape(w.shape[0], -1), b]
    return torch.cat(parts, dim=1).contiguous()


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def head_plan(sizes: tuple[int, ...], n_dates: int, elem: int) -> dict:
    """The kernel's plan for a head of layer ``sizes`` over ``n_dates`` dates
    with ``elem``-byte params (4 f32, 2 bf16), within ``MAX_SMEM_BYTES``:

    - ``staged``: the params go to shared memory in a padded layout. Each
      layer's weight rows (``ld`` elements apart, from ``w_off``) and its bias
      (``b_off``) start on 16 bytes and hold whole 16-byte vectors; one date
      spans ``stride`` elements, an odd number of 16-byte chunks, so the same
      chunk of up to 8 dates falls on distinct banks. Where that layout and a
      32-row tile do not fit, the params stay in device memory at their
      packed layout (``stride = per_date``, ``ld`` = the layer's width);
    - ``tile``: the most rows (a multiple of 32, at most ``TILE_ROWS``) whose
      two date and feature buffers, sorted slots and outputs fit beside them;
    - the count sort's buckets: ``date >> shift`` for ``n_bins - 1 <= 255``
      buckets of dates, and a last one for dates outside ``[0, n_dates)``;
      each bucket is padded to a whole number of the kernel's row groups;
    - ``o_*``: the byte offsets of the counts, slots, dates, features and
      outputs in dynamic shared memory, and ``smem`` its bytes in all."""
    vec = 16 // elem
    n_layers = len(sizes) - 1
    pairs = list(zip(sizes[:-1], sizes[1:]))
    src_off, off = [], 0
    for fin, fout in pairs:
        src_off.append(off)
        off += fin * fout + fout
    per_date = off
    w_off, ld, b_off, off = [], [], [], 0
    for fin, fout in pairs:
        row = -(-fout // vec) * vec
        w_off.append(off)
        ld.append(row)
        b_off.append(off + fin * row)
        off += (fin + 1) * row
    stride = (off // vec | 1) * vec
    shift = 0
    while ((n_dates - 1) >> shift) + 2 > _THREADS:
        shift += 1

    def layout(tile: int, params_bytes: int) -> dict:
        o = {"o_cnt": params_bytes}
        o["o_perm"] = o["o_cnt"] + 4 * (_THREADS + _THREADS // 32)
        # sorted slots: a tile's rows and each bucket's padding to a group
        o["o_dates"] = _up16(o["o_perm"] + 2 * (tile + _THREADS * (_GROUP - 1)))
        o["o_feats"] = o["o_dates"] + 2 * 4 * tile
        o["o_out"] = o["o_feats"] + 2 * _up16(tile * sizes[0] * elem)
        o["smem"] = _up16(o["o_out"] + tile * sizes[-1] * elem)
        return o

    staged_bytes = n_dates * stride * elem
    staged = layout(32, staged_bytes)["smem"] <= MAX_SMEM_BYTES
    if not staged:
        stride = per_date
        w_off, ld = src_off, [fout for _, fout in pairs]
        b_off = [o + fin * fout for o, (fin, fout) in zip(src_off, pairs)]
    params_bytes = staged_bytes if staged else 0
    tile = TILE_ROWS
    while layout(tile, params_bytes)["smem"] > MAX_SMEM_BYTES:
        tile -= 32
    pad = [0] * (MAX_LAYERS - n_layers)
    return {"n_layers": n_layers, "sizes": list(sizes) + pad, "per_date": per_date,
            "src_off": src_off + pad, "staged": int(staged), "stride": stride,
            "w_off": w_off + pad, "ld": ld + pad, "b_off": b_off + pad, "tile": tile,
            "shift": shift, "n_bins": ((n_dates - 1) >> shift) + 2,
            **layout(tile, params_bytes)}


@functools.lru_cache(maxsize=64)
def _plan_ints(sizes: tuple[int, ...], n_dates: int, elem: int):
    """:func:`head_plan` as the C ``Plan``: its ints in ``PLAN_FIELDS`` order."""
    plan = head_plan(sizes, n_dates, elem)
    flat = []
    for name in PLAN_FIELDS:
        v = plan[name]
        flat += v if isinstance(v, list) else [v]
    return (ctypes.c_int * len(flat))(*flat)


def mixed_head_plain(model, params_by_date: dict, dates: torch.Tensor,
                     feats: torch.Tensor) -> torch.Tensor:
    """Per-date masked forward over the whole block (the Pallas kernel's math),
    in ``feats``' dtype. Rows whose date is outside ``[0, D)`` stay NaN, as in
    the CUDA kernel."""
    n_layers = len(model.hidden) + 1
    n_dates = int(params_by_date["w0"].shape[0])
    dates = dates.reshape(-1, 1)
    slope = typed_scalar(model.negative_slope, feats.dtype)
    out = torch.full((feats.shape[0], model.n_outputs), float("nan"), dtype=feats.dtype,
                     device=feats.device)
    for d in range(n_dates):
        x = feats
        for i in range(n_layers):
            x = x @ params_by_date[f"w{i}"][d] + params_by_date[f"b{i}"][d]
            if i < n_layers - 1:
                x = torch.where(x >= 0, x, slope * x)
        out = torch.where(dates == d, x, out)
    return out


def mixed_head_bf16_order(model, params_by_date: dict, dates: torch.Tensor,
                          feats: torch.Tensor) -> torch.Tensor:
    """The bf16 kernel's arithmetic (``csrc/mixed_head.cu``) in plain PyTorch:
    each dot the f32 sum of its exact products in input order, rounded to
    bf16; the bias added in f32 and rounded; a negative hidden value times the
    slope rounded to bf16, rounded. ``dates`` in ``[0, D)``; bf16 params and
    features; a bf16 ``(B, n_outputs)`` result."""
    bf = torch.bfloat16
    slope = typed_scalar(model.negative_slope, bf).float()
    n_layers = len(model.hidden) + 1
    d = dates.reshape(-1).long()
    x = feats.float()
    for i in range(n_layers):
        w = params_by_date[f"w{i}"].float()[d]
        acc = torch.zeros(x.shape[0], w.shape[2], dtype=w.dtype, device=x.device)
        for k in range(x.shape[1]):
            acc = acc + x[:, k:k + 1] * w[:, k, :]
        z = (acc.to(bf).float() + params_by_date[f"b{i}"].float()[d]).to(bf).float()
        x = torch.where(z >= 0, z, (slope * z).to(bf).float()) if i < n_layers - 1 else z
    return x.to(bf)


def _kernel(lib: ctypes.CDLL, dtype: torch.dtype):
    """The C entry point computing in ``dtype``."""
    fn = getattr(lib, ENTRY[dtype])
    # the slope: an f32 value, or a bf16 bit pattern in an unsigned short
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                   ctypes.c_int,
                   ctypes.c_float if dtype == torch.float32 else ctypes.c_ushort,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def check_head_shape(model, n_dates: int, dtype: torch.dtype = torch.float32) -> None:
    """Raise when ``model`` over ``n_dates`` dates, with params of ``dtype``,
    exceeds the kernel's caps."""
    sizes = _layer_sizes(model)
    if len(sizes) - 1 > MAX_LAYERS or max(sizes) > MAX_WIDTH:
        raise ValueError(
            f"mixed_head kernel takes at most {MAX_LAYERS} layers of width <= "
            f"{MAX_WIDTH}; model has layer sizes {sizes}")
    smem = torch.empty((), dtype=dtype).element_size() * n_dates * model.n_params()
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"mixed_head kernel stages all {n_dates} dates' params in shared memory: "
            f"{smem} bytes exceed {MAX_SMEM_BYTES}")


def mixed_head_forward(model, params_by_date: dict, dates: torch.Tensor,
                       feats: torch.Tensor, *, packed: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """Raw head outputs ``(B, n_outputs)`` where row ``r`` uses date ``dates[r]``'s params.

    ``dates``: int32 ``(B,)`` (or ``(B, 1)``) in ``[0, D)``; ``feats``: f32 or
    bf16 ``(B, n_features)``; ``params_by_date``: ``{w{i}: (D, f_i, h_i), b{i}:
    (D, h_i)}`` of the same dtype, on the same device. The output has
    ``feats``' dtype. ``packed`` is ``pack_head_params``'s result, for callers
    that keep it across calls. A date outside ``[0, D)`` yields NaN rows on the
    card (the engine validates dates on the host). Each launch adds one to
    ``mixed_head_forward.launches`` (f32) or ``.launches_bf16``."""
    dates = dates.reshape(-1)
    if feats.device.type == "cpu":
        return mixed_head_plain(model, params_by_date, dates, feats)
    if feats.device.type != "cuda":
        raise ValueError(f"mixed_head_forward runs on cuda or cpu, not {feats.device}")
    dt = feats.dtype
    if dt not in ENTRY:
        raise ValueError(f"mixed_head kernel computes in {sorted(map(str, ENTRY))}, "
                         f"not {dt}")
    n, f = feats.shape
    n_dates = int(params_by_date["w0"].shape[0])
    check_head_shape(model, n_dates, dt)
    if packed is None:
        packed = pack_head_params(model, params_by_date)
    if f != model.n_features or dates.shape[0] != n:
        raise ValueError(f"feats {tuple(feats.shape)} / dates {tuple(dates.shape)} do "
                         f"not match {model.n_features} features, one date per row")
    for name, t, want in (("dates", dates, torch.int32), ("feats", feats, dt),
                          ("params", packed, dt)):
        if t.device != feats.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {want} tensor on {feats.device}; "
                             f"got {t.dtype} on {t.device}")
    if packed.shape != (n_dates, model.n_params()):
        raise ValueError(f"packed params {tuple(packed.shape)} != "
                         f"{(n_dates, model.n_params())}")
    out = torch.empty((n, model.n_outputs), dtype=dt, device=feats.device)
    if n == 0:
        return out
    plan = _plan_ints(_layer_sizes(model), n_dates, packed.element_size())
    slope = typed_scalar(model.negative_slope, dt)
    slope = float(slope) if dt == torch.float32 else int(slope.view(torch.int16)) & 0xFFFF
    lib = cuda_build.load("mixed_head")
    with torch.cuda.device(feats.device):
        rc = _kernel(lib, dt)(dates.data_ptr(), feats.data_ptr(), packed.data_ptr(),
                              out.data_ptr(), n, n_dates, plan, len(plan), slope,
                              torch.cuda.current_stream(feats.device).cuda_stream)
    cuda_build.check(lib, rc, "mixed_head")
    if dt == torch.float32:
        mixed_head_forward.launches += 1
    else:
        mixed_head_forward.launches_bf16 += 1
    return out


#: launches of the f32 kernel and of the bf16 kernel
mixed_head_forward.launches = 0
mixed_head_forward.launches_bf16 = 0


def _constrain(model, x: torch.Tensor) -> torch.Tensor:
    """``HedgeMLP.holdings``' head tail on the kernel's raw outputs."""
    if model.constrain_self_financing:
        phi = x[..., 0]
        return torch.stack([phi, 1.0 - phi], dim=-1)
    return x


def serve_outputs(model, raw1, raw2, prices, cost_of_capital, *, dual_mode,
                  holdings_combine):
    """``(phi, psi, v)`` from the raw head outputs under param sets 1 and 2
    (``raw2`` unread in ``mse_only``), in the serve API's dtype: f32, or f64
    for an f64 model.

    The serve-side combines of ``train/backward._date_outputs_core``
    (``prices_t1 = 0``, so only value and holdings survive; ``shared``: ``v =
    g + i (h - g)`` with ``g`` the params1 value, holdings from params2). In
    f32 and f64 these are its operations in its order, bit for bit. In bf16
    they round as the JAX package's compiled program does: every operation
    rounds to bf16, except where XLA computes a bf16 operation whose result is
    only widened to f32 in f32 (its excess-precision rule):

    - a value sums its products in f32 (``jnp.sum`` widens them, so they are
      exact) and rounds once;
    - the last operation of an output is not rounded: the dual modes' value
      add, and the constrained head's served ``psi = 1 - phi`` (the ``psi``
      inside a value or a ``separate`` combine is rounded)."""
    out = torch.promote_types(model.dtype, torch.float32)
    coc = typed_scalar(cost_of_capital, model.dtype)
    p = prices.to(model.dtype).to(out)

    def value(h):
        return torch.sum(h.to(out) * p, dim=-1).to(model.dtype)

    def served(raw):
        if model.constrain_self_financing:
            phi = raw[..., 0].to(out)
            return phi, 1.0 - phi
        return _split_holdings(raw.to(out))

    h1 = _constrain(model, raw1)
    if dual_mode == "mse_only":
        return (*served(raw1), value(h1).to(out))
    h2 = _constrain(model, raw2)
    g, h = value(h1), value(h2)
    v = g.to(out) + (coc * (h - g)).to(out)
    if dual_mode == "shared":
        return (*served(raw2), v)
    comb = h1 + coc * (h1 - h2) if holdings_combine == "py" else h1 + coc * (h2 - h1)
    return (*_split_holdings(comb.to(out)), v)


def _eval_core_mixed(model, p1_all, p2_all, dates, feats, prices, cost_of_capital, *,
                     dual_mode, holdings_combine, precision="f32", packed1=None,
                     packed2=None):
    """The mixed-date twin of ``engine._eval_core``: per-ROW date indices, the
    head through the kernel, :func:`serve_outputs` after it. The tiers as
    there: int8 dequantizes both param sets before the f32 kernel, bf16 runs
    the bf16 model and kernel on bf16 rows."""
    if precision == "int8":
        p1_all = dequantize_params(p1_all)
        p2_all = dequantize_params(p2_all)
    m = eval_model(model, precision)
    feats = feats.to(m.dtype)
    raw1 = mixed_head_forward(m, p1_all, dates, feats, packed=packed1)
    raw2 = (raw1 if dual_mode == "mse_only"
            else mixed_head_forward(m, p2_all, dates, feats, packed=packed2))
    return serve_outputs(m, raw1, raw2, prices, cost_of_capital, dual_mode=dual_mode,
                         holdings_combine=holdings_combine)


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
