"""A kernel's least time on the card. Frozen copy of ``chip_smoke.py:498``."""

from portbench.costs.peaks import F32_FLOP_PER_S, HBM_BYTES_PER_S, INT32_OP_PER_S


def bound(bytes_: float, int_ops: float, f32_ops: float) -> tuple[float, str]:
    """``(ms, what bounds it)``: the larger of the bytes over the bandwidth and
    the operations over their peak."""
    t_bytes = bytes_ / HBM_BYTES_PER_S * 1e3
    t_ops = max(int_ops / INT32_OP_PER_S, f32_ops / F32_FLOP_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
