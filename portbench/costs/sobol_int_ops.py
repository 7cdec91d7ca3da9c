"""int32 work of scrambled Sobol words. Frozen copy of ``chip_smoke.py:480``."""


def sobol_int_ops(n_paths: int, n_dims: int) -> int:
    """int32 operations of ``n_dims`` scrambled Sobol words per path, each word
    split by XOR linearity over a warp of 32 consecutive indices: per warp and
    dimension, one op per set index bit 5-31 (the popcount of the warp's number)
    and the scramble key ``hash_combine(seed, dim)`` (12) once; per path, one
    XOR for its lane bits (the warp's 32 words in Gray-code order), then two bit
    reversals, the Laine-Karras hash (add + 4 mul/xor) and the bucket shift
    (12)."""
    n_warps = -(-n_paths // 32)
    warp_ops = sum(bin(w).count("1") + 12 for w in range(n_warps))
    return n_dims * (warp_ops + 13 * n_paths)
