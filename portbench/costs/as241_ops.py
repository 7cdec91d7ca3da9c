"""f32 operations of one AS241 inverse-normal draw: the central branch's 33 on
the 85% of uniforms with ``|u - 0.5| <= 0.425``, the tail's 37 on the rest.
Frozen copy of ``chip_smoke.py:495``."""

AS241_OPS = 0.85 * 33 + 0.15 * 37
