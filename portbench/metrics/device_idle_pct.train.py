"""Share of the profiled training jobs' wall with no kernel, copy or set on
the card."""

from portbench.metrics._common import idle_pct


def read(ctx):
    return idle_pct(ctx)
