"""The 95th percentile of a revaluation's wall, over the traced run's jobs
the profiler did not cover."""

import numpy as np


def read(ctx):
    t = ctx["job_times"]
    return float(np.percentile(t, 95)) if len(t) >= 2 else None
