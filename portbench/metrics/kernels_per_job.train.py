"""CUDA kernels a training job launches: kernels in the device trace of the
profiled jobs (copies and sets left out), per job."""


def read(ctx):
    k = ctx["trace"]["kernels"]
    return k / ctx["n_profiled"] if k else None
