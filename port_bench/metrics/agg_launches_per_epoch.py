"""Launches of the port's aggregation kernels an epoch: the difference of
``ops/kernels.py::launch_counts()`` over the window (a CUDA-graph replay
adds what it launches), all wrappers summed, over the window's epochs
(layer: kernels)."""


def read(ctx):
    if not ctx.n_epochs:
        return None
    return sum(ctx.launches.values()) / ctx.n_epochs
