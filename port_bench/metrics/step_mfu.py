"""The whole window's model operations over its wall seconds, as a share of
the card's published f32 rate outside the tensor cores, in percent
(layer: whole step).  Every GEMM counts ``2·rows·in·out``, its backward
twice that; every aggregation ``2·nnz·D`` each way; the refresh's forward
once; no recomputation; all from the real rows and entries of each batch
(``reference/<model>.py``'s ``step_work`` and ``refresh_work``)."""


def read(ctx):
    if not ctx.peaks or ctx.window_s <= 0.0 or ctx.flops <= 0.0:
        return None
    return 100.0 * ctx.flops / ctx.window_s / ctx.peaks["flops_per_s"]
