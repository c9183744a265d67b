"""Share of the roofline of all aggregations together, in percent: the
least time the window's aggregations (every training step's forward and
backward ones and every refresh's, counted from the batches' real
entries by ``counts.py``) need on the card, over the device time the
profiler gives the aggregation kernels named here (the ``__global__``
functions of ``incagg_gnn_tpu_torch/csrc/*.cu`` that aggregate) (layer:
kernels)."""

#: the aggregation kernels, by the name the profiler gives them
KERNELS = (
    "block_spmm_kernel",
    "ell_spmm_vec_kernel", "ell_spmm_scalar_kernel",
    "ell_spmm_heads_vec_kernel", "ell_spmm_heads_scalar_kernel",
    "hybrid_max_vec_kernel", "hybrid_max_scalar_kernel",
    "hybrid_max_bwd_vec_kernel", "hybrid_max_bwd_scalar_kernel",
    "max_bwd_scale_kernel", "max_bwd_step_kernel",
    "ell_reduce_vec_kernel", "ell_reduce_scalar_kernel",
)


def kernel_seconds(op_s):
    return sum(s for name, s in op_s.items() if any(k in name for k in KERNELS))


def read(ctx):
    if ctx.trace is None or not ctx.peaks or ctx.agg_bound_s <= 0.0:
        return None
    t = kernel_seconds(ctx.trace.op_s)
    return 100.0 * ctx.agg_bound_s / t if t > 0.0 else None
