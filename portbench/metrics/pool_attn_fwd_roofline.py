"""The pooling-attention forward kernel against its roofline: the frozen
least time (``counts/mvit.py``) of the profiled steps' calls, each at the
larger of its operation and byte times, at the shapes
``pool_attention_calls`` gives and the count the launch counter gives,
over the device time of the kernels named ``mvit_attention_fwd``."""

from portbench.counts import mvit


def read(ctx):
    calls = ctx.counters.get("pool_attention_fwd_calls", 0)
    seconds, kernels = ctx.profile.seconds_of("mvit_attention_fwd")
    if not calls or not kernels:
        return None
    shapes = mvit.pool_attention_calls(ctx.cell.cfg, ctx.cell.batch)
    least = sum(ctx.counts.least_seconds(mvit.fwd_flops(*s), mvit.fwd_bytes(*s), ctx.peak_flops,
                                         ctx.peak_bytes_s)[0] for s in shapes)
    return 100.0 * least * calls / len(shapes) / seconds
