"""The pooling-attention backward kernels against their roofline: the
frozen least time (``counts/mvit.py``) of the profiled steps' backward
calls, each at the larger of its operation and byte times, at the shapes
``pool_attention_calls`` gives and the count the launch counter gives,
over the device time of the kernels named ``mvit_attention_bwd`` (dq with
the bias terms' gradient, and dk/dv)."""

from portbench.counts import mvit


def read(ctx):
    calls = ctx.counters.get("pool_attention_bwd_calls", 0)
    seconds, kernels = ctx.profile.seconds_of("mvit_attention_bwd")
    if not calls or not kernels:
        return None
    shapes = mvit.pool_attention_calls(ctx.cell.cfg, ctx.cell.batch)
    least = sum(ctx.counts.least_seconds(mvit.bwd_flops(*s), mvit.bwd_bytes(*s), ctx.peak_flops,
                                         ctx.peak_bytes_s)[0] for s in shapes)
    return 100.0 * least * calls / len(shapes) / seconds
