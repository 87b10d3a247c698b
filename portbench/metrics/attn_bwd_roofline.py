"""K2 (``flash_attention_qkv_bwd``) against its roofline: the frozen least
time of one call at the cell's (B, K, N, D), over K2's device time per call
in the profile (its kernels' time over the wrapper's launch counter)."""


def read(ctx):
    calls = ctx.counters.get("k2_calls", 0)
    seconds, kernels = ctx.profile.seconds_of("attn_bwd_")
    if not calls or not kernels:
        return None
    c = ctx.counts
    least, _ = c.least_seconds(c.k2_flops(*ctx.attention_shape), c.k2_bytes(*ctx.attention_shape),
                               ctx.peak_flops, ctx.peak_bytes_s)
    return 100.0 * least / (seconds / calls)
