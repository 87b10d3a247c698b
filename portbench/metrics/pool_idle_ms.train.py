"""Device-idle ms a step between operations inside the model's
``mvit:pool_attention`` spans (each block's pooling attention, from the
qkv Linear to the skip path's max-pool), read by ``portbench/spans.py``.
Nothing where the stretch holds no such span."""

from portbench import spans

SPAN = "mvit:pool_attention"


def read(ctx):
    if not spans.count(ctx.profile, SPAN):
        return None
    return 1e3 * spans.idle_s(ctx.profile, (SPAN,)) / ctx.profile.steps
