"""ms of one ``data.augment.augment_batch`` on the cell's batch, as the step
calls it, timed by CUDA events from the benchmark's own file."""


def read(ctx):
    return ctx.augment_ms() if ctx.cell.cfg.get("img_aug") else None
