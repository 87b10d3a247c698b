"""The program's side of each model family: ``<family>.py``, found by the
name a configuration's ``family`` gives (``harness.family``).  Such a file
imports the port only inside its functions, so that importing the
benchmark loads nothing of it, and exposes:

* ``model_class()``: the port's ``nn.Module`` class, built as
  ``cls(config, device="meta", master_weights=True)`` and driven by the
  port's ``make_train_step``;
* ``forward_flops(cfg, batch)``: the frozen matmul FLOPs of a forward of
  ``batch`` samples (``counts/flops.py``); a training step counts 3×;
* ``attention_shape(cfg, batch)``: (B, K, N, D) of one K1/K2 call, or None
  where the family makes none;
* ``counters()``: name → int, the port's launch counters whose deltas over
  the profiled steps the metric readers take (``harness.Context.counters``).
"""


def flash_attention_counters() -> dict[str, int]:
    """K1's and K2's launch counters (``kernels/flash_attention.py``)."""
    from cross_attention_vit_tpu_torch.kernels import flash_attention as fa

    return {"k1_calls": fa.flash_attention_qkv.launches,
            "k2_calls": fa.flash_attention_qkv_bwd.launches}
