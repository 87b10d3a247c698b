"""The reference's side of each model family: ``<family>.py``, found by the
name a configuration's ``family`` gives (``harness.family``).  Such a file
imports nothing of the port and no JAX, and exposes:

* ``shapes(cfg)``: the ordered name → shape of every weight; the weights
  are drawn from the seed in that order (``inputs.make_weights``);
* ``logits(w, cfg, img, masks, q)``: the plain float32 forward of a block of
  rows, drawing dropout's keep masks through ``masks`` in the port's order
  and rounding every product's operands with ``q``;
* optionally ``weight_kind(name, shape)``, how a leaf is initialised
  (``inputs.weight_kind``'s kinds), in place of ``inputs.weight_kind``.
"""
