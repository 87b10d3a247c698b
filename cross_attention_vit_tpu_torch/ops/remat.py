"""Rematerialisation: ``config.remat`` and ``config.remat_policy``.

The JAX package wraps each ModelCross self-block and each ModelVIT layer in
``jax.checkpoint`` under a save-names policy (JAX ``ops/layers.py:73-94``,
``models/model_cross.py:236-248``, ``models/model_vit.py:148-166``).  The
port wraps the same blocks in ``torch.utils.checkpoint.checkpoint``
(non-reentrant) through ``checkpoint`` below: the forward keeps only the
block's input and the tensors the policy names, and the backward runs the
block again to rebuild the rest.

Policies (``REMAT_SAVE_NAMES``, JAX's table): ``save_attn`` (the default)
keeps ``attn_out``; ``save_attn_masks`` adds ``dropout_mask``;
``save_attn_masks_ffn`` adds ``ffn_hidden``; ``save_attn_masks_ffn_qkv``
adds ``qkv``.  ``full``, None or any other name keeps nothing
(``_REMAT_SAVE_NAMES.get`` in JAX).  What each name keeps and spares:

* ``attn_out`` — the attention's output with K1's row statistics (K7's
  logsumexp above N = 1040), kept inside the kernel's autograd Function
  (``kernels.flash_attention.fused_qkv_attention``'s ``keep``): the
  recompute hands them to K2 and launches no K1.  On the plain and ring
  paths it keeps the output only: their backward needs the probabilities,
  so the recompute runs the attention anyway.
* ``dropout_mask`` — every keep mask the block draws (dropout and the row
  stochastic depth, which draw from the same generator): the recompute
  draws none.
* ``ffn_hidden`` — fc2's input, the post-dropout GELU output.  GELU's
  backward reads fc1's output, so the recompute still runs fc1 and GELU
  (JAX's own comment, its ``ops/layers.py:66-69``, finds the same).
* ``qkv`` — the QKV projection: on the flash path kept inside the same
  Function, so the recompute skips the projection GEMM (JAX's fused path
  has no such name, its ``ops/attention.py:127-129``).

Random bits.  The port draws dropout and stochastic depth from an explicit
``torch.Generator``; ``checkpoint``'s own ``preserve_rng_state`` covers only
the default generators.  So ``checkpoint`` snapshots the block's generator
at entry, and the recompute draws from that snapshot and puts the generator
back where the forward left it: the masks and the generator's state after
the step equal a step without remat (JAX passes each block an explicit
key).  A recompute also must not record twice what the forward records
once (the MoE balance terms): ``replaying()`` says when a block runs again.

Region.  Only the tensors a call of ``kept`` / ``kept_value`` names are
kept, and only inside a block that ``checkpoint`` runs; elsewhere both are
the identity.
"""

from __future__ import annotations

import collections
import contextvars

import torch
import torch.utils.checkpoint

REMAT_SAVE_NAMES = {
    "save_attn": ("attn_out",),
    "save_attn_masks": ("attn_out", "dropout_mask"),
    "save_attn_masks_ffn": ("attn_out", "dropout_mask", "ffn_hidden"),
    "save_attn_masks_ffn_qkv": ("attn_out", "dropout_mask", "ffn_hidden", "qkv"),
}


def remat_names(config) -> tuple[str, ...] | None:
    """The names a config's remat keeps: None when ``config.remat`` is off,
    () for a full recompute (``remat_policy`` 'full', None or unknown)."""
    if not config.get("remat", False):
        return None
    return REMAT_SAVE_NAMES.get(config.get("remat_policy", "save_attn"), ())


class _Tape:
    """The named tensors of one block call, kept by its forward for its
    recompute, each name's in call order."""

    def __init__(self, names: tuple[str, ...]):
        self.names = frozenset(names)
        self.kept: dict[tuple[str, int], object] = {}
        self.calls = 0
        self.seen: collections.Counter = collections.Counter()

    @property
    def replay(self) -> bool:
        return self.calls > 1

    def slot(self, name: str) -> tuple[str, int] | None:
        if name not in self.names:
            return None
        key = (name, self.seen[name])
        self.seen[name] += 1
        return key


_TAPE: contextvars.ContextVar[_Tape | None] = contextvars.ContextVar("remat_tape", default=None)


def kept(name: str, compute):
    """``compute()``; inside a block whose policy names ``name``, the forward
    keeps the result and the recompute returns it without calling
    ``compute``.  Only for work that records nothing for autograd: a draw,
    or the body of an autograd Function's forward."""
    tape = _TAPE.get()
    key = None if tape is None else tape.slot(name)
    if key is None:
        return compute()
    if tape.replay:
        return tape.kept[key]
    value = compute()
    tape.kept[key] = value
    return value


def kept_value(name: str, value: torch.Tensor) -> torch.Tensor:
    """``value``; inside a block whose policy names ``name``, the forward
    keeps it and the recompute hands the kept tensor on in place of the one
    it rebuilt (for a tensor whose own backward needs what made it)."""
    tape = _TAPE.get()
    key = None if tape is None else tape.slot(name)
    if key is None:
        return value
    if tape.replay:     # as the rebuilt one enters autograd, so both save alike
        return tape.kept[key].detach().requires_grad_(value.requires_grad)
    tape.kept[key] = value.detach()
    return value


def replaying() -> bool:
    """Whether the current block call is a recompute."""
    tape = _TAPE.get()
    return tape is not None and tape.replay


def checkpoint(fn, names: tuple[str, ...] | None, generator: torch.Generator | None, *args):
    """``fn(*args)``, under a remat policy's ``names`` (``remat_names``) when
    that is not None and a backward can follow: ``torch.utils.checkpoint``
    without reentry.  The recompute runs in the context the forward ran in
    (``ops.layers.dropout_bits`` among it), its draws replayed from
    ``generator``'s state at entry, and leaves ``generator`` where the
    forward left it."""
    if names is None or not torch.is_grad_enabled():
        return fn(*args)
    tape = _Tape(names)
    start = None if generator is None else generator.get_state()
    context = contextvars.copy_context()    # the forward's scope: the mask width among it

    def body(*inputs):
        tape.calls += 1
        tape.seen.clear()
        _TAPE.set(tape)
        if not tape.replay or generator is None:
            return fn(*inputs)
        after = generator.get_state()
        generator.set_state(start)
        try:
            return fn(*inputs)
        finally:
            generator.set_state(after)

    return torch.utils.checkpoint.checkpoint(lambda *inputs: context.run(body, *inputs), *args,
                                             use_reentrant=False, preserve_rng_state=False)
