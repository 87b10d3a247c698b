"""Faults planted underneath the timed path, for the tests that see
``correct`` come out false (``python3 -m portbench.run ... --fault <name>``
applies one in every rank).

* ``unchanged``: the optimizer step does nothing, so the step returns the
  state it was given;
* ``half_batch``: the step trains on the first half of its rows, the mean
  taken over them;
* ``no_exchange``: data-parallel ranks never all-reduce their gradients.
"""

from __future__ import annotations


def apply(name: str):
    """Plant the fault; returns a function that takes it out again."""
    from cross_attention_vit_tpu_torch.train import optim, trainer

    saved = optim.Adam.step, trainer.make_train_step, trainer.no_sync

    def undo() -> None:
        optim.Adam.step, trainer.make_train_step, trainer.no_sync = saved

    if name == "unchanged":
        optim.Adam.step = lambda self, lr: None
    elif name == "half_batch":
        make = trainer.make_train_step

        def make_half(*args, **kwargs):
            step = make(*args, **kwargs)

            def half(img, labels, lr, generator):
                n = img.shape[0] // 2
                return step(img[:n], labels[:n], lr, generator)
            return half
        trainer.make_train_step = make_half
    elif name == "no_exchange":
        real = trainer.no_sync
        trainer.no_sync = lambda model, skip: real(model, True)
    else:
        raise ValueError(f"unknown fault {name!r}")
    return undo
