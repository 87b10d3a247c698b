"""Adam with torch.optim.Adam semantics — L2 weight decay added to the
gradient before the moments, not AdamW — port of
``cross_attention_vit_tpu/train/optim.py``:

    g   = g + wd · p
    m   = b1·m + (1 − b1)·g           v = b2·v + (1 − b2)·g²
    p  -= lr · (m / (1 − b1^t)) / (sqrt(v / (1 − b2^t)) + eps)

State and math are float32; the learning rate is a step-time argument (the
epoch-stepped cosine schedule, ``schedule.py``).  The JAX update was plain
XLA, so the port runs torch's own fused Adam: one pass over parameters,
gradients and moments, updated in place (torch divides √v by √(1 − b2^t)
where JAX takes √(v / (1 − b2^t)): the same update up to rounding).

Under FSDP (``parallel.shard_params(..., fsdp=True)``) the sharded
parameters are DTensors and their moments are sharded the same way: the
fused update runs on each rank's shards, in a parameter group of its own
(one fused call takes DTensors or plain tensors, not both).  ``moments``
then gathers whole tensors and ``load_state`` keeps each rank's shard.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, distribute_tensor

from ..parallel.sharding import full_tensor


class Adam:
    """Adam over a fixed list of float32 parameters; ``step(lr)`` consumes
    their ``.grad``."""

    def __init__(self, params, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.params = list(params)
        for p in self.params:
            if p.dtype != torch.float32:
                raise TypeError(f"Adam keeps float32 master parameters, got {p.dtype}: build "
                                "the model with master_weights=True")
        groups = [[p for p in self.params if isinstance(p, DTensor)],
                  [p for p in self.params if not isinstance(p, DTensor)]]
        self._opt = torch.optim.Adam([{"params": g} for g in groups if g], lr=0.0,
                                     betas=(b1, b2), eps=eps, weight_decay=weight_decay,
                                     fused=True)

    @torch.no_grad()
    def step(self, lr: float) -> None:
        """One update at learning rate ``lr`` from the parameters' gradients."""
        for group in self._opt.param_groups:
            group["lr"] = lr
        self._opt.step()

    @property
    def step_count(self) -> int:
        return int(self._opt.state[self.params[0]]["step"]) if self._opt.state else 0

    def moments(self) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        """(first moments, second moments), one whole tensor per parameter,
        in order (under FSDP a collective: every rank calls it)."""
        st = self._opt.state
        return ([full_tensor(st[p]["exp_avg"]) for p in self.params],
                [full_tensor(st[p]["exp_avg_sq"]) for p in self.params])

    @torch.no_grad()
    def load_state(self, step: int, exp_avgs, exp_avg_sqs) -> None:
        """Set the update count and both moments, one of each per parameter
        in order (a resumed run; whole tensors or arrays of the parameters'
        shapes, of which a sharded parameter keeps this rank's shard)."""
        def like(p, t):
            t = torch.as_tensor(t, dtype=torch.float32).to(p.device).clone()
            if isinstance(p, DTensor):
                return distribute_tensor(t, p.device_mesh, p.placements, src_data_rank=None)
            return t

        for p, m, v in zip(self.params, exp_avgs, exp_avg_sqs, strict=True):
            self._opt.state[p] = {
                # the fused update keeps its step as an f32 tensor on the device
                "step": torch.tensor(float(step), dtype=torch.float32, device=p.device),
                "exp_avg": like(p, m), "exp_avg_sq": like(p, v)}
