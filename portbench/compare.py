"""The numbers that decide ``correct``, each against its limit.

* ``loss_gap``: |program − reference| of the first step's loss (nats).  The
  later checked steps' losses drift apart chaotically (a random start at
  lr 1e-4 moves the loss from 0.7 to 1-5 in two steps, and a rounding
  difference grows with it), so they are logged and not compared.
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as Adam took it, program against reference, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
  over a mesh, the worst over every data coordinate's optimizer.
* ``update_gap``: the same for the norm of each leaf's change over the
  checked steps, on the leaves whose reference gradient is at least
  ``MOVED`` of the median leaf's: a leaf below that (the cross-attention key
  bias, whose gradient the softmax cancels) moves under Adam by rounding
  alone, in the program and the reference alike.
* ``grad_diff``: the median over leaves of ‖g − g_ref‖ / ‖g_ref‖, g the
  first gradient as Adam took it (data coordinate 0's).  A gap of norms
  hides rounding errors of random sign, so a lower precision barely moves
  the three numbers above at full size; the median leaf's relative
  difference is steady from seed to seed and does move.
"""

from __future__ import annotations

import statistics

MOVED = 1e-3


def _worst(got: dict, want: dict, leaves) -> tuple[float, str]:
    leaves = list(leaves)
    median = statistics.median(want[k] for k in leaves)
    gaps = {k: abs(got[k] - want[k]) / max(want[k], median, 1e-30) for k in leaves}
    worst = max(gaps, key=gaps.get)
    return gaps[worst], worst


def moved_leaves(ref_grads: dict) -> list[str]:
    median = statistics.median(ref_grads.values())
    return [k for k, v in ref_grads.items() if v >= MOVED * median]


def checks(losses: list[float], coordinates: list[dict], ref: dict, limits: dict) -> dict:
    """{name: {"value", "limit", "leaf"?}} from the program's checked
    readings (``losses`` as the step reported them; ``coordinates`` one
    dict of norms per data coordinate) and the reference's."""
    loss_gap = abs(losses[0] - ref["losses"][0])
    grad = [_worst(c["grad_norms"], ref["grad_norms"], ref["grad_norms"]) for c in coordinates]
    grad_gap, grad_leaf = max(grad)
    update_gap, update_leaf = _worst(coordinates[0]["change_norms"], ref["change_norms"],
                                     moved_leaves(ref["grad_norms"]))
    got = coordinates[0]["grads"]
    grad_diff = statistics.median(float((got[k].float() - g).norm() / g.norm().clamp(min=1e-30))
                                  for k, g in ref["grads"].items())
    return {"loss_gap": {"value": loss_gap, "limit": limits["loss_gap"],
                         "steps": [a - b for a, b in zip(losses, ref["losses"], strict=True)]},
            "grad_gap": {"value": grad_gap, "limit": limits["grad_gap"], "leaf": grad_leaf},
            "update_gap": {"value": update_gap, "limit": limits["update_gap"],
                           "leaf": update_leaf},
            "grad_diff": {"value": grad_diff, "limit": limits["grad_diff"]}}
