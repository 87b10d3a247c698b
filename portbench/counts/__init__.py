"""Frozen yardsticks: matmul FLOPs of the live models, the bytes and FLOPs
of the attention kernels K1 and K2, and the published peaks of the card.

Copied from the port (``utils/flops.py``, ``chip_smoke.py``'s
``attention_bound`` and ``attention_bwd_bound``) so that a later change to
the program cannot move the yardstick it is measured by.
"""
