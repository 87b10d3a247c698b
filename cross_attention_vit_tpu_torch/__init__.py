"""cross_attention_vit_tpu_torch — the PyTorch/CUDA port of
``cross_attention_vit_tpu`` for NVIDIA Hopper (H100, sm_90a).

The JAX package stays the reference; this package keeps its module names so
each port module has an obvious counterpart.  It imports ``torch`` and numpy,
never ``jax`` and nothing of ``cross_attention_vit_tpu``.

Layout:
    configs/   Config / Params presets and the overlay merge
    utils/     device resolution (CUDA unless the caller asks for the CPU)
    ops/       patchify, layers, attention, losses, initializers
    kernels/   hand-written CUDA kernels (csrc/), their build and wrappers
    models/    ModelCross (nn.Module) and the JAX ⇄ port weight mapping
    train/     numpy-only checkpoint reading and writing
    data/      NIfTI-1 reader/writer and MONAI-exact pad/crop
    drivers/   the micro-batching inference server
"""

__version__ = "0.1.0"
