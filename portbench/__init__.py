"""The benchmark of the PyTorch and CUDA port (``cross_attention_vit_tpu_torch``).

Run a cell as ``python3 -m portbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` from the repository root; see README.md.
Nothing here imports JAX or the JAX package.
"""
