"""The plain float32 reference of the training step, in PyTorch alone: it
imports neither JAX nor anything of the port, and takes from the benchmark
only the inputs it also hands the program (weights made from the seed, the
batches and the step generators)."""
