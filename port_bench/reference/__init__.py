"""The plain PyTorch reference that decides ``correct``: it imports neither
JAX nor the JAX package nor anything of the port, and takes only the
weights and inputs the benchmark made."""
