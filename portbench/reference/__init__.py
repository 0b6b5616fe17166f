"""The plain PyTorch reference that decides ``correct``.

It imports nothing of the port and nothing of the JAX package: it reads
the benchmark's configuration file and the weights the benchmark made.
"""
