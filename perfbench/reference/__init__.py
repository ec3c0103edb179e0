"""The plain reference the benchmark judges the port by: the SIFT-shaped
data makers and exact nearest neighbours in plain PyTorch. It imports
neither JAX nor ``repro`` nor ``repro_torch``."""
