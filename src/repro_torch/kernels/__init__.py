"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version (``ref.py``) and a wrapper (``ops.py``) that takes the plain version
for a CPU tensor and launches the kernel for a CUDA tensor."""
