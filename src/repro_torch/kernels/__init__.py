"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

``ops`` holds the model-layout wrappers that dispatch by device and count
launches; ``build`` compiles ``csrc/*.cu`` with ``nvcc`` on first use.
"""
