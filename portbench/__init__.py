"""The benchmark of the PyTorch and CUDA port (``repro_torch``): live serving
cells driven by ``run.py``, their configurations, traffic mixes, per-layer
metric readers and plain references."""
