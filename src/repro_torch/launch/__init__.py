"""Launch-side entry points of the port (counterpart of ``repro.launch``):
the serve step, captured as a CUDA graph on the card (``steps``), and the
service CLI (``serve``)."""
