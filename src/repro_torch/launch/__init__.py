"""Launch-side entry points of the port (counterpart of ``repro.launch``):
the serve, prefill and train steps (``steps``; the serve and prefill steps
captured as CUDA graphs on the card), the service CLI (``serve``) and the
train CLI (``train``)."""
