"""Launch-side steps of the port (counterpart of ``repro.launch``): so far
the serve step, captured as a CUDA graph on the card (``steps``)."""
