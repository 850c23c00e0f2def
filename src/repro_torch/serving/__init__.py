"""Serving data plane of the port (counterpart of the live example
``examples/serve_llm.py``)."""
