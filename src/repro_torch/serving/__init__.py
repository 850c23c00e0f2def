"""Serving data plane of the port: the live fleet (``live``, counterpart of
the example ``examples/serve_llm.py``), the simulated request path (the
vectorized engine ``engine``, the legacy ``sim.ServingSimulator`` with its
replicas and balancers, the token-level model ``token``) and the scenario
engine (``torchengine``)."""
