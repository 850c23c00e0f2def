"""The SkyServe scenario engine's data plane on the card (counterpart of
``repro.serving.jaxengine``'s phase B).

A scenario matrix crosses policies, spot traces, seeds and traffic tapes;
each cell replays the request-level data plane over a control-plane
schedule (``schedule.CellSchedule``).  ``engine.run_schedules`` groups the
cells that share a shape signature and runs each group as one launch of the
CUDA kernel ``scenario_scan`` (``kernel.run_group``), or through its plain
PyTorch version on the CPU (``repro_torch.kernels.scenario_scan.plain``).
The control plane (phase A) is not ported yet: schedules come from the
reference (``repro_torch.convert``) or from the committed recording of the
reference benchmark's matrix (``recorded``).
"""
