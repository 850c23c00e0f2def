"""The SkyServe scenario engine, phase A on the host and phase B on the card
(counterpart of ``repro.serving.jaxengine``).

A scenario matrix crosses policies, spot traces, seeds and traffic tapes.
Each cell's control plane (phase A: cluster simulator, policy, autoscaler,
``engine.TorchServingEngine.record_schedule``) runs once on the host and
records a ``schedule.CellSchedule``; its request-level data plane (phase B)
replays that schedule.  ``engine.run_cells`` runs both: the cells that share
a shape signature run as one launch of the CUDA kernel ``scenario_scan``
(``kernel.run_group``), or through its plain PyTorch version on the CPU
(``repro_torch.kernels.scenario_scan.plain``), and a lane whose queue pool
overflowed reruns on the port's NumPy oracle
(``repro_torch.serving.engine.VectorizedServingEngine``).  ``recorded``
builds the reference benchmark's matrix from its spec and keeps the
reference's recording it is held against.
"""
