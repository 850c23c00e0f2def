"""Launch-side entry points of the port (counterpart of ``repro.launch``):
the serve, prefill and train steps and the mesh-aware ``build_step`` /
``input_specs`` (``steps``; the serve and prefill steps captured as CUDA
graphs on the card), the H100 node meshes (``mesh``), the dry run on
``meta`` tensors (``dryrun``, counting with ``op_count``, priced by
``analysis``), the service CLI (``serve``) and the train CLI (``train``)."""
