"""Distribution helpers of the port (counterpart of ``repro.distributed``):
int8 error-feedback gradient compression (``compression``), atomic
checkpoints (``checkpoint``), the logical-axis sharding rules as DTensor
placements (``sharding``) and elastic re-meshing (``elastic``)."""
