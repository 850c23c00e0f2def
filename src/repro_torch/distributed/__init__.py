"""Distribution helpers of the port (counterpart of ``repro.distributed``):
int8 error-feedback gradient compression (``compression``) and atomic
checkpoints (``checkpoint``).  The mesh's sharding rules and elastic
re-meshing wait for a later slice."""
