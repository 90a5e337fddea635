"""The RNS-sharded programs on torch.distributed: `mesh` (the ('rns',
'coef') DeviceMesh, DTensor placements and the counted collectives),
`multihost` (the process group) and `spmd` (SpmdBFVContext), the
counterparts of ntt_cuda_tpu/parallel/{mesh,multihost,spmd}.py."""
