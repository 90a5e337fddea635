"""The RNS-sharded programs on torch.distributed: `mesh` (the ('rns',
'coef') DeviceMesh, DTensor placements and the counted collectives),
`multihost` (the process group), `spmd` (SpmdBFVContext) and `spmd_mult`
(SpmdMultContext: EvalMult, relinearization, Galois), the counterparts of
ntt_cuda_tpu/parallel/{mesh,multihost,spmd,spmd_mult}.py."""
