"""The sharded programs on torch.distributed: `mesh` (the ('rns', 'coef')
DeviceMesh, DTensor placements and the counted collectives), `multihost`
(the process group), `spmd` (SpmdBFVContext) and `spmd_mult`
(SpmdMultContext: EvalMult, relinearization, Galois) over the moduli,
`sharded` and `coef_kernels` (the coefficient-sharded NTT, plain and with
the stage kernels) and `spmd2d` (Spmd2DBFVContext over both axes), the
counterparts of ntt_cuda_tpu/parallel/{mesh,multihost,spmd,spmd_mult,
sharded,coef_pallas,spmd2d}.py."""
