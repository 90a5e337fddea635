"""The sharded programs on torch.distributed: `mesh` (the ('rns', 'coef')
DeviceMesh, DTensor placements and the counted collectives), `multihost`
(the process group), `spmd` (SpmdBFVContext) and `spmd_mult`
(SpmdMultContext: EvalMult, relinearization, Galois) over the moduli,
`sharded` and `coef_kernels` (the coefficient-sharded NTT, plain and with
the stage kernels), `spmd2d` (Spmd2DBFVContext) and `spmd2d_mult`
(Spmd2DMultContext) over both axes, and `rns` (ShardedBFVContext: the
single-card API over the moduli, on the SPMD programs), the counterparts
of ntt_cuda_tpu/parallel/{mesh,multihost,spmd,spmd_mult,sharded,
coef_pallas,spmd2d,spmd2d_mult,rns}.py."""
