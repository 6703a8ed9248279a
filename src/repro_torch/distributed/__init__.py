"""Multi-device execution: the DT-FM hybrid data + pipeline executor
(:mod:`~repro_torch.distributed.pipeline`), the production mesh's rule
tables (:mod:`~repro_torch.distributed.sharding`), activation
constraints (:mod:`~repro_torch.distributed.act_sharding`) and
rank-side FSDP + tensor-parallel steps
(:mod:`~repro_torch.distributed.spmd`) over ``torch.distributed``, and
the runtime that starts their ranks
(:mod:`~repro_torch.distributed.runtime`).  Importing the package starts
no process and touches no process group."""
