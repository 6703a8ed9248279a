"""Multi-device execution: the DT-FM hybrid data + pipeline executor
(:mod:`~repro_torch.distributed.pipeline`) over ``torch.distributed``, and
the runtime that starts its ranks (:mod:`~repro_torch.distributed.runtime`).
Importing the package starts no process and touches no process group."""
