from repro_torch.core.faultinject.plan import (FaultInjector, FaultPlan,
                                               corrupt_file)

__all__ = ["FaultPlan", "FaultInjector", "corrupt_file"]
