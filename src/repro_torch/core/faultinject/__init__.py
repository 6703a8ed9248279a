from repro_torch.core.faultinject.plan import FaultInjector, FaultPlan

__all__ = ["FaultPlan", "FaultInjector"]
