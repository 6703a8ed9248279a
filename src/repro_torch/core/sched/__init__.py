"""Fleet scheduling: thermal and carbon-aware device selection, fault
strategies, the discrete-event orchestrator and the vectorized churn
simulator (the port's copies of ``repro.core.sched``)."""
