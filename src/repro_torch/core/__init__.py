"""Framework-neutral core: the task model, the Eq. 1 exec model, the
paper's workloads and the design space."""
