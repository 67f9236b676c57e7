"""The benchmark's inputs, made from ``--seed``: traffic, the PDN and its
telemetry.  The port and the plain references receive the same arrays."""
