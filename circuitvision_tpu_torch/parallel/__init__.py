"""Data and model parallelism over torch.distributed ranks (the JAX
package's `parallel/`): `mesh` (the rank grid, its groups, the shard
rule), `multihost` (the launcher environment, spans, the byte gather,
distributed analysis)."""
