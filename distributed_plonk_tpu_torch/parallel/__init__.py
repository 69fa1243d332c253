"""Mesh-parallel proving: the port of the JAX package's parallel/.

The reference moves FFT panels between workers over TCP (the fftExchange
all-to-all, reference src/worker.rs:293-344,412-438) and sum-reduces MSM
partials on its dispatcher (reference src/dispatcher2.rs:888-890). The
JAX package expresses the same dataflow as XLA collectives over a
jax.sharding.Mesh. Here one process drives a list of devices (`Mesh`),
and the prover's handles stay in lane shards across all five rounds
(sharded.py): the 4-step NTT's exchanges are D x D tile copies between
the shards' devices, the round math runs on each shard's lanes, and the
MSM's bucket planes fold on the lead device with kernel 4 — no host
round-trips. After mesh.init_multihost, every process of a
torch.distributed group runs the same program on the shards it holds,
and those steps become all-to-alls and all-gathers (transport.py).
"""
