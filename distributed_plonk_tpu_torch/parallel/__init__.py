"""Mesh-parallel proving: the port of the JAX package's parallel/.

The reference moves FFT panels between workers over TCP (the fftExchange
all-to-all, reference src/worker.rs:293-344,412-438) and sum-reduces MSM
partials on its dispatcher (reference src/dispatcher2.rs:888-890). The
JAX package expresses the same dataflow as XLA collectives over a
jax.sharding.Mesh. Here one process drives a list of devices (`Mesh`):
the 4-step NTT's transpose is D x D tile copies between the shards'
devices, and the MSM's bucket planes fold on the lead device with
kernel 4 — no host round-trips in either. After mesh.init_multihost,
every process of a torch.distributed group runs the same program on the
shards it holds, and those two steps become an all-to-all and an
all-gather (transport.py).
"""
