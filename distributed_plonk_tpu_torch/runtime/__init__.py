"""Host runtime of the port's worker fleet: native data plane + TCP control
plane.

The counterpart of the reference's worker/dispatcher runtime: a C++
data-plane/transport library (native/dpt_native.cpp) loaded via ctypes, a
network config, a worker daemon whose kernels run on the card
(runtime/worker.py), a dispatcher client (runtime/dispatcher.py), the
fleet's membership plane (runtime/membership.py) and a worker supervisor
(runtime/supervisor.py). The
wire protocol is byte-identical to the JAX package's, so either package's
dispatcher drives either package's workers.
"""
