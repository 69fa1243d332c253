"""Keys carried across from the JAX package: the selector and sigma
handles a JAX preprocess computes, converted with from_jax_limbs, commit on
the port (kernel 3 / 4's plain versions here) to the JAX verifying key's
points, and convert back bit for bit."""

import numpy as np
import torch

from distributed_plonk_tpu import kzg as JK
from distributed_plonk_tpu.backend.jax_backend import JaxBackend
from distributed_plonk_tpu.backend.python_backend import PythonBackend
from distributed_plonk_tpu_torch.backend import limbs as TL
from distributed_plonk_tpu_torch.backend.torch_backend import TorchBackend

# the plain versions run many small ops: one intra-op thread per test
# process beats oversubscribing the cores the other test workers share
torch.set_num_threads(1)


class _HostCommitJaxBackend(JaxBackend):
    """JaxBackend whose commitments run on the host oracle: its handles
    (lift_many + ifft_many on the JAX kernels) are what this test carries
    across; its own MSM would spend a minute compiling on the CPU."""

    def commit_many_h(self, ck, hs):
        return PythonBackend().commit_many_h(ck, [self.lower(h) for h in hs])


def test_jax_preprocess_handles_commit_to_same_points(proven):
    jckt = proven[0]
    srs = JK.universal_setup(jckt.n + 3, tau=0xDEADBEEF)
    jbe = _HostCommitJaxBackend()
    jpk, jvk = JK.preprocess(srs, jckt, jbe)
    sel_h, sig_h = jbe.pk_polys(jpk)
    handles = [TL.from_jax_limbs(np.asarray(h), "cpu") for h in sel_h + sig_h]
    assert all(h.dtype == torch.int32 and h.shape[0] == 8 for h in handles)
    comms = TorchBackend(device="cpu").commit_many_h(jpk.ck, handles)
    assert comms == list(jvk.selector_comms) + list(jvk.sigma_comms)
    # and back: the port's handles convert to the JAX bytes exactly
    assert np.array_equal(TL.to_jax_limbs(handles[0]), np.asarray(sel_h[0]))
