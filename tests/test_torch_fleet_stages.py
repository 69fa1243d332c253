"""The fleet worker's stage panels (runtime/torch_stages.py) on the CPU:
every FFT1 row panel and FFT2 column panel equals the JAX package's
jax_stages.StageKernels (JAX on the CPU) and the row-by-row oracle of the
port's worker (_stage1_row / _stage2_row over the host PythonBackend),
exactly, for n = 64 (a square split, r = c = 8) and n = 128 (uneven,
r = 8, c = 16), in all four (inverse, coset) modes, on whole and partial
row and column ranges.
"""

import random

import numpy as np
import pytest
import torch

from distributed_plonk_tpu.runtime.jax_stages import \
    StageKernels as JaxStageKernels
from distributed_plonk_tpu_torch.backend.limbs import ints_to_limbs16
from distributed_plonk_tpu_torch.backend.python_backend import PythonBackend
from distributed_plonk_tpu_torch.constants import R_MOD
from distributed_plonk_tpu_torch.poly import Domain
from distributed_plonk_tpu_torch.runtime import protocol
from distributed_plonk_tpu_torch.runtime.dispatcher import _split_rc
from distributed_plonk_tpu_torch.runtime.torch_stages import StageKernels
from distributed_plonk_tpu_torch.runtime.worker import (FftTask, _stage1_row,
                                                        _stage2_row)

torch.set_num_threads(1)

MODES = [(False, False), (True, False), (False, True), (True, True)]
PORT = StageKernels(device="cpu")
JAX = JaxStageKernels()
HOST = PythonBackend()


def _task(n, inverse, coset, me, k=2):
    """Worker `me`'s FftTask in a k-worker plan of an n-point transform
    (the dispatcher's contiguous row and column split)."""
    r, c = _split_rc(n)
    rows = [c * j // k for j in range(k + 1)]
    cols = [(r * j // k, r * (j + 1) // k) for j in range(k)]
    return FftTask(inverse, coset, n, r, c, rows[me], rows[me + 1], cols, me)


def _panel(rng, count, length):
    vals = [rng.randrange(R_MOD) for _ in range(count * length)]
    return ints_to_limbs16(vals).reshape(16, count, length), vals


def _rows(panel):
    count, length = panel.shape[1], panel.shape[2]
    ints = protocol.matrix_to_ints(panel.reshape(16, count * length))
    return [ints[i * length:(i + 1) * length] for i in range(count)]


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("inverse,coset", MODES)
def test_stage1_panels_match_jax_and_row_oracle(n, inverse, coset):
    rng = random.Random(n * 4 + inverse * 2 + coset)
    task = _task(n, inverse, coset, me=1)
    # worker 1's whole row range, then a partial range that starts inside
    # it (a retried or split FFT1 frame)
    for first, count in ((task.rs, task.re - task.rs),
                         (task.rs + 1, task.re - task.rs - 2)):
        panel, vals = _panel(rng, count, task.r)
        got = PORT.stage1_panel(task, first, panel)
        assert got.dtype == np.uint32 and got.shape == panel.shape
        assert np.array_equal(got, JAX.stage1_panel(task, first, panel))
        want = [_stage1_row(HOST, Domain(task.r), task, first + i,
                            vals[i * task.r:(i + 1) * task.r])
                for i in range(count)]
        assert _rows(got) == want


@pytest.mark.parametrize("n", [64, 128])
@pytest.mark.parametrize("inverse,coset", MODES)
def test_stage2_panels_match_jax_and_row_oracle(n, inverse, coset):
    rng = random.Random(1000 + n * 4 + inverse * 2 + coset)
    for me in (0, 1):  # the lower and the upper half of the columns
        task = _task(n, inverse, coset, me=me)
        cols, vals = _panel(rng, task.ce - task.cs, task.c)
        got = PORT.stage2_panel(task, cols)
        assert np.array_equal(got, JAX.stage2_panel(task, cols))
        want = [_stage2_row(HOST, Domain(task.c), task, task.cs + i,
                            vals[i * task.c:(i + 1) * task.c])
                for i in range(task.ce - task.cs)]
        assert _rows(got) == want


def test_stage_table_cache_is_bounded():
    """Nine distinct (n, mode, range) table sets leave the cap's 8, the
    oldest gone first (jax_stages' _TABLE_CAP)."""
    stages = StageKernels(device="cpu")
    keys = []
    for me in range(3):
        for inverse, coset in MODES[:3]:
            task = _task(64, inverse, coset, me=me, k=3)
            count = task.re - task.rs
            stages.stage1_panel(task, task.rs,
                                np.zeros((16, count, task.r), np.uint32))
            keys.append(("s1", 64, inverse, coset, task.rs, task.re))
    assert len(stages._tables) == StageKernels._TABLE_CAP == 8
    assert list(stages._tables) == keys[1:]
