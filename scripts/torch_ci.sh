#!/usr/bin/env bash
# The PyTorch port's lanes of scripts/ci.sh (the whole tier-1 run stays
# scripts/ci.sh with no lane: ROADMAP.md's command).
#
# Usage:
#   scripts/torch_ci.sh fast     the CPU parity files of the four kernels'
#                                plain versions (K1 field, K2 NTT, K3 MSM
#                                buckets, K4 curve adds) and of the fused
#                                round 3's folds, exact against the JAX
#                                package (a few minutes on the CPU)
#   scripts/torch_ci.sh analyze  the port's static verifier, strict:
#                                python -m distributed_plonk_tpu_torch.
#                                analysis --strict (on the card: the host
#                                passes, then the kernels' value contracts;
#                                extra arguments pass through, e.g.
#                                `analyze --device cpu` on a host without
#                                one)
#   scripts/torch_ci.sh chaos    the port's fleet, recovery and integrity
#                                files: port workers over real TCP, faults
#                                on the wire, proc and data planes, the
#                                membership plane and the service's journal
#                                recovery (CPU workers, several minutes)
#   scripts/torch_ci.sh cuda     the kernels against their plain versions
#                                on a machine with the card (the chip
#                                machine has no jax: no conftest)
#
# With no lane or an unknown one it prints the lanes and exits 2. The
# `benchcheck` and `autotune` lanes of scripts/ci.sh wait for the port's
# bench.
cd "$(dirname "$0")/.."
LANES="fast analyze chaos cuda"
PYTEST="python -m pytest -q -p no:cacheprovider -p no:xdist -p no:randomly"
case "$1" in
  fast)
    exec env JAX_PLATFORMS=cpu $PYTEST -m 'not slow' \
      tests/test_torch_field.py tests/test_torch_ntt.py \
      tests/test_torch_msm.py tests/test_torch_msm_base.py \
      tests/test_torch_msm_finish_coop.py tests/test_torch_proj_add_coop.py \
      tests/test_torch_round3.py tests/test_torch_round3_fused.py
    ;;
  analyze)
    shift
    exec python -m distributed_plonk_tpu_torch.analysis --strict "$@"
    ;;
  chaos)
    exec env JAX_PLATFORMS=cpu $PYTEST -m 'not slow' \
      tests/test_torch_fleet.py tests/test_torch_fleet_recovery.py \
      tests/test_torch_fleet_obs.py tests/test_torch_membership.py \
      tests/test_torch_supervisor.py tests/test_torch_service_recovery.py
    ;;
  cuda)
    exec python -m pytest tests/test_torch_cuda.py --noconftest -m cuda \
      -q -p no:cacheprovider
    ;;
  *)
    echo "usage: scripts/torch_ci.sh LANE (lanes: $LANES)" >&2
    exit 2
    ;;
esac
