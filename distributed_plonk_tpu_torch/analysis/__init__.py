"""Static verifier of the port (the counterpart of the JAX package's
analysis/): `python -m distributed_plonk_tpu_torch.analysis`.

Four passes (README "Static analysis of the port"):

- `lint`: AST hazard lints over the port's package: cache keys, float
  promotion in the plain kernels, lock discipline and lock order,
  the metric and log-subsystem glossaries, environment reads, wire tags.
- `contracts`: field_torch.CARRY_CONTRACTS, the side conditions no
  interval proves (the plain versions' and csrc/field.cuh's), evaluated
  for Fr and Fq.
- `bounds`: interval propagation over the aten graph of every registered
  plain kernel: no int64 wraps, no int32 narrowing of a value that does
  not fit, no float, declared output ranges met.
- `values`: exact evaluation of the same graphs against each entry's
  value contract (mont_mul == a*b*R^-1 mod p, NTT == DFT, digits
  recombine, Horner == sum c_i z^i), and on the card the kernels held to
  the same contracts on the same samples.

analysis/mutants.py keeps the verifier honest: seeded bad kernels and
sources that must stay rejected by the pass that owns each bug class.
`# analysis: ok(<reason>)` on (or directly above) a line suppresses a lint
finding there.
"""

from . import bounds, lint, registry, values  # noqa: F401
from .bounds import (Bound, check_contracts, check_fn, trace,  # noqa: F401
                     word_rows)
from .lint import lint_source, run_lints  # noqa: F401
from .registry import (Entry, ValueObligation, build_registry,  # noqa: F401
                       run_bounds, run_values)
from .values import check_value, run_exact  # noqa: F401
