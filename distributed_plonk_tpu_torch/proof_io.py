"""Proof (de)serialization: the pinned wire layout for golden fixtures.

The reference's Proof<Bls12_381> is assembled at
reference src/dispatcher2.rs:699-710 and serialized only implicitly
through ark-serialize. This repo pins an EXPLICIT layout so full proofs
can be stored as golden fixtures (tests/test_proof_golden.py) and
compared byte-for-byte across backends — a regression floor in lieu of a
jf-plonk fixture.

Layout (fixed width, 944 bytes total; field order mirrors the reference's
Proof struct and the verifier's transcript order, verifier.py:78-79):

  offset  size  field
  ------  ----  -----------------------------------------------------
  0       5x48  wires_poly_comms      5 G1, zcash compressed (encoding.py)
  240     1x48  prod_perm_poly_comm   1 G1
  288     5x48  split_quot_poly_comms 5 G1
  528     1x48  opening_proof         1 G1
  576     1x48  shifted_opening_proof 1 G1
  624     5x32  wires_evals           5 Fr, 32-byte little-endian canonical
  784     4x32  wire_sigma_evals      4 Fr
  912     1x32  perm_next_eval        1 Fr

G1 points use the zcash/IETF compressed format (48 bytes, external golden
vectors — encoding.py), so deserialization validates curve membership AND
the r-order subgroup. Fr scalars are canonical (< r) little-endian, the
arkworks PrimeField byte order used on the transcript (transcript.py).
"""

from .constants import R_MOD
from .circuit import NUM_WIRE_TYPES
from . import encoding as E
from .prover import Proof

PROOF_BYTES = 13 * 48 + 10 * 32


def _fr_bytes(x):
    assert 0 <= x < R_MOD
    return int(x).to_bytes(32, "little")


def serialize_proof(proof):
    """Proof -> 944 fixed-layout bytes (see module docstring)."""
    out = bytearray()
    points = (list(proof.wires_poly_comms) + [proof.prod_perm_poly_comm]
              + list(proof.split_quot_poly_comms)
              + [proof.opening_proof, proof.shifted_opening_proof])
    assert len(points) == 2 * NUM_WIRE_TYPES + 3
    for p in points:
        out += E.g1_to_zcash(p)
    scalars = (list(proof.wires_evals) + list(proof.wire_sigma_evals)
               + [proof.perm_next_eval])
    assert len(scalars) == 2 * NUM_WIRE_TYPES
    for s in scalars:
        out += _fr_bytes(s)
    assert len(out) == PROOF_BYTES
    return bytes(out)


def deserialize_proof(b):
    """944 fixed-layout bytes -> Proof (validates every point, including
    the subgroup check, and every scalar's canonical range)."""
    b = bytes(b)
    if len(b) != PROOF_BYTES:
        raise ValueError(f"proof must be {PROOF_BYTES} bytes, got {len(b)}")
    w = NUM_WIRE_TYPES
    points = [E.g1_from_zcash(b[i * 48:(i + 1) * 48]) for i in range(2 * w + 3)]
    off = (2 * w + 3) * 48
    scalars = []
    for i in range(2 * w):
        x = int.from_bytes(b[off + i * 32:off + (i + 1) * 32], "little")
        if x >= R_MOD:
            raise ValueError("scalar out of canonical range")
        scalars.append(x)
    return Proof(
        wires_poly_comms=points[:w],
        prod_perm_poly_comm=points[w],
        split_quot_poly_comms=points[w + 1:2 * w + 1],
        opening_proof=points[2 * w + 1],
        shifted_opening_proof=points[2 * w + 2],
        wires_evals=scalars[:w],
        wire_sigma_evals=scalars[w:2 * w - 1],
        perm_next_eval=scalars[2 * w - 1],
    )
