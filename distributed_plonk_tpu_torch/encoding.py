"""BLS12-381 point encoding, zcash/IETF wire format.

Interop surface with EXTERNAL golden vectors: the big-endian
"zcash-style" encoding standardized by the IETF BLS-signature and
hash-to-curve drafts (draft-irtf-cfrg-pairing-friendly-curves, appendix
C) and used by zcash, eth2, blst, py_ecc, ... Its generator encodings
are published constants, so tests/test_encoding.py anchors this repo's
curve constants and sign conventions to an external specification — the
byte-compat evidence class the transcript's merlin KAT provides for
Fiat-Shamir (the arkworks little-endian layout used on the transcript
itself, transcript.py:173-216, has no published vectors and no Rust
toolchain exists in this environment to record any; this module is the
independently-checkable complement).

Format (compressed): 48 bytes (G1) / 96 bytes (G2), big-endian x
(G2: c1 then c0), three flag bits in the MOST significant byte:
  bit 7 (0x80): compressed form
  bit 6 (0x40): point at infinity (remaining bytes zero)
  bit 5 (0x20): y is the lexicographically larger of the two roots
                (only when compressed and not infinity)
Uncompressed: 96 / 192 bytes, x then y, flags bit7=bit5=0.
"""

from .constants import Q_MOD, R_MOD
from . import curve as C

_HALF = (Q_MOD - 1) // 2


def _g1_in_subgroup(p):
    """True iff affine p lies in the r-order subgroup (r·p = O).

    BLS12-381's G1 cofactor is ≈2^125, so on-curve points outside the
    prime-order subgroup exist and the zcash/IETF format requires
    rejecting them (draft-irtf-cfrg-pairing-friendly-curves, appendix C).
    reduce=False: reducing r mod r would turn the check into 0·p.
    Host-oracle scale (255 Jacobian steps)."""
    return C.g1_mul(p, R_MOD, reduce=False) is None


def _g2_in_subgroup(p):
    """True iff affine G2 p satisfies r·p = O (cofactor ≈2^378 — almost
    every on-curve point is OUTSIDE the subgroup)."""
    return C.g2_mul(p, R_MOD, reduce=False) is None


def _fq_sign(y):
    """True iff y is the lexicographically larger root (y > (q-1)/2)."""
    return y > _HALF


def _fq2_sign(y):
    """Lexicographic order on Fq2 per the spec: compare c1 first."""
    y0, y1 = y
    if y1 != 0:
        return y1 > _HALF
    return y0 > _HALF


def g1_to_zcash(p, compressed=True):
    """Affine G1 (or None = infinity) -> 48/96 zcash-format bytes."""
    if p is None:
        out = bytearray(48 if compressed else 96)
        out[0] = (0x80 if compressed else 0) | 0x40
        return bytes(out)
    x, y = p
    if compressed:
        out = bytearray(x.to_bytes(48, "big"))
        out[0] |= 0x80 | (0x20 if _fq_sign(y) else 0)
        return bytes(out)
    return x.to_bytes(48, "big") + y.to_bytes(48, "big")


def g1_from_zcash(b):
    """48/96 zcash-format bytes -> affine G1 or None. Validates flags,
    field range, curve membership and the r-order subgroup (r·p = O),
    per the zcash/IETF validation rules."""
    b = bytes(b)
    if len(b) not in (48, 96):
        raise ValueError("G1 encoding must be 48 or 96 bytes")
    comp = bool(b[0] & 0x80)
    inf = bool(b[0] & 0x40)
    sign = bool(b[0] & 0x20)
    if comp != (len(b) == 48):
        raise ValueError("compression flag does not match length")
    if inf:
        if sign or any(b[1:]) or (b[0] & 0x1F):
            raise ValueError("malformed infinity encoding")
        return None
    if comp:
        x = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:], "big")
        if x >= Q_MOD:
            raise ValueError("x out of range")
        y2 = (pow(x, 3, Q_MOD) + 4) % Q_MOD  # E: y^2 = x^3 + 4
        y = pow(y2, (Q_MOD + 1) // 4, Q_MOD)  # q ≡ 3 (mod 4)
        if y * y % Q_MOD != y2:
            raise ValueError("x is not on the curve")
        if _fq_sign(y) != sign:
            y = (Q_MOD - y) % Q_MOD
        if not _g1_in_subgroup((x, y)):
            raise ValueError("point not in the r-order subgroup")
        return (x, y)
    if sign or (b[0] & 0x20):
        raise ValueError("sign flag set on uncompressed encoding")
    x = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:48], "big")
    y = int.from_bytes(b[48:], "big")
    if x >= Q_MOD or y >= Q_MOD:
        raise ValueError("coordinate out of range")
    if not C.g1_is_on_curve((x, y)):
        raise ValueError("point not on curve")
    if not _g1_in_subgroup((x, y)):
        raise ValueError("point not in the r-order subgroup")
    return (x, y)


def g2_to_zcash(p, compressed=True):
    """Affine G2 (or None) -> 96/192 zcash-format bytes (x = c1 || c0)."""
    if p is None:
        out = bytearray(96 if compressed else 192)
        out[0] = (0x80 if compressed else 0) | 0x40
        return bytes(out)
    (x0, x1), (y0, y1) = p
    if compressed:
        out = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
        out[0] |= 0x80 | (0x20 if _fq2_sign((y0, y1)) else 0)
        return bytes(out)
    return (x1.to_bytes(48, "big") + x0.to_bytes(48, "big")
            + y1.to_bytes(48, "big") + y0.to_bytes(48, "big"))


def g2_from_zcash(b):
    """96/192 zcash-format bytes -> affine G2 or None. Same validation
    surface as g1_from_zcash, including the r-order subgroup check."""
    b = bytes(b)
    if len(b) not in (96, 192):
        raise ValueError("G2 encoding must be 96 or 192 bytes")
    comp = bool(b[0] & 0x80)
    inf = bool(b[0] & 0x40)
    sign = bool(b[0] & 0x20)
    if comp != (len(b) == 96):
        raise ValueError("compression flag does not match length")
    if inf:
        if sign or any(b[1:]) or (b[0] & 0x1F):
            raise ValueError("malformed infinity encoding")
        return None
    x1 = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:48], "big")
    x0 = int.from_bytes(b[48:96], "big")
    if x0 >= Q_MOD or x1 >= Q_MOD:
        raise ValueError("x out of range")
    if comp:
        y = _fq2_sqrt(_fq2_add(_fq2_mul_xx_x((x0, x1)), (4, 4)))  # b' = 4+4i
        if y is None:
            raise ValueError("x is not on the curve")
        if _fq2_sign(y) != sign:
            y = ((Q_MOD - y[0]) % Q_MOD, (Q_MOD - y[1]) % Q_MOD)
        p = ((x0, x1), y)
        if not _g2_in_subgroup(p):
            raise ValueError("point not in the r-order subgroup")
        return p
    if sign:
        raise ValueError("sign flag set on uncompressed encoding")
    y1 = int.from_bytes(b[96:144], "big")
    y0 = int.from_bytes(b[144:], "big")
    if y0 >= Q_MOD or y1 >= Q_MOD:
        raise ValueError("y out of range")
    p = ((x0, x1), (y0, y1))
    if not C.g2_is_on_curve(p):
        raise ValueError("point not on curve")
    if not _g2_in_subgroup(p):
        raise ValueError("point not in the r-order subgroup")
    return p


# --- minimal Fq2 helpers (host oracle scale only) ----------------------------

def _fq2_add(a, b):
    return ((a[0] + b[0]) % Q_MOD, (a[1] + b[1]) % Q_MOD)


def _fq2_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    return ((a0 * b0 - a1 * b1) % Q_MOD, (a0 * b1 + a1 * b0) % Q_MOD)


def _fq2_mul_xx_x(x):
    return _fq2_mul(_fq2_mul(x, x), x)


def _fq2_sqrt(a):
    """Square root in Fq2 (q ≡ 3 mod 4): candidate a^((q^2+7)/16)-free
    shortcut via the norm map — compute with the standard complex method:
    sqrt(a0 + a1*i) from Fq square roots of the norm."""
    a0, a1 = a
    if a1 == 0:
        # a0 might be a QR in Fq, else sqrt is i * sqrt(-a0)
        r = pow(a0, (Q_MOD + 1) // 4, Q_MOD)
        if r * r % Q_MOD == a0:
            return (r, 0)
        na = (Q_MOD - a0) % Q_MOD
        r = pow(na, (Q_MOD + 1) // 4, Q_MOD)
        if r * r % Q_MOD == na:
            return (0, r)
        return None
    # norm = a0^2 + a1^2 (since i^2 = -1); need alpha with alpha^2 = norm
    norm = (a0 * a0 + a1 * a1) % Q_MOD
    alpha = pow(norm, (Q_MOD + 1) // 4, Q_MOD)
    if alpha * alpha % Q_MOD != norm:
        return None
    inv2 = pow(2, Q_MOD - 2, Q_MOD)
    for al in (alpha, (Q_MOD - alpha) % Q_MOD):
        delta = (a0 + al) * inv2 % Q_MOD
        x0 = pow(delta, (Q_MOD + 1) // 4, Q_MOD)
        if x0 * x0 % Q_MOD != delta or x0 == 0:
            continue
        x1 = a1 * pow(2 * x0 % Q_MOD, Q_MOD - 2, Q_MOD) % Q_MOD
        cand = (x0, x1)
        if _fq2_mul(cand, cand) == a:
            return cand
    return None
