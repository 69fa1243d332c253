"""BLS12-381 curve and field constants.

All values are standard, publicly specified BLS12-381 parameters (as used by
the reference's `ark-bls12-381` dependency, see reference Cargo.toml:31).
Derived quantities (Montgomery constants, roots of unity) are computed here
from first principles so nothing is copied from any implementation.
"""

# BLS parameter (the curve family is parameterised by z; z is negative).
# All moduli below are validated against this parameterisation at import time.
BLS_Z = -0xD201000000010000

# --- Scalar field Fr ---------------------------------------------------------
# r = order of the BLS12-381 G1/G2 subgroups (255 bits); r = z^4 - z^2 + 1
R_MOD = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
assert R_MOD == BLS_Z ** 4 - BLS_Z ** 2 + 1

# Multiplicative generator of Fr* (arkworks' `GENERATOR` for Fr is 7; it is a
# primitive root mod r). Used as the coset shift for coset-FFTs
# (reference: Fr::multiplicative_generator() at src/worker.rs:76).
FR_GENERATOR = 7

# two-adicity: r - 1 = 2^32 * FR_ODD
FR_TWO_ADICITY = 32
FR_ODD = (R_MOD - 1) >> FR_TWO_ADICITY
assert (R_MOD - 1) == FR_ODD << FR_TWO_ADICITY and FR_ODD % 2 == 1

# 2^32-th primitive root of unity in Fr
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, FR_ODD, R_MOD)

# --- Base field Fq -----------------------------------------------------------
# q = characteristic of the base field (381 bits); q = (z-1)^2 * r / 3 + z
Q_MOD = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
assert Q_MOD == (BLS_Z - 1) ** 2 * R_MOD // 3 + BLS_Z

# --- Curve equations ---------------------------------------------------------
# G1: y^2 = x^3 + 4 over Fq
G1_B = 4
# G2: y^2 = x^3 + 4(1+u) over Fq2 = Fq[u]/(u^2+1)
G2_B = (4, 4)

# --- Standard generators -----------------------------------------------------
G1_GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

G2_GEN_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_GEN_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# Absolute value of the BLS parameter (for ate-style Miller loops)
BLS_X = -BLS_Z
BLS_X_IS_NEG = True

# --- Word layouts for device kernels ----------------------------------------
# The port's handles hold 32-bit words (uint32 bit patterns in int32 tensors),
# limb-major: (8, *batch) for Fr, (12, *batch) for Fq. The JAX package's
# handles hold 16-bit limbs in uint32 lanes, (16, *batch) / (24, *batch);
# word i of a port handle is limb 2i | limb 2i+1 << 16 (backend/limbs.py).
LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
FR_LIMBS = 16  # 256 bits as 16-bit limbs (the JAX package's handle)
FQ_LIMBS = 24  # 384 bits
WORD_BITS = 32
WORD_MASK = (1 << WORD_BITS) - 1
FR_WORDS = 8
FQ_WORDS = 12

# Montgomery radixes match arkworks' 64-bit-limb layout (R = 2^256 for Fr,
# R = 2^384 for Fq) so Montgomery-form values are bit-compatible.
FR_MONT_R = (1 << 256) % R_MOD
FR_MONT_R2 = (FR_MONT_R * FR_MONT_R) % R_MOD
FR_MONT_INV = (-pow(R_MOD, -1, 1 << 256)) % (1 << 256)  # -r^-1 mod 2^256
FR_MONT_INV32 = FR_MONT_INV & WORD_MASK  # -r^-1 mod 2^32 (word-level CIOS)

FQ_MONT_R = (1 << 384) % Q_MOD
FQ_MONT_R2 = (FQ_MONT_R * FQ_MONT_R) % Q_MOD
FQ_MONT_INV = (-pow(Q_MOD, -1, 1 << 384)) % (1 << 384)
FQ_MONT_INV32 = FQ_MONT_INV & WORD_MASK
