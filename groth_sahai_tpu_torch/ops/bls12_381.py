"""BLS12-381 curve constants.

All constants are plain Python integers (computed at import time, host-side);
device-side limb encodings are produced lazily by the field classes in
:mod:`groth_sahai_tpu_torch.ops.fp`.

A copy of the JAX package's module of the same name (the port imports
nothing from that package); the two are held equal by the port's tests.
"""

# Base field modulus (381 bits).
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# Scalar field modulus (255 bits) = order of G1/G2 subgroups.
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# Curve equations: E/Fq: y^2 = x^3 + 4; twist E'/Fq2: y^2 = x^3 + 4(u+1).
B_G1 = 4
B_G2 = (4, 4)  # 4*(u+1) as (c0, c1) over Fq2

# BLS parameter x (negative). |X| has Hamming weight 6.
X = -0xD201000000010000

# Cofactors (for reference / subgroup checks).
H_G1 = 0x396C8C005555E1568C00AAAB0000AAAB
H_G2 = 0x5D543A95414E7F1091D50792876A202CD91DE4547085ABAA68A205B2E5A7DDFA628F1CB4D9E82EF21537E293A6691AE1616EC6E786F0C70CF1C38E31C7238E5

# G1 generator (affine).
G1_GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

# G2 generator (affine, coordinates in Fq2 as (c0, c1)).
G2_GEN_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_GEN_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# Tower construction:
#   Fq2  = Fq[u]  / (u^2 + 1)
#   Fq6  = Fq2[v] / (v^3 - (u + 1))
#   Fq12 = Fq6[w] / (w^2 - v)
# Non-residues:
FQ2_NON_RESIDUE = P - 1          # u^2 = -1
FQ6_NON_RESIDUE = (1, 1)         # v^3 = u + 1  (Fq2 element)

# Frobenius coefficients, computed on the fly in Python below.


def _fq2_pow(a, e):
    c0, c1 = a
    r0, r1 = 1, 0
    while e:
        if e & 1:
            r0, r1 = (r0 * c0 - r1 * c1) % P, (r0 * c1 + r1 * c0) % P
        c0, c1 = (c0 * c0 - c1 * c1) % P, (2 * c0 * c1) % P
        e >>= 1
    return (r0, r1)


# xi = u + 1 (the Fq6 non-residue).
_XI = (1, 1)

# Fq6 Frobenius: (c0, c1 v, c2 v^2) -> (c0^p, c1^p * g1, c2^p * g2),
# g1 = xi^((p-1)/3), g2 = xi^((2p-2)/3) -- and similarly for powers p^i.
FROB_FQ6_C1 = [_fq2_pow(_XI, (P**i - 1) // 3) for i in range(6)]
FROB_FQ6_C2 = [_fq2_pow(_XI, (2 * (P**i - 1)) // 3) for i in range(6)]

# Fq12 Frobenius: (c0 + c1 w) -> (c0^p, c1^p * g) with g = xi^((p-1)/6).
FROB_FQ12_C1 = [_fq2_pow(_XI, (P**i - 1) // 6) for i in range(12)]

# Final exponentiation: (p^12 - 1) / r = easy * hard,
# easy = (p^6 - 1)(p^2 + 1), hard = (p^4 - p^2 + 1) / r.
FINAL_EXP_HARD = (P**4 - P**2 + 1) // R
assert (P**12 - 1) % R == 0
assert FINAL_EXP_HARD * R == P**4 - P**2 + 1
