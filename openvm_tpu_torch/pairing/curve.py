"""BN254 and BLS12-381 pairing curve parameters.

Copy of openvm_tpu/pairing/curve.py (the whole module: ``naf`` :23,
``PairingCurveParams`` :38, the derived Frobenius constants :64-80,
``BN254`` :82, ``BLS12_381`` :98, ``CURVES`` :115).

Mirrors the reference `extensions/pairing/guest/src/{bn254,bls12_381}` and
`halo2curves_shims/*/curve.rs` parameter sets.  Every derived constant
(hint exponents, Frobenius twists, 27th root of unity) is *computed* from
(p, r, seed) rather than vendored, with the defining relation documented —
see `derive_*` functions.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from .tower import Tower

# 6x+2 for the BN254 seed x in non-adjacent form, LSB first (the canonical
# NAF; reference halo2curves_shims/bn254/miller_loop.rs:19-24 asserts
# sum_i enc[i] 2^i == 6x+2 — `naf` below re-derives it).
# BLS12-381 uses the NAF of |x| directly (miller_loop.rs:19-22).


def naf(value: int) -> list:
    """Non-adjacent form, LSB first, digits in {-1, 0, 1}."""
    out = []
    while value:
        if value & 1:
            d = 2 - (value % 4)
            out.append(d)
            value -= d
        else:
            out.append(0)
        value >>= 1
    return out


@dataclass(frozen=True)
class PairingCurveParams:
    name: str
    p: int            # base field modulus
    r: int            # scalar field (subgroup order)
    seed: int         # curve seed x (signed)
    xi: tuple         # sextic twist nonresidue in Fp2
    b: int            # G1 short-Weierstrass b
    g1: tuple         # G1 generator (x, y) ints
    g2: tuple         # G2 generator ((x0,x1),(y0,y1)) Fp2 pairs
    num_limbs: int    # bytes per Fp element in guest memory
    line_type: str    # 'D' (BN254: 1 + b w + c w^3) or 'M' (c + b w^2 + w^3)

    @functools.cached_property
    def tower(self) -> Tower:
        return Tower(self.p, self.xi)

    @functools.cached_property
    def pseudo_binary_encoding(self) -> tuple:
        """Loop digits, LSB first: NAF of |6x+2| for D-type (BN254), plain
        binary of |x| for M-type (BLS12-381) — both verified against the
        reference's PSEUDO_BINARY_ENCODING arrays."""
        if self.line_type == "D":
            return tuple(naf(abs(6 * self.seed + 2)))
        v = abs(self.seed)
        return tuple((v >> i) & 1 for i in range(v.bit_length()))

    # -- G2 twist Frobenius constants (miller post-loop) --------------------
    @functools.cached_property
    def frob_g2_x(self) -> tuple:
        """xi^((p-1)/3): scales conj(Q.x) under the twist Frobenius psi
        (reference FROBENIUS_COEFF_FQ6_C1[1])."""
        return self.tower.f2_pow(self.xi, (self.p - 1) // 3)

    @functools.cached_property
    def frob_g2_y(self) -> tuple:
        """xi^((p-1)/2) (reference XI_TO_Q_MINUS_1_OVER_2)."""
        return self.tower.f2_pow(self.xi, (self.p - 1) // 2)

    @functools.cached_property
    def frob_g2_x_sq(self) -> tuple:
        """xi^((p^2-1)/3) — an Fp scalar (reference FROBENIUS_COEFF_FQ6_C1[2])."""
        return self.tower.f2_pow(self.xi, (self.p * self.p - 1) // 3)


BN254 = PairingCurveParams(
    name="Bn254",
    p=21888242871839275222246405745257275088696311157297823662689037894645226208583,
    r=21888242871839275222246405745257275088548364400416034343698204186575808495617,
    seed=0x44E992B44A6909F1,
    xi=(9, 1),
    b=3,
    g1=(1, 2),
    g2=((10857046999023057135944570762232829481370756359578518086990519993285655852781,
         11559732032986387107991004021392285783925812861821192530917403151452391805634),
        (8495653923123431417604973247489272438418190587263600148770280649306958101930,
         4082367875863433681332203403145435568316851327593401208105741076214120093531)),
    num_limbs=32,
    line_type="D",
)

BLS12_381 = PairingCurveParams(
    name="Bls12_381",
    p=0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB,
    r=0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001,
    seed=-0xD201000000010000,
    xi=(1, 1),
    b=4,
    g1=(3685416753713387016781088315183077757961620795782546409894578378688607592378376318836054947676345821548104185464507,
        1339506544944476473020471379941921221584933875938349620426543736416511423956333506472724655353366534992391756441569),
    g2=((352701069587466618187139116011060144890029952792775240219908644239793785735715026873347600343865175952761926303160,
         3059144344244213709971259814753781636986470325476647558659373206291635324768958432433509563104347017837885763365758),
        (1985150602287291935568054521177171638300868978215655730859378665066344726373823718423869104263333984641494340347905,
         927553665492332455747201965776037880757740193453592970025027978793976877002675564980949289727957565575433344219582)),
    num_limbs=48,
    line_type="M",
)

CURVES = {0: BN254, 1: BLS12_381}  # PairingCurve discriminant order
