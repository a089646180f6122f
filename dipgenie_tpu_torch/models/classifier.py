"""KmerGenie-style diploid k-mer multiplicity mixture model.

Reproduces the reference classifier (reference: src/Classifier.hpp):

  * error pmf: ``p_err(x) = 1/x^s − 1/(x+1)^s`` (Classifier.hpp:116-123)
  * Zipf prior over copy number 1..max_copy (Classifier.hpp:126-133)
  * per-copy Normal kernels — hom: mean ``copy·u_v``, sd ``√copy·sd_v``;
    het: mean ``copy·u_v/2``, sd ``√copy·0.5·√var_w``
    (Classifier.hpp:136-171)
  * posterior with hard rule ``x==1 or p_het >= p_hom → HET else HOM``
    (Classifier.hpp:59-80)

Both a scalar float64 path (exact parity with the C++ doubles) and a
vectorized numpy path over arrays of multiplicities.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

HET, HOM = 0, 1


@dataclass
class KGParams:
    zp_copy: float = 1.3
    zp_copy_het: float = 1.3
    u_v: float = 4.0
    sd_v: float = 1.2
    var_w: float = 2.0
    p_d: float = 0.5
    max_copy: int = 5
    p_e: float = 0.01
    err_shape: float = 2.0


def zeta_weights(zp: float, max_copy: int) -> list[float]:
    """Normalized Zipf weights over copy 1..max_copy (Classifier.hpp:126-133).

    Sequential-sum order matches the C++ accumulation."""
    w = [0.0] * (max_copy + 1)
    s = 0.0
    for kk in range(1, max_copy + 1):
        w[kk] = 1.0 / math.pow(float(kk), zp)
        s += w[kk]
    for kk in range(1, max_copy + 1):
        w[kk] /= s
    return w


_INV_SQRT_2PI = 0.3989422804014327


def _normal_pdf(x: float, mu: float, sd: float) -> float:
    s = max(sd, 1e-12)
    z = (x - mu) / s
    return _INV_SQRT_2PI / s * math.exp(-0.5 * z * z)


def derr_old_val(c: int, s: float) -> float:
    if c <= 0:
        return 0.0
    v = math.pow(float(c), -s) - math.pow(float(c + 1), -s)
    return v if v > 0.0 else 1e-300


def val_hom(x: int, P: KGParams, zeta_hom: list[float]) -> float:
    total = 0.0
    for copy in range(1, P.max_copy + 1):
        mu = copy * P.u_v
        sd = math.sqrt(float(copy)) * P.sd_v
        total += zeta_hom[copy] * _normal_pdf(x, mu, sd)
    return max(total, 1e-300)


def val_het(x: int, P: KGParams, zeta_het: list[float]) -> float:
    u_base = 0.5 * P.u_v
    sd_base = 0.5 * math.sqrt(max(P.var_w, 1e-12))
    total = 0.0
    for copy in range(1, P.max_copy + 1):
        mu = copy * u_base
        sd = math.sqrt(float(copy)) * sd_base
        total += zeta_het[copy] * _normal_pdf(x, mu, sd)
    return max(total, 1e-300)


def classify_multiplicity(x: int, P: KGParams) -> int:
    """Exact scalar classification (Classifier.hpp:59-80). Returns HET/HOM."""
    zeta_hom = zeta_weights(P.zp_copy, P.max_copy)
    zeta_het = zeta_weights(P.zp_copy_het, P.max_copy)
    fe = derr_old_val(x, P.err_shape)
    fhet = val_het(x, P, zeta_het)
    fhom = val_hom(x, P, zeta_hom)
    a = P.p_e * fe
    b = (1.0 - P.p_e) * P.p_d * fhet
    c = (1.0 - P.p_e) * (1.0 - P.p_d) * fhom
    Z = max(a + b + c, 1e-300)
    phet, phom = b / Z, c / Z
    return HET if (x == 1 or phet >= phom) else HOM


def classify_labels(multiplicities: np.ndarray, P: KGParams) -> np.ndarray:
    """Classify a whole array of multiplicities.

    Computed once per *distinct* multiplicity with the exact scalar rule,
    then broadcast — bit-identical to per-element classification."""
    mult = np.asarray(multiplicities, np.int64)
    uniq, inv = np.unique(mult, return_inverse=True)
    labels_u = np.array([classify_multiplicity(int(x), P) for x in uniq], np.int8)
    return labels_u[inv]
