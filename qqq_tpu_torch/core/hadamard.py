"""Hadamard / orthogonal matrix construction for QuaRot-style rotation
(the port's own copy of qqq_tpu/core/hadamard.py: numpy only, float64, so
the rotation Q is the JAX package's bit for bit).

The reference vendors ~97k lines of ±1 constants from Sloane's tables
(QQQ/rotation/hadamard_utils.py:189-97467) for the non-power-of-2 factors
K ∈ {12, 20, 28, 36, 40, 52, 60, 108, 140, 156, 172} needed by Llama-family
hidden/intermediate dims.  We instead *construct* them:

* powers of 2: Sylvester doubling;
* K = q+1 for prime-power q ≡ 3 (mod 4): Paley I (12, 20, 44, 60, 108, 140);
* K = 2(q+1) for prime-power q ≡ 1 (mod 4): Paley II (28, 36, 52);
* 40 = 2 × 20: Sylvester step on Paley I(19).

156 and 172 are Williamson-type orders with no Paley construction; for those
we embed Sloane's public ±1 tables bit-packed (`core/hadamard_tables.py`,
~16 KB vs the reference's ~30k vendored float lines per matrix) and validate
them on first decode.

All constructions are exact integer ±1 matrices validated by H·Hᵀ = n·I.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np

# priority order mirrors reference get_hadK (hadamard_utils.py:7-57)
_K_ORDER = (172, 156, 140, 108, 60, 52, 36, 28, 40, 20, 12)


def _prime_power(q: int) -> Optional[Tuple[int, int]]:
    for p in range(2, int(q**0.5) + 1):
        if q % p == 0:
            k = 0
            while q % p == 0:
                q //= p
                k += 1
            return (p, k) if q == 1 else None
    return (q, 1) if q > 1 else None


class _GF:
    """Small finite field GF(p^k) with dense mult table (k small)."""

    def __init__(self, p: int, k: int):
        self.p, self.k, self.q = p, k, p**k
        if k == 1:
            self.mul_table = None
            return
        # find an irreducible monic polynomial of degree k over GF(p)
        import itertools

        def polymulmod(a, b, mod):
            res = [0] * (len(a) + len(b) - 1)
            for i, ai in enumerate(a):
                for j, bj in enumerate(b):
                    res[i + j] = (res[i + j] + ai * bj) % p
            # reduce by mod (monic, degree k)
            while len(res) > k:
                lead = res[-1]
                d = len(res) - 1 - k
                for i in range(k + 1):
                    res[d + i] = (res[d + i] - lead * mod[i]) % p
                while res and res[-1] == 0:
                    res.pop()
            return res + [0] * (k - len(res)) if len(res) < k else res[:k]

        def is_irreducible(poly):
            # no roots and (for k<=3) no linear factors suffices for k in {2,3}
            for x in range(p):
                v = 0
                for c in reversed(poly):
                    v = (v * x + c) % p
                if v == 0:
                    return False
            return True

        mod = None
        for tail in itertools.product(range(p), repeat=k):
            poly = list(tail) + [1]  # monic degree k
            if is_irreducible(poly):
                mod = poly
                break
        assert mod is not None
        self.mod = mod
        els = list(itertools.product(range(p), repeat=k))  # coeff tuples
        self.els = [tuple(e) for e in els]
        idx = {e: i for i, e in enumerate(self.els)}
        self.mul_table = np.zeros((self.q, self.q), dtype=np.int64)
        for i, a in enumerate(self.els):
            for j, b in enumerate(self.els):
                prod = polymulmod(list(a), list(b), mod)
                self.mul_table[i, j] = idx[tuple(prod)]

    def elements(self):
        return range(self.q)

    def sub(self, i: int, j: int) -> int:
        if self.k == 1:
            return (i - j) % self.p
        a = self.els[i]
        b = self.els[j]
        return self.els.index(tuple((x - y) % self.p for x, y in zip(a, b)))

    def chi(self) -> np.ndarray:
        """Quadratic character: chi[x] = 0 if x==0 else ±1."""
        sq = set()
        for i in self.elements():
            s = self.mul_table[i, i] if self.k > 1 else (i * i) % self.p
            sq.add(int(s))
        out = np.zeros(self.q, dtype=np.int64)
        for i in self.elements():
            if i == 0 and self.k == 1:
                continue
            if self.k > 1 and self.els[i] == tuple([0] * self.k):
                continue
            out[i] = 1 if i in sq else -1
        return out


def _jacobsthal(q: int) -> np.ndarray:
    """Q[i,j] = chi(a_i - a_j) over GF(q)."""
    pk = _prime_power(q)
    assert pk is not None, q
    gf = _GF(*pk)
    chi = gf.chi()
    Q = np.zeros((q, q), dtype=np.int64)
    for i in gf.elements():
        for j in gf.elements():
            Q[i, j] = chi[gf.sub(i, j)]
    return Q


def _paley1(q: int) -> np.ndarray:
    """Paley I: H of order q+1, q ≡ 3 (mod 4) prime power."""
    # H = I + S with skew conference S = [[0, 1], [-1, Q]] (Qᵀ = -Q here)
    Q = _jacobsthal(q)
    n = q + 1
    H = np.ones((n, n), dtype=np.int64)
    H[1:, 1:] = Q + np.eye(q, dtype=np.int64)
    H[1:, 0] = -1
    return H


def _paley2(q: int) -> np.ndarray:
    """Paley II: H of order 2(q+1), q ≡ 1 (mod 4) prime power."""
    Q = _jacobsthal(q)
    n = q + 1
    S = np.zeros((n, n), dtype=np.int64)
    S[0, 1:] = 1
    S[1:, 0] = 1
    S[1:, 1:] = Q
    I = np.eye(n, dtype=np.int64)
    H = np.block([[S + I, S - I], [S - I, -S - I]])
    return H


_PALEY = {
    12: ("p1", 11),
    20: ("p1", 19),
    28: ("p2", 13),
    36: ("p2", 17),
    44: ("p1", 43),
    52: ("p2", 25),
    60: ("p1", 59),
    108: ("p1", 107),
    140: ("p1", 139),
}


@functools.lru_cache(maxsize=None)
def hadamard_base(K: int) -> np.ndarray:
    """Exact ±1 Hadamard matrix of order K.

    K ∈ _PALEY, 40 (= 2·20), a power of 2, or the tabulated Williamson-type
    orders 156/172 (Sloane data, `core/hadamard_tables.py`).
    """
    if K & (K - 1) == 0:  # power of two: Sylvester
        H = np.array([[1]], dtype=np.int64)
        while H.shape[0] < K:
            H = np.block([[H, H], [H, -H]])
        return H
    if K == 40:
        H20 = hadamard_base(20)
        return np.block([[H20, H20], [H20, -H20]])
    if K in (156, 172):
        from . import hadamard_tables as _t

        rows = _t._HAD156_HEX if K == 156 else _t._HAD172_HEX
        H = _t.decode_rows(rows, K)
    else:
        kind, q = _PALEY[K]
        H = _paley1(q) if kind == "p1" else _paley2(q)
    assert np.array_equal(H @ H.T, K * np.eye(K, dtype=np.int64)), K
    return H


def get_hadK(n: int) -> Tuple[Optional[np.ndarray], int]:
    """Factor n = K · 2^m and return the order-K base block (None for K=1).

    Same divisibility priority as reference hadamard_utils.py:7-57; all
    eleven table orders (including 156/172) are exact ±1 Hadamard blocks.
    """
    def _orthogonal_block(K: int) -> np.ndarray:
        rng = np.random.default_rng(K)
        q_, r_ = np.linalg.qr(rng.standard_normal((K, K)))
        q_ *= np.sign(np.diag(r_))
        return q_ * np.sqrt(K)

    for K in _K_ORDER:
        if n % K == 0 and (n // K) & (n // K - 1) == 0:
            return hadamard_base(K).astype(np.float64), K
    if n & (n - 1) == 0:
        return None, 1
    # generic fallback beyond the reference's table (e.g. Qwen2-0.5B's
    # intermediate 4864 = 2^8·19): orthogonal block on the odd part
    K = n
    while K % 2 == 0:
        K //= 2
    if K in _PALEY:
        return hadamard_base(K).astype(np.float64), K
    return _orthogonal_block(K), K


def hadamard_matrix(n: int, normalized: bool = True) -> np.ndarray:
    """Full n×n (scaled-)Hadamard via base block ⊗ Sylvester doubling."""
    hadK, K = get_hadK(n)
    H = hadK if hadK is not None else np.array([[1.0]])
    m = n // K
    S = hadamard_base(m).astype(np.float64)  # m is a power of 2
    # base block on the slow axis, matching the reference's
    # view(-1, K, n//K) blocking in matmul_hadU_cuda (hadamard_utils.py:96-109)
    H = np.kron(H, S)
    if normalized:
        H = H / np.sqrt(n)
    return H


def random_hadamard_matrix(n: int, seed: int = 0) -> np.ndarray:
    """Randomized orthogonal Hadamard: H_n · diag(±1) / √n (QuIP#-style,
    hadamard_utils.py:88-93)."""
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2, size=n) * 2 - 1
    return hadamard_matrix(n, normalized=True) * d[None, :].astype(np.float64)
