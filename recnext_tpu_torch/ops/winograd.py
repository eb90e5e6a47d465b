"""Winograd depthwise convolution: F(m x m, r x r) for a stride-1 SAME depthwise conv.

Counterpart of ``recnext_tpu/ops/winograd.py`` in NCHW with (C, 1, r, r) weights.
F(2,5) computes 2x2 outputs from a 6x6 tile with 36 elementwise multiplies (9 a
output against the direct form's 25); the tile extraction and the transforms are
folded into two dense matrices an axis (``_axis_matrices``), so a conv is four small
matmuls and one elementwise product in the transform domain.

The matrices are derived exactly (``Fraction``) for any F(m, r) by Cook-Toom on the
transposed problem, then row-balanced so that transform-domain values stay O(1);
``winograd_matrices`` is the JAX module's numpy code, copied (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

# interpolation points for the finite part (0, ±1, ±2, ±3, ... as needed)
_POINTS = [0, 1, -1, 2, -2, 3, -3, 4, -4, 5, -5]


@functools.lru_cache(maxsize=None)
def winograd_matrices(m: int, r: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(AT (m,a), G (a,r), BT (a,a)) with a = m+r-1 such that for d in R^a,
    g in R^r:  y_k = sum_i g_i d_{k+i}  ==  AT @ [(G @ g) * (BT @ d)]."""
    a = m + r - 1
    pts = [Fraction(p) for p in _POINTS[:a - 1]]

    # Full conv s = conv(g, e), e in R^m: s(x) = g(x) e(x), deg a-1.
    # Evaluations: s(p_j) for finite points + leading coeff s_{a-1}=g_{r-1}e_{m-1}.
    def vand(n_coeffs):
        rows = [[p ** i for i in range(n_coeffs)] for p in pts]
        rows.append([Fraction(0)] * (n_coeffs - 1) + [Fraction(1)])
        return rows

    V_g = vand(r)
    V_e = vand(m)

    def poly_mul(p, q):
        out = [Fraction(0)] * (len(p) + len(q) - 1)
        for i, pi in enumerate(p):
            for j, qj in enumerate(q):
                out[i + j] += pi * qj
        return out

    N = [Fraction(1)]
    for p in pts:
        N = poly_mul(N, [-p, Fraction(1)])

    def poly_eval(c, x):
        acc = Fraction(0)
        for ci in reversed(c):
            acc = acc * x + ci
        return acc

    lagr = []  # coefficient vectors (deg <= a-2, padded to a)
    for j, pj in enumerate(pts):
        num = [Fraction(1)]
        den = Fraction(1)
        for k, pk in enumerate(pts):
            if k != j:
                num = poly_mul(num, [-pk, Fraction(1)])
                den *= pj - pk
        lagr.append([c / den for c in num] + [Fraction(0)] * (a - len(num)))

    A_full = [[Fraction(0)] * a for _ in range(a)]  # (a coeffs, a evals)
    for j in range(a - 1):
        for c in range(a):
            A_full[c][j] = lagr[j][c]
    for c in range(a):  # infinity column: N - sum_j N(p_j) * lagr_j
        A_full[c][a - 1] = N[c] - sum(poly_eval(N, pts[j]) * lagr[j][c]
                                      for j in range(a - 1))

    # transposition principle: AT = V_e^T, G = V_g, BT = A_full^T
    AT = np.array([[float(V_e[j][k]) for j in range(a)] for k in range(m)])
    G = np.array([[float(x) for x in row] for row in V_g])
    BT = np.array([[float(A_full[c][j]) for c in range(a)] for j in range(a)])

    # row-norm balancing; the diagonal scales commute through the product into AT
    sb = np.linalg.norm(BT, axis=1)
    sg = np.linalg.norm(G, axis=1)
    BT = BT / sb[:, None]
    G = G / sg[:, None]
    AT = AT * (sb * sg)[None, :]

    rng = np.random.default_rng(0)
    g = rng.integers(-3, 4, r).astype(np.float64)
    d = rng.integers(-3, 4, a).astype(np.float64)
    want = np.array([np.dot(g, d[k:k + r]) for k in range(m)])
    got = AT @ ((G @ g) * (BT @ d))
    if not np.allclose(got, want, atol=1e-8):
        raise AssertionError(f"F({m},{r}) matrices fail their check: {got} != {want}")
    return AT, G, BT


@functools.lru_cache(maxsize=None)
def _axis_matrices(size: int, m: int, r: int):
    """Tile extraction + the Winograd transforms along one axis as two dense matrices:
    (W_in (size+r-1 padded, n_tiles*a), W_out (n_tiles*a, size), n_tiles, pad_len),
    so that xp @ W_in holds the BT-transformed tiles of a padded axis vector and
    t @ W_out scatters AT-transformed tiles back to ``size`` outputs."""
    AT, G, BT = winograd_matrices(m, r)
    a = m + r - 1
    n_tiles = -(-size // m)
    pad_len = n_tiles * m + r - 1
    W_in = np.zeros((pad_len, n_tiles * a), np.float32)
    for t in range(n_tiles):
        for u in range(a):
            for v in range(a):
                W_in[t * m + v, t * a + u] = BT[u, v]
    W_out = np.zeros((n_tiles * a, size), np.float32)
    for t in range(n_tiles):
        for k in range(m):
            o = t * m + k
            if o < size:
                for u in range(a):
                    W_out[t * a + u, o] = AT[k, u]
    return W_in, W_out, n_tiles, pad_len


def dw_conv_winograd(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None, *,
                     m: int = 2, transform_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Depthwise stride-1 SAME conv by 2-D Winograd F(m x m, r x r): x (B, C, H, W),
    w (C, 1, r, r). The transforms and the elementwise product run in
    ``transform_dtype`` (fp32 by default: the transform domain loses bits of bf16's
    range), their matmuls summing in fp32; only the output is cast back to x's dtype."""
    r = int(w.shape[-1])
    B, C, H, W = (int(s) for s in x.shape)
    pad = r // 2
    Wh_in, Wh_out, nth, ph = _axis_matrices(H, m, r)
    Ww_in, Ww_out, ntw, pw = _axis_matrices(W, m, r)
    a = m + r - 1
    _, G, _ = winograd_matrices(m, r)

    def mat(arr):
        return torch.from_numpy(np.ascontiguousarray(arr)).to(x.device, transform_dtype)

    def matmul(lhs, rhs):  # summed in fp32, rounded to transform_dtype
        return torch.matmul(lhs.float(), rhs.float()).to(transform_dtype)

    Gt = mat(G)
    kt = torch.einsum("ui,cij,vj->cuv", Gt.float(), w[:, 0].to(transform_dtype).float(),
                      Gt.float()).to(transform_dtype)  # (C, a, a); no flip: correlation
    xp = F.pad(x, (pad, pw - W - pad, pad, ph - H - pad)).to(transform_dtype)
    # input transform along H, then W (tile extraction folded into the matrices)
    xt = matmul(xp.transpose(2, 3), mat(Wh_in)).transpose(2, 3)      # (B, C, nth*a, pw)
    xt = matmul(xt, mat(Ww_in))                                      # (B, C, nth*a, ntw*a)
    yt = xt.view(B, C, nth, a, ntw, a) * kt.view(1, C, 1, a, 1, a)
    yt = yt.reshape(B, C, nth * a, ntw * a)
    # output transform and scatter back to (H, W)
    y = matmul(yt.transpose(2, 3), mat(Wh_out)).transpose(2, 3)      # (B, C, H, ntw*a)
    y = torch.matmul(y.float(), mat(Ww_out).float())                 # (B, C, H, W)
    y = y.to(x.dtype)
    if b is not None:
        y = y + b.to(y.dtype).view(1, -1, 1, 1)
    return y
