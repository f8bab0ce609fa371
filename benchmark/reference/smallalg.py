"""Unrolled small-matrix algebra over batched scalars (SoA layout).

PyTorch copy of the JAX package's ``ops/smallalg.py``. Each scalar
component is a full (B,) tensor (one env per element), and all 3×3/6×6
algebra is unrolled at Python level into elementwise ops.

Representation:
- a "scalar" is a tensor of shape (B,) (or any broadcastable shape),
  or a Python float (a constant);
- a vector is a Python list of scalars; a matrix is a list of lists.

Python-level literal folding (zeros/ones short-circuiting) keeps the
emitted op sequence minimal: multiplications by literal 0.0/±1.0 never
reach a kernel. Folding only drops operations whose result is exact
(x·0, x·1, x+0), so the CUDA kernel, which writes the same algebra out
densely, rounds at the same places.
"""

from __future__ import annotations

from typing import List, Sequence, Union

import torch

Scalar = Union[float, torch.Tensor]
Vec = List[Scalar]
Mat = List[List[Scalar]]


def _is_lit(x) -> bool:
    return isinstance(x, (int, float))


def smul(a: Scalar, b: Scalar) -> Scalar:
    """Scalar multiply with literal folding."""
    if _is_lit(a):
        if a == 0.0:
            return 0.0
        if a == 1.0:
            return b
        if a == -1.0:
            return sneg(b)
    if _is_lit(b):
        if b == 0.0:
            return 0.0
        if b == 1.0:
            return a
        if b == -1.0:
            return sneg(a)
    return a * b


def sneg(a: Scalar) -> Scalar:
    return -a


def sadd(a: Scalar, b: Scalar) -> Scalar:
    if _is_lit(a) and a == 0.0:
        return b
    if _is_lit(b) and b == 0.0:
        return a
    return a + b


def ssub(a: Scalar, b: Scalar) -> Scalar:
    if _is_lit(b) and b == 0.0:
        return a
    if _is_lit(a) and a == 0.0:
        return sneg(b)
    return a - b


def sdot(xs: Sequence[Scalar], ys: Sequence[Scalar]) -> Scalar:
    acc: Scalar = 0.0
    for x, y in zip(xs, ys):
        acc = sadd(acc, smul(x, y))
    return acc


# ---- vectors ----------------------------------------------------------------

def vadd(a: Vec, b: Vec) -> Vec:
    return [sadd(x, y) for x, y in zip(a, b)]


def vsub(a: Vec, b: Vec) -> Vec:
    return [ssub(x, y) for x, y in zip(a, b)]


def vscale(k: Scalar, a: Vec) -> Vec:
    return [smul(k, x) for x in a]


def vneg(a: Vec) -> Vec:
    return [sneg(x) for x in a]


def cross(a: Vec, b: Vec) -> Vec:
    return [
        ssub(smul(a[1], b[2]), smul(a[2], b[1])),
        ssub(smul(a[2], b[0]), smul(a[0], b[2])),
        ssub(smul(a[0], b[1]), smul(a[1], b[0])),
    ]


# ---- matrices ---------------------------------------------------------------

def mT(M: Mat) -> Mat:
    n, m = len(M), len(M[0])
    return [[M[j][i] for j in range(n)] for i in range(m)]


def mv(M: Mat, v: Vec) -> Vec:
    return [sdot(row, v) for row in M]


def mm(A: Mat, B: Mat) -> Mat:
    Bt = mT(B)
    return [[sdot(row, col) for col in Bt] for row in A]


def madd(A: Mat, B: Mat) -> Mat:
    return [[sadd(x, y) for x, y in zip(ra, rb)] for ra, rb in zip(A, B)]


def msub(A: Mat, B: Mat) -> Mat:
    return [[ssub(x, y) for x, y in zip(ra, rb)] for ra, rb in zip(A, B)]


def mscale(k: Scalar, A: Mat) -> Mat:
    return [[smul(k, x) for x in row] for row in A]


def outer(a: Vec, b: Vec) -> Mat:
    return [[smul(x, y) for y in b] for x in a]


def skew(v: Vec) -> Mat:
    x, y, z = v
    return [[0.0, sneg(z), y],
            [z, 0.0, sneg(x)],
            [sneg(y), x, 0.0]]


def eye(n: int) -> Mat:
    return [[1.0 if i == j else 0.0 for j in range(n)] for i in range(n)]


def rot_x(c: Scalar, s: Scalar) -> Mat:
    return [[1.0, 0.0, 0.0], [0.0, c, sneg(s)], [0.0, s, c]]


def rot_y(c: Scalar, s: Scalar) -> Mat:
    return [[c, 0.0, s], [0.0, 1.0, 0.0], [sneg(s), 0.0, c]]


# ---- solvers ----------------------------------------------------------------

def cholesky_solve(A: Mat, b: Vec) -> Vec:
    """Solve A x = b for SPD A via fully unrolled Cholesky (batched scalars).

    Used for the 6×6 floating-base articulated inertia solve.
    """
    n = len(A)
    L: list[list[Scalar]] = [[0.0] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[i][j]
            for k in range(j):
                s = ssub(s, smul(L[i][k], L[j][k]))
            if i == j:
                L[i][j] = torch.sqrt(s) if not _is_lit(s) else float(s) ** 0.5
            else:
                L[i][j] = s / L[j][j]
    # forward substitution L y = b
    y: list[Scalar] = [0.0] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = ssub(s, smul(L[i][k], y[k]))
        y[i] = s / L[i][i]
    # back substitution Lᵀ x = y
    x: list[Scalar] = [0.0] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = ssub(s, smul(L[k][i], x[k]))
        x[i] = s / L[i][i]
    return x


# ---- packing to and from tensors --------------------------------------------

def from_leading(arr: torch.Tensor, n: int) -> Vec:
    """(n, B) tensor → list of n (B,) scalars."""
    return [arr[i] for i in range(n)]


def to_leading(v: Vec) -> torch.Tensor:
    """List of (B,) scalars → (n, B) tensor."""
    return torch.stack([torch.as_tensor(x) for x in v], dim=0)


def broadcast_lits(v: Vec, like: torch.Tensor) -> Vec:
    """Float literals replaced by tensors shaped like ``like`` (for
    stacking)."""
    return [torch.full_like(like, x) if _is_lit(x) else x for x in v]
