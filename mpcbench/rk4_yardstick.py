"""The yardstick of the rk4 linearization: the least time one tick's
``lin`` could take on the card, from the bytes its inputs and outputs need
(from shapes) and the operations its outputs need (a closed-form count).

One row is one (x, u) stage point; a tick linearizes B N rows at once
(``doa.rk4_lin``), each to Phi = rk4(x, u, h) and its Jacobians A = dPhi/dx
and B = dPhi/du, for the unicycle f(s, u) = (v cos psi, v sin psi, omega,
a, alpha) with nx = 5, nu = 2, in float32.

Bytes a row: x (5) and u (2) read once, Phi (5), A (25) and B (10)
written once: 47 values, 188 bytes.

Operations a row, counted under ``opcount/op_count.cpp``'s rules (add,
subtract, multiply, divide, square root, sine and cosine count one each;
negation does not; an operation with a literal 0 or 1 is none; each
distinct operation once; only what an output depends on), in forward mode
with the tangents' known zeros and ones, as RK4 reads: k1 = f(x, u),
z2 = x + h/2 k1, k2 = f(z2, u), z3 = x + h/2 k2, k3 = f(z3, u),
z4 = x + h k3, k4 = f(z4, u), Phi = x + h/6 (k1 + 2 k2 + 2 k3 + k4):

| part | Phi | A and B |
|---|---|---|
| k1: cos psi, sin psi, v cos, v sin; dk1: -v sin | 4 | 1 |
| z2: its psi, v and omega rows (f reads no other) | 6 | 0 |
| k2; dk2 over the psi, v, omega, a and alpha columns z2 fills | 4 | 6 |
| z3: its psi row (its v and omega rows are z2's) | 2 | 0 |
| k3; dk3 now over every column (z3's psi row has the alpha column) | 4 | 10 |
| z4: its psi, v and omega rows | 6 | 0 |
| k4; dk4 | 4 | 10 |
| Phi; the x and y rows' Jacobians (the other rows' are literals) | 32 | 44 |
| a row | 62 | 71 |

On the psi, v and omega rows of Phi, 2 k3 is 2 k2, counted once. So a row
needs 133 operations. The bytes bound a row by 188 B / 3.35 TB/s =
0.0561 ns against 133 / 67 TFLOP/s = 0.00199 ns: the bound is set by
bytes, 0.147 ms at B = 131,072 and N = 20; any count under about 3,700
operations a row would give the same bound.
"""

from __future__ import annotations

from mpcbench import yardstick

NX, NU = 5, 2
BYTES_PER_ROW = 4 * (NX + NU + NX + NX * NX + NX * NU)
PHI_OPS_PER_ROW, JAC_OPS_PER_ROW = 62, 71
OPS_PER_ROW = PHI_OPS_PER_ROW + JAC_OPS_PER_ROW


def lin_bytes(rows: int) -> int:
    return BYTES_PER_ROW * rows


def lin_ops(rows: int) -> int:
    return OPS_PER_ROW * rows


def bound_s(rows: int) -> float:
    """The least seconds one linearization of ``rows`` rows could take."""
    return yardstick.bound_s(lin_bytes(rows), lin_ops(rows))
