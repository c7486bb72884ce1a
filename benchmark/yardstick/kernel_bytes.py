"""Bytes a kernel call must move: each input byte read once and each
output byte written once, at the counts of the work at hand.  A frozen copy
of the program's own arithmetic for ``stream_kernel`` (TetVelocity layout,
the whole pass, noise drawn outside the kernel), so that a later change to
the program cannot move the yardstick.

``stream_kernel``: reads every lane's mega row (32 columns), its noise (3
columns) and one table row (20 columns) per hop; writes every lane's head
(8 columns), the table row of each lane whose row changed, and its pending
byte.
"""

MEGA_W, ROW_W, HEAD_W, NOISE_W = 32, 20, 8, 3


def stream_bytes(n: int, elem: int, rows_loaded: float, rows_changed: float) -> float:
    read = n * MEGA_W * elem + n * NOISE_W * elem + rows_loaded * ROW_W * elem
    written = n * HEAD_W * elem + rows_changed * ROW_W * elem + n
    return read + written
