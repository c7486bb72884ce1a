"""Device milliseconds a step in the pressure solve's kernels
(``csrc/amg.cu``: ``fv_matvec_kernel`` and the ``amg_*`` kernels), by name
from the profile of the traced window, over the window's steps."""

from harness.trace import find_kernel

NAMES = ("fv_matvec_kernel", "amg_down_kernel", "amg_up_kernel", "amg_tail_kernel")


def read(data):
    trace = data.get("trace")
    if not trace or not data.get("steps"):
        return None
    seconds = sum(find_kernel(trace["kernels"], n)[1] for n in NAMES)
    if seconds <= 0:
        return None
    return seconds * 1e3 / data["steps"]
