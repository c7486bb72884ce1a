"""``stream_kernel``'s share of its byte bound, in percent: the bytes a call
must move (``yardstick/kernel_bytes.py``, at the table rows the reference
counted per sub-step over the window's last call) over the H100's
published HBM rate, divided by the kernel's mean time a call in the
profile of the traced window."""

from harness.trace import find_kernel
from yardstick.kernel_bytes import stream_bytes
from yardstick.peaks import HBM_BYTES_PER_S


def read(data):
    trace = data.get("trace")
    if not trace or "stream_rows_loaded_per_cycle" not in data:
        return None
    count, seconds = find_kernel(trace["kernels"], "stream_kernel")
    if not count or seconds <= 0:
        return None
    nbytes = stream_bytes(data["lanes"], data.get("elem", 4),
                          data["stream_rows_loaded_per_cycle"],
                          data["stream_rows_changed_per_cycle"])
    return 100.0 * (nbytes / HBM_BYTES_PER_S) / (seconds / count)
