"""Host milliseconds a coupled step spent in the particles' calls (the
program's ``Advect`` spans, one a ``run_cycles`` call), over the traced
window's steps."""

from harness.spans import total_ms, window


def read(data):
    spans = window(data)
    if not spans or not data.get("steps"):
        return None
    return total_ms(spans, {"Advect"}) / data["steps"]
