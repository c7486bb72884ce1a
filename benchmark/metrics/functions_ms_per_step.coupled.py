"""Host milliseconds a coupled step spent in the function objects (the
program's ``Functions`` spans: the probes' sample and scalarTransport's
step), over the traced window's steps."""

from harness.spans import total_ms, window


def read(data):
    spans = window(data)
    if not spans or not data.get("steps"):
        return None
    return total_ms(spans, {"Functions"}) / data["steps"]
