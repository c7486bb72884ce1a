"""Host milliseconds a coupled step spent refreshing the particles' tet table
from the new U (the program's ``Refresh`` spans: the read of U off the
device, the host table's rebuild and its upload), over the traced window's
steps."""

from harness.spans import total_ms, window


def read(data):
    spans = window(data)
    if not spans or not data.get("steps"):
        return None
    return total_ms(spans, {"Refresh"}) / data["steps"]
