"""Particle calls a coupled step (the program's counter
``coupled.advect_calls``, one a ``run_cycles`` or ``engine.advance`` call,
summed over the traced window's outermost spans), over the window's steps."""

from harness.spans import recorder, window


def read(data):
    spans, rec = window(data), recorder()
    if not spans or not data.get("steps"):
        return None
    calls = rec.counts().get("coupled.advect_calls")
    return None if calls is None else calls / data["steps"]
