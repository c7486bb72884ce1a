"""Percent of the traced window in which no operation ran on the device:
100 (1 - busy / window), busy the union of the profile's device intervals."""

from harness.trace import idle_share_percent


def read(data):
    return idle_share_percent(data.get("trace"))
