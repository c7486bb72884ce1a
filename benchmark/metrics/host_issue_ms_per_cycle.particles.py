"""Host milliseconds to issue one sub-step of ``run_cycles``: the traced
run's synchronised calls after its window, each issued onto an idle device,
timed on the host clock from the call to its return (the median of the
calls), divided by the call's sub-steps."""


def read(data):
    return data.get("host_issue_ms_per_cycle")
