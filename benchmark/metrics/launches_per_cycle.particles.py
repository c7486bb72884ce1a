"""Device operations (kernels, copies, fills) a sub-step, from the profile
of the traced window: all of them over the sub-steps the window ran."""


def read(data):
    trace = data.get("trace")
    if not trace or not data.get("cycles"):
        return None
    return trace["n_device_ops"] / data["cycles"]
