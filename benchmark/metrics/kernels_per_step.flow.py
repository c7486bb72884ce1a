"""Device operations (kernels, copies, fills) a step, from the profile of
the traced window: all of them over the window's steps."""


def read(data):
    trace = data.get("trace")
    if not trace or not data.get("steps"):
        return None
    return trace["n_device_ops"] / data["steps"]
