"""CG iterations of the pressure solves a step: ``FlowSolver.advance``'s
``p_iters`` summed over the traced window's steps, over the steps."""


def read(data):
    if not data.get("steps"):
        return None
    return data["cg_iterations"] / data["steps"]
