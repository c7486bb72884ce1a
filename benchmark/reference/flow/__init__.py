"""Plain reference of the flow: a frozen copy of the port's CPU paths for
the PIMPLE step with kEpsilon and the AMG-CG pressure solve, and of its
blockMesh, so that it builds its own mesh from the case's files."""
