"""Shared set-up of the PyTorch port's tests (every ``tests/test_torch_*.py``
imports this module first).

The port's tests run beside the JAX package's under several pytest
workers on a machine with few cores.  Torch would start one intra-op
thread per core in every worker; with the workers' XLA thread pools on
top, the machine is oversubscribed many times over, and a JAX test that
is sensitive to timing can fail in one run and pass in the next.  The
port's CPU tests are small (a few thousand lanes), so one thread each is
also the faster setting.
"""

import torch

torch.set_num_threads(1)

CPU = torch.device("cpu")   # the port allocates on the card unless told otherwise
