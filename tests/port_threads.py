"""How many CPU threads a port test process uses, decided once.

Every ``tests/test_torch_port_*.py`` imports this module. The rule is the
program's own for CPU ranks (``spoofsv_torch.parallel.multihost.cpu_threads``):
the host's cores shared out among the processes that run at once, here the
pytest-xdist workers. Under ``-n 6`` on 8 cores a worker gets one intra-op
thread, so six workers' torch pools no longer oversubscribe the cores; a file
run by hand without xdist keeps every core. Once any port file has imported
this module, the rule holds for the whole worker process. Spawned CPU ranks
set their own share in ``multihost``.

``OMP_NUM_THREADS`` is left alone. Child processes would read it as they
load their math libraries, while this process loaded numpy before the rule
ran; tests that compare a child's arrays byte for byte with this process's
(the JAX campaign script's mels, the mesh ranks' replay batches) then part
by an ulp.
"""

import os

import torch

from spoofsv_torch.parallel.multihost import cpu_threads

THREADS = cpu_threads(int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1")))
torch.set_num_threads(THREADS)
