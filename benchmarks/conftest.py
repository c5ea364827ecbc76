"""Under pytest-xdist (``python -m pytest benchmarks/tests -n 4``), each
worker runs torch on its share of the host's cores. Four workers each on
every core oversubscribe the host, and a serving test's window, which has
to serve its sampled requests within seconds, can then end before they
are served."""

import os


def pytest_configure(config):
    workers = os.environ.get("PYTEST_XDIST_WORKER_COUNT")
    if workers:
        import torch

        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(workers)))
