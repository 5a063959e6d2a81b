"""State an xdist worker carries from one test file into the next, which
a port test file clears for itself. No test lives here.

``mxnet_tpu``'s SIGTERM trap chains to the port's (and the port's to
``mxnet_tpu``'s), so a test that sends its own process SIGTERM sets both
packages' preemption notices; one it does not clear would drain the next
``ShardedTrainer.step`` of the port in that worker. A test file that
steps a ``ShardedTrainer`` imports :func:`no_stale_preemption`, an
autouse fixture.
"""
import pytest


@pytest.fixture(autouse=True)
def no_stale_preemption():
    """Clear the port's preemption notice before each test."""
    from mxnet_tpu_torch.resilience import integrity

    integrity.clear_preempt()
    yield
