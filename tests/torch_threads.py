"""Imported by the port's test files (tests/test_torch_*.py) for one effect:
torch runs one intra-op thread.  The tests run at af2_tiny / reduced shapes,
where more threads do not shorten a test, and the suite runs in several
worker processes that would otherwise each start a thread per core.  No
JAX here: the ``cuda`` tests that import it run on a machine without it."""
import torch

torch.set_num_threads(1)
