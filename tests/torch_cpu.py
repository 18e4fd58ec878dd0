"""One intra-op thread for torch in the port's CPU tests.

The test suite runs under several pytest-xdist workers. With torch's
default of one OpenMP thread per core in each of them, the cores are
oversubscribed and each small op of the plain kernel versions waits at
OpenMP barriers for descheduled threads: under six workers on eight
cores the port's six heaviest test files took 515 s, and 170 s with one
thread each (a test of 0.6 s alone took 236 s).
Every tests/test_torch_*.py file but test_torch_gpu.py, which also runs
alone on the card's machine, imports this module.
"""
import torch

torch.set_num_threads(1)
