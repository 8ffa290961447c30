"""Test-process settings shared by every test directory.

Torch runs its CPU work on two threads in each test process.  The suite runs
in several parallel workers on one host (six in the usual ``-n 6`` run), and
torch's default of a thread per core in each of them oversubscribes the
cores and slows every worker many times over.  Setting it here, once per
process at import, covers every test module, including ones that never ask
for it; a test that needs another count sets it and restores what it found.
"""

import torch

torch.set_num_threads(2)
