"""The remat policies on the CPU: checkpointing the trunks or each
bottleneck block gives the gradients and the new running statistics of no
remat, at the toy shapes of tests/test_full_parity.py:245."""

import pytest
import torch

from mgnns_tpu_torch.utils import tree_leaves
from tests.torch_train_common import build_toy, fusion_case, port_fusion


@pytest.fixture(scope="module")
def toy():
    return build_toy()


@pytest.mark.parametrize("policy", ["trunk", "block", "trunk+block"])
def test_remat_policies_same_grads_and_stats(toy, policy):
    """Checkpointing the trunks or each block gives the gradients and the new
    running statistics of no remat: the statistics are updated once, though
    a rematerialized forward runs twice.  'block' wins over remat_trunks."""
    f = toy
    base = port_fusion(f, fusion_case(f, False))
    remat = port_fusion(f, fusion_case(
        f, False, remat_policy="trunk" if policy == "trunk" else "block",
        remat_trunks=policy == "trunk+block"))
    assert base[0] == pytest.approx(remat[0], rel=1e-6)
    for a, b in zip(tree_leaves(base[2]) + tree_leaves(base[3]),
                    tree_leaves(remat[2]) + tree_leaves(remat[3])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
