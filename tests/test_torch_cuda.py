"""The port on the card: each CUDA kernel against its plain version, and a
forward on the card against the same forward on the CPU.

This file imports neither JAX nor the JAX package, so it also runs where
those are absent: ``python -m pytest --noconftest tests/test_torch_cuda.py``
on a machine with an NVIDIA GPU.  Without a card every test here skips.
"""

import numpy as np
import pytest
import torch

from mgnns_tpu_torch.kernels import edge_max
from mgnns_tpu_torch.models.text_only import text_model_apply, text_model_init


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(16, 100, 300, 4), (3, 7, 5, 2)])
def test_edge_max_kernel_equals_plain(cuda_device, shape):
    """K1 against its plain version on the card, exactly (one float32
    multiply and a max each), with lens 0, 1 and L and a NaN message."""
    B, L, D, ngram = shape
    g = torch.Generator(device=cuda_device).manual_seed(0)
    emb = torch.randn(B, L, D, generator=g, device=cuda_device)
    w = torch.randn(B, L, 2 * ngram + 1, generator=g, device=cuda_device)
    lens = torch.randint(0, L + 1, (B,), generator=g, device=cuda_device, dtype=torch.int32)
    lens[0], lens[1], lens[-1] = 0, 1, L
    emb[-1, 0, 0] = float("nan")
    before = edge_max.launches
    got = edge_max.window_max_aggregate(emb, w, lens, ngram)
    torch.cuda.synchronize()
    assert edge_max.launches == before + 1
    want = edge_max.window_max_aggregate_plain(emb, w, lens, ngram)
    torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_text_model_on_card_matches_cpu(cuda_device):
    """The text-only model through K1 on the card against the same weights on
    the CPU (plain version): float32 sums in another order, so 1e-5."""
    V, E, B, L, ngram = 50, 40, 4, 12, 2
    params = text_model_init(V, 7, E, seed=0, device=cuda_device)
    r = np.random.default_rng(0)
    lens = np.array([1, 5, 12, 9], np.int32)
    ids = r.integers(1, V, (B, L)).astype(np.int32)
    ids[np.arange(L)[None, :] >= lens[:, None]] = 0
    eids = r.integers(0, E, (B, L, 2 * ngram + 1)).astype(np.int32)
    batch = {"ids": ids, "lens": lens, "eids": eids}
    with torch.inference_mode():
        got = text_model_apply(params, {k: torch.from_numpy(v).to(cuda_device)
                                        for k, v in batch.items()}, ngram=ngram)
        cpu_params = {k: {kk: vv.cpu() for kk, vv in v.items()} for k, v in params.items()}
        want = text_model_apply(cpu_params, {k: torch.from_numpy(v) for k, v in batch.items()},
                                ngram=ngram)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
