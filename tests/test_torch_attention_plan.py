"""Kernel D's key split on the CPU (`ops/cuda/attention.key_splits`): how
many ways a call's keys are split, at the shapes the benchmark's pair
cells and a single image pair give the kernel. The extraction and MNN
cells run no attention."""

import pytest

from accelerated_features_tpu_torch.ops.cuda.attention import key_splits

H100_SMS = 132


@pytest.mark.parametrize("what,shape,want", [
    ("lightglue.pairs-k4096-b8: 8 pairs x 4 heads", (32, 4096, 4096), 1),
    ("lg.pairs-k4096-b8: 8 pairs, one head", (8, 4096, 4096), 1),
    ("lg.pairs-k1024-b32: 32 pairs at 1024 points", (32, 1024, 1024), 1),
    ("one LighterGlue pair (B = 1)", (1, 4096, 4096), 4),
    ("one LightGlue pair (B = 1, 4 heads)", (4, 4096, 4096), 1),
    ("one LightGlue pair at 2048 points", (4, 2048, 2048), 2),
    ("one pair at 4001 keys", (1, 4096, 4001), 4),
])
def test_key_splits_at_the_cells_shapes(what, shape, want):
    assert key_splits(*shape, H100_SMS) == want, what


def test_key_splits_keep_one_wave_and_no_empty_split():
    """Every split owns at least one 64-key tile (the wgmma kernel's
    32-key tiles at D = 96 follow from it), and a split grid never has
    more blocks than the card has SMs."""
    for b in (1, 2, 4, 8, 32):
        for nq in (1, 65, 128, 1000, 4096):
            for nk in (1, 64, 65, 2111, 4001, 4096, 70000):
                splits = key_splits(b, nq, nk, H100_SMS)
                q_tiles, k_tiles = -(-nq // 128), -(-nk // 64)
                per = -(-k_tiles // splits)
                assert 1 <= splits <= min(k_tiles, 16)
                assert -(-k_tiles // per) == splits
                if splits > 1:
                    assert b * q_tiles * splits <= H100_SMS
