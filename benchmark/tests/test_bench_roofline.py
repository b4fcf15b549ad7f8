"""The yardstick's arithmetic (GPT-2's counts, ``archs/gpt2.py``) pinned to
hand-computed values: one ref-block round, one gpt2-small round, the
contexts they see and the model FLOPs."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import spec

gpt2 = spec.arch("gpt2")


def test_ref_block_round_bound():
    """1024 live slots at context 100 through the fused int4 write (D 2048,
    packed rows of 1024 bytes, 4 pages a slot of 32 rows):
    q, k_new, v_new 3 * 1024 * 2048 * 2 = 12,582,912 B; K and V rows
    2 * 102,400 * 1024 = 209,715,200 B; scales 2 * 4096 pages * 4 =
    32,768 B; o, length and table row 1024 * (8192 + 4 + 16) =
    8,409,088 B; 230,739,968 B over 3.35 TB/s = 68.877 us, above the
    838,860,800 multiply-add FLOPs' 12.52 us."""
    got = gpt2.grouped_bound_s(np.full(1024, 100), D=2048, Dk=1024,
                               W=4, P=32, in_bytes=2, pool_bytes=1,
                               scaled=True)
    assert got == pytest.approx(230_739_968 / 3.35e12, rel=1e-12)


def test_gpt2_small_round_bound():
    """1024 live slots whose page partial reads 800 rows (D 768, 12 heads,
    int8): q 1,572,864 B; K and V 1,258,291,200 B; scales 25,600 pages *
    8 = 204,800 B; o, m, l, length, ring start and table entry 1024 *
    3180 = 3,256,320 B; 1,263,325,184 B a layer, 377.11 us, times 12
    layers."""
    got = gpt2.partial_bound_s(np.full(1024, 800), D=768, Dk=768, H=12,
                               P=32, in_bytes=2, pool_bytes=1,
                               scaled=True, n_layers=12)
    assert got == pytest.approx(12 * 1_263_325_184 / 3.35e12, rel=1e-12)


def test_contexts():
    assert gpt2.decode_contexts(5, 3).tolist() == [5, 6, 7]
    # admitted at a span's start: the pages hold the prompt but its last
    # token for the first span, then grow a span at a time
    assert gpt2.ring_partial_rows(5, 6, 4).tolist() == [4, 4, 4, 4, 8, 8]


def test_attention_bound_follows_the_config():
    reqs = [([1] * 5, [2] * 3)]
    ref = spec.config("ref-block")
    assert gpt2.attention_bound_s(ref, reqs) == pytest.approx(
        gpt2.grouped_bound_s(np.array([5, 6, 7]), 2048, 1024, 4, 32, 2,
                             1, True))
    gpt = spec.config("gpt2-small")
    assert gpt2.attention_bound_s(gpt, reqs) == pytest.approx(
        gpt2.partial_bound_s(np.array([4, 4, 4]), 768, 768, 12, 32, 2,
                             1, True, 12))


def test_model_flops_hand_case():
    """A 2-layer model, D 2, F 4, V 3, with the output projection: a
    request of prompt 3 and 2 served tokens. Prefill: positions 0, 1
    through layer 0 (proj 2*2*2*4 = 32 and FFN 4*2*4 = 32 FLOPs each,
    attention over 1 and 2 positions 4*2*3 = 24) and the last layer's
    k, v (2 * 16 = 32); decode: positions 2, 3 through both layers
    (2 * 2 * 64) with logits (2 * 12) and attention over 3 and 4
    positions (2 layers * 4*2*7 = 112)."""
    m = dict(emb_dim=2, n_vocab=3, ffn_dim=4, n_layers=2,
             use_output_proj=True)
    want = (2 * 64 + 24 + 32) + (2 * 2 * 64 + 2 * 12 + 112)
    assert gpt2.model_flops(m, 3, 2) == want


def test_ref_block_decode_token_flops():
    """The reference block: ~30 MFLOP a served token at context ~100."""
    m = spec.config("ref-block")["model"]
    per = (gpt2.model_flops(m, 1, 101) - gpt2.model_flops(m, 1, 1)
           ) / 100
    assert 29e6 < per < 31e6
