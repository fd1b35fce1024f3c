"""The yardstick's arithmetic against shapes worked by hand."""

import json
from pathlib import Path

import numpy as np
import pytest

from portbench import counts

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_kept_pairs_by_hand():
    seg = np.array([[0, 0, 0, 1, 1, -1],      # 3*4/2 + 2*3/2 = 9
                    [0, 0, 0, 0, 0, 0]])      # 6*7/2 = 21
    assert counts.kept_pairs(seg) == 30


def test_flash_bound_by_hand():
    # b=1, s=128, nh=2, nkv=1, hd=64: K1 moves 2 * (2*16384 + 2*8192)
    # + 4*256 bytes = 99,328 B; 4 * 64 * 8256 pairs * 2 heads operations
    t = counts.flash_bound("flash_forward", 1, 128, 128, 2, 1, 64,
                           128 * 129 // 2)
    assert t == pytest.approx(max(99_328 / 3.35e12,
                                  4 * 64 * 8256 * 2 / 989e12))


def test_matmul_params_of_the_configurations():
    q = _cfg("qwen2-7b")
    d, f, V = 3584, 18944, 152064
    per_layer = d * 128 * (28 + 8) + 28 * 128 * d + 3 * d * f
    assert counts.matmul_params(q) == 28 * per_layer + d * V
    # bench.py's N for the whole model (its num_params), less the
    # embedding, the norms and the biases: 7.615 B parameters in all
    total = counts.matmul_params(q) + V * d + 28 * (2 * d + 128 * 36) + d
    assert total == 7_615_616_512
    m = _cfg("mixtral-8x7b-16l")
    d, f = 4096, 14336
    attn = d * 128 * (32 + 16) + 32 * 128 * d
    assert counts.matmul_params(m) == 16 * (attn + 6 * d * f + 8 * d) \
        + d * 32000
    assert counts.matmul_params(m, active=False) == \
        16 * (attn + 24 * d * f + 8 * d) + d * 32000


def test_train_flops_is_bench_formula_on_a_full_causal_row():
    q = _cfg("qwen2-7b-7l")
    s = 4096
    pairs = s * (s + 1) // 2
    per_token = 6 * counts.matmul_params(q) + 12 * 7 * 128 * 28 * (s + 1) / 2
    assert counts.train_flops(q, s, pairs) == pytest.approx(per_token * s)


def test_decode_tick_work_by_hand():
    q = _cfg("qwen2-7b")
    # two lanes at contexts 10 and 30: weights (bf16 matrices, float32
    # norms and biases, two embedding rows) and 40 positions of K/V
    d, L = 3584, 28
    weights = (2 * (L * (d * 128 * 36 + 28 * 128 * d + 3 * d * 18944)
                    + d * 152064 + 2 * d)
               + 4 * (L * (2 * d + 128 * 36) + d))
    kv = 2 * L * 4 * 128 * 2 * 40
    assert counts.weight_bytes(q, 2) == weights
    moved, ops = counts.decode_tick_work(q, [10, 30])
    assert moved == weights + kv
    assert ops == 2 * counts.matmul_params(q) * 2 + 4 * L * 128 * 28 * 40
    # bytes bound it: 2 tokens a weight read is far below the ridge
    assert moved / 3.35e12 > ops / 989e12


def test_experts_hit_is_capped_by_the_tokens():
    m = _cfg("mixtral-8x7b-16l")
    assert counts.experts_hit(m, 1) == 2
    assert counts.experts_hit(m, 32) == 8
    assert counts.experts_hit(_cfg("qwen2-7b"), 32) is None
