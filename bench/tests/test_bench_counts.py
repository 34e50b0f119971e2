"""The yardstick's arithmetic against hand counts, and the prefill's count
against the port's own op-by-op counter on meta tensors."""

import pytest
import torch

from bench.lib import counts
from bench.lib.readers import idle_pct, mfu_pct, roofline_pct


def test_matmul_update_counts_by_hand():
    # 2048 x 16384 x 16384 bf16: 2 M N K operations; A, B and C read, C written
    assert counts.matmul_update_flops(2048, 16384, 16384) == 2 * 2048 * 16384 * 16384
    assert counts.matmul_update_bytes(2048, 16384, 16384) == 2 * (2048 * 16384 + 16384 * 16384 + 2 * 2048 * 16384)
    ops_s = 2 * 2048 * 16384 ** 2 / 989e12
    assert counts.matmul_update_bound_s(2048, 16384, 16384) == pytest.approx(ops_s)
    assert counts.matmul_update_bound_s(2048, 16384, 16384) * 1e3 == pytest.approx(1.11, abs=0.005)
    # a thin panel is bound by its bytes: B alone is 512 MiB
    assert counts.matmul_update_bound_s(32, 16384, 16384) == pytest.approx(
        2 * (32 * 16384 + 16384 ** 2 + 2 * 32 * 16384) / 3.35e12)


def test_causal_attention_counts_by_hand():
    assert counts.causal_pairs(4) == 10
    # B 2, H 32, S 1024, D 160: 4 D a visible pair; q, o of every head, k, v of every KV head
    assert counts.attention_flops(2, 32, 1024, 160) == 4 * 160 * (1024 * 1025 // 2) * 2 * 32
    assert counts.attention_bytes(2, 32, 8, 1024, 160) == 2 * (2 * 2 * 32 * 1024 * 160 + 2 * 2 * 8 * 1024 * 160)
    assert counts.attention_bound_s(2, 32, 8, 1024, 160) * 1e3 == pytest.approx(0.0217, abs=5e-4)


def test_dense_prefill_by_hand():
    f = counts.dense_prefill_flops(1, 512, layers=10, d=5120, heads=32, kv_heads=8, head_dim=160, d_ff=13824,
                                   vocab=100352)
    per_token_linear = 2 * (5120 * 160 * (2 * 32 + 2 * 8) + 3 * 5120 * 13824)
    want = 10 * (512 * per_token_linear + 4 * 160 * (512 * 513 // 2) * 32) + 2 * 5120 * 100352
    assert f == want
    assert f / 1e12 == pytest.approx(2.9, abs=0.1)


def test_dense_prefill_count_matches_the_ports_counter():
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.dryrun import CostCounter
    from repro_torch.models.transformer import LanguageModel, init_cache, prefill

    cfg = get_smoke_config("stablelm-12b")
    B, S = 3, 32
    model = LanguageModel(cfg)
    tokens = torch.zeros((B, S), dtype=torch.int64, device="meta")
    caches = init_cache(cfg, B, S + 1, cfg.dtype, "meta")
    with torch.no_grad(), CostCounter() as counter:
        prefill(model, cfg, tokens, caches)
    want = counts.dense_prefill_flops(B, S, layers=cfg.num_layers, d=cfg.d_model, heads=cfg.num_heads,
                                      kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim, d_ff=cfg.d_ff,
                                      vocab=cfg.vocab_size)
    assert sum(counter.flops.values()) == want


def test_readers_return_nothing_without_their_data():
    assert mfu_pct({}, "matmul") is None
    assert mfu_pct({"work": {"matmul": {"flops": 1.0, "card_s": 0.0}}}, "matmul") is None
    assert roofline_pct({"trace": None}, "matmul_update", "matmul_update") is None
    assert idle_pct({"trace": None}) is None
    trace = {"kernels": {"matmul_update_wgmma": {"count": 2, "seconds": 4e-3}}, "busy_s": 1.0, "window_s": 4.0}
    rec = {"trace": trace, "bounds": {"matmul_update": {"launches": 2, "bound_s": 2e-3}}}
    assert roofline_pct(rec, "matmul_update", "matmul_update") == pytest.approx(50.0)
    assert idle_pct(rec) == pytest.approx(75.0)
    rec["bounds"]["matmul_update"]["launches"] = 3  # the trace lost a launch: no reading
    assert roofline_pct(rec, "matmul_update", "matmul_update") is None
