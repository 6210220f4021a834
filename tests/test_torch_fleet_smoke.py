"""chip_smoke.py's fleet phases 23-27 rehearsed on the CPU at a tiny size.

The phases (replica failover, disaggregated serving with the migration
A/B, prefix affinity and peer fetch, the autoscaler, rolling deploys)
run here with every gate live on a tiny GPT, the traffic shrunk through
chip_smoke's module constants. K3's wrapper runs its plain version on
the CPU and counts no launch, so every phase reports 0 launches.
"""
import pytest
import torch

import paddle_tpu_torch.inference.serving as serving
from paddle_tpu_torch.models.gpt import GPT, GPTConfig


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_chip_smoke_fleet_phases_run_on_cpu_at_tiny_size(monkeypatch):
    """chip_smoke.py's fleet phases 23-27 (failover, disaggregated
    serving with the migration A/B, prefix affinity and peer fetch, the
    autoscaler, rolling deploys) rehearsed on the CPU at a tiny size with
    every gate live; K3's wrapper runs its plain version there and
    counts no launch."""
    import chip_smoke
    from paddle_tpu_torch.tools.serving_traffic import (drive_arrivals,
                                                        prefix_traffic)
    for name, value in (
            ("PREFIX_TRAFFIC", dict(template_len=16, n_followers=6,
                                    burst=3, s_lo=2, s_hi=6, t_lo=6,
                                    t_hi=12)),
            ("TIERED_TRAFFIC", dict(n_templates=4, template_len=16,
                                    s_lo=2, s_hi=6, t_lo=4, t_hi=8,
                                    r_lo=2, r_hi=4)),
            ("TIERED_ENGINE", dict(num_blocks=20, host_tier_blocks=64,
                                   max_num_seqs=4)),
            ("FLEET_TRAFFIC", dict(n=9, p_lo=4, p_hi=12, t_lo=6, t_hi=12)),
            ("DISAGG_TRAFFIC", dict(n_floor=4, floor_len=6, f_lo=12,
                                    f_hi=20, n_long=2, l_lo=24, l_hi=40,
                                    lt_lo=4, lt_hi=8)),
            ("DIURNAL_TRAFFIC", dict(trickle=2, burst=10, p_lo=4, p_hi=12,
                                     t_lo=4, t_hi=8)),
            ("DEPLOY_TRAFFIC", dict(n=8, p_lo=4, p_hi=10, t_lo=6,
                                    t_hi=10)),
            ("AB", dict(n=4, p_lo=4, p_hi=24, max_tokens=24, warm=3,
                        k=6)),
            ("READINGS", {})):
        monkeypatch.setattr(chip_smoke, name, value)
    model = GPT(GPTConfig(vocab_size=101, hidden_size=32, num_layers=2,
                          num_heads=2, max_seq_len=128), device="cpu")
    model.eval()
    ecfg = serving.EngineConfig(block_size=8, num_blocks=96,
                                max_num_seqs=4, decode_chunk_size=4,
                                prefill_chunk_threshold=12)
    # phase 6a's single-engine hit rate, which phase 25 holds the fleet to
    eng, _ = drive_arrivals(
        model, serving.EngineConfig(block_size=8, num_blocks=96,
                                    max_num_seqs=4, decode_chunk_size=4,
                                    prefill_chunk_threshold=12,
                                    enable_prefix_cache=True),
        prefix_traffic(101, 2, **chip_smoke.PREFIX_TRAFFIC), "cpu")
    ps = eng.cache.prefix_stats()
    chip_smoke.READINGS["prefix_hit_rate"] = \
        ps["hits"] / (ps["hits"] + ps["misses"])
    got = chip_smoke.run_fleet(model, ecfg, torch.device("cpu"), 0)
    assert got == {"failover": 0, "disagg": 0, "prefix_fleet": 0,
                   "autoscale": 0, "deploy": 0}
