"""The attention forwards' share of their roofline, %: their least time a step, the larger of
their operations at the bf16 peak and their bytes (each input map and weight read once, each
output map written once, never the logits; ``counts/biggan.py``) at the HBM peak, over their
device time a step (stage ``gan_attn``)."""

from perfbench.core.program import stage_ms


def read(r):
    ms = stage_ms(r.profile, "gan_attn")
    if not ms:
        return None
    least = max(r.counts["attn_flop"] / r.peaks["bf16_flop_per_s"], r.counts["attn_bytes"] / r.peaks["hbm_bytes_per_s"])
    return 100.0 * 1e3 * least / ms
