"""Weight FLOPs of the transcriptions returned in the window over its seconds at bf16 peak, %.

Per transcription: its true mel frames through the encoder and adapter, its
prompt (prefix, audio tokens, suffix) through prefill, and one decode step
per served token (roofline.py); attention's length terms are left out.
"""

from gpubench import roofline
from gpubench.reference.check import prompt_ids


def read(r):
    if not r.work:
        return None
    m = r.config["model"]
    prefix, suffix = prompt_ids(r.config)
    hop = r.config["frontend"]["hop_length"]
    flops = 0.0
    for w in r.work:
        frames = w["samples"] // hop
        audio_tokens = max(1, frames // (2 * m["adapter_stack"]))
        flops += roofline.encoder_flops(m, frames)
        flops += roofline.decoder_flops(m, len(prefix) + audio_tokens + len(suffix), w["tokens"])
    return 100.0 * flops / (r.window_s * roofline.PEAK_BF16_FLOPS)
