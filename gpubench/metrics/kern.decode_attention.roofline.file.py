"""Decode attention timed alone at the cell's rows and lengths, bytes bound over time, %."""

from gpubench import probes


def read(r):
    spec = r.probe_spec("decode_attention")
    if r.device is None or spec is None:
        return None
    return probes.decode_attention(r.config, spec, r.seed, r.device)["roofline_pct"]
