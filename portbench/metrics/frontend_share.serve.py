"""Share of request wall outside the span around Synthesizer.decode_tokens
(G2P, BERT, the FACodec encode and decode, host work), over the window."""


def read(run):
    recs = [r for r in run.get("records", []) if r.get("decode_s") is not None]
    if not recs:
        return None
    wall = sum(r["wall_s"] for r in recs)
    return 100.0 * (wall - sum(r["decode_s"] for r in recs)) / wall
