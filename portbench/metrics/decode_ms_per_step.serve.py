"""The decode_tokens span over its steps (quantizers x frames; one step
decodes every row of the batch), over the window."""


def read(run):
    recs = [r for r in run.get("records", []) if r.get("decode_s") is not None]
    if not recs:
        return None
    Q = run["config"]["model"]["decoder"]["num_quantizers"]
    return 1e3 * sum(r["decode_s"] for r in recs) / sum(Q * r["frames"] for r in recs)
