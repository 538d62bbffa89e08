"""Audio seconds of every completed request over the whole window."""


def read(run):
    if "records" not in run:
        return None
    return sum(r["audio_s"] for r in run["records"]) / run["window_s"]
