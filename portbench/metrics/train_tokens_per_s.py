"""Target tokens of every completed step (B x frames x quantizers) over the
whole window."""


def read(run):
    if "tokens" not in run:
        return None
    return run["tokens"] / run["window_s"]
