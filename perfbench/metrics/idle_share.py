"""The share of the traced device part's wall time in which the card ran
nothing, in %: 1 - the union of its busy intervals over the wall."""


def read(obs, ctx):
    td = obs.get("trace")
    if obs.get("kind") != "train" or td is None:
        return None
    return 100.0 * (1.0 - td.busy_s / td.window_s)
