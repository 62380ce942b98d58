"""Kernels, copies and memsets the card ran per optimizer step (per
sample on the fold route) in the traced device part, from the profiler's device
events."""


def read(obs, ctx):
    td = obs.get("trace")
    if obs.get("kind") != "train" or td is None:
        return None
    return td.device_ops / obs["steps_traced"]
