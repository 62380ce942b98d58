"""The whole step's share of the card's float32 peak, in %: the
configuration's training flops per sample times the samples of the
traced device part, over its wall time, over 67 TFLOP/s."""

from perfbench import peaks


def read(obs, ctx):
    td = obs.get("trace")
    if obs.get("kind") != "train" or td is None:
        return None
    flops = obs["flops_per_sample"] * obs["samples_traced"]
    return 100.0 * flops / td.window_s / peaks.FLOPS_F32
