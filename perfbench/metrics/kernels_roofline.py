"""The traced steps' least time on the card over its busy time, in %:
per step the larger of the configuration's training flops over the
float32 peak and its bytes over the memory's (the work count of the
configuration's reference file), against the union of the device's busy
intervals."""

from perfbench import peaks


def read(obs, ctx):
    td = obs.get("trace")
    if obs.get("kind") != "train" or td is None or td.busy_s <= 0:
        return None
    w = obs["work_step"]
    least = obs["steps_traced"] * peaks.min_time(w["flops"], w["bytes"])
    return 100.0 * least / td.busy_s
