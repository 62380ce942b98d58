"""The launches the host issued per optimizer step (per sample on the
fold route) in the traced host part: graph launches, kernel launches, copies
and memsets, from the profiler's runtime events."""


def read(obs, ctx):
    td = obs.get("trace")
    if obs.get("kind") != "train" or td is None or td.host_launches is None:
        return None
    return td.host_launches / obs["steps_traced"]
