"""The timed call's first step, counted from the call's start: the
loader's build, the step's capture and the first window's table upload
are inside it (the history's ``t`` stamp of the first step, host clock
after a synchronise)."""


def read(obs, ctx):
    t = obs.get("first_step_s")
    return None if t is None else t * 1e3
