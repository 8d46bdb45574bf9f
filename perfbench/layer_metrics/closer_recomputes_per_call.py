"""The cloud cache's recomputes a closer call: the converter graphs that
the closer's gets of evicted keyframe clouds replay, over the window's
closer calls that ran at least one batch (`PwnSlam.closer_recomputes` /
`closer_calls`, counted always)."""


def read(r):
    calls = r.counters.get("closer_calls")
    return r.counters["closer_recomputes"] / calls if calls else None
