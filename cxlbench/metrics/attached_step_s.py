"""Window seconds over the attached steps completed in it, the last
step's asynchronous analysis flushed inside the window."""


def read(ctx):
    if ctx["traffic"]["kind"] != "attached_prefill" or not ctx["counters"]["units"]:
        return None
    return ctx["window_s"] / ctx["counters"]["units"]
