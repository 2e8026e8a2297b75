"""Host ms per `Trainer.step` in the traced block, less the time the host
waits for the card in synchronising runtime calls: the Python dispatch of
the step, the profiler's own cost per operation in it (moves
train_it_per_s)."""


def read(ctx):
    tr = ctx.get("trace")
    if ctx.get("kind") != "train" or tr is None or not tr.call_host_s:
        return None
    return 1e3 * (sum(tr.call_host_s) - sum(tr.call_wait_s)) \
        / len(tr.call_host_s)
