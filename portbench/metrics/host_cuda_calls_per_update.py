"""host_cuda_calls_per_update: CUDA runtime and driver calls the host made
in the traced slice (``torch.profiler``'s host events, the harness's own
synchronisations left out) per update, session starts included."""


def read(ctx):
    if ctx.trace is None or not ctx.traced["updates"]:
        return None
    return ctx.trace.runtime_calls() / ctx.traced["updates"]
