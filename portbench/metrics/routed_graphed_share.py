"""routed_graphed_share: the share of the routed test's device halves, in
%, that replayed a CUDA graph: the program's ``bank.routed_graphed`` over
it and ``bank.routed_eager`` (one a ``bank_predict_assigned`` call that
answers a query), counted over the window and the traced slice. A bucket
of more query slots than ``SensorGraphs.max_slots`` runs eagerly. Nothing
when the program does not count them."""

from portbench.metrics.counters import counted, snapshot


def install(ctx):
    ctx.routed_before = snapshot()


def read(ctx):
    graphed = counted(ctx.routed_before, "bank.routed_graphed")
    eager = counted(ctx.routed_before, "bank.routed_eager")
    if graphed is None or not graphed + eager:
        return None
    return 100.0 * graphed / (graphed + eager)
