"""routed_test_copy_ms: the ms a query the routed test spends in its
copies' spans: ``egp.bank.h2d`` and ``egp.bank.readback``, summed over the
traced slice and divided by its queries. Nothing when the program records
no such span.

It holds more than the copies:

- ``egp.bank.h2d`` also holds the host gather of the bucket's queries
  (``q[slots]`` in the working dtype) and, on a graphed bucket, a capture
  the first time the bucket is seen;
- ``egp.bank.readback``'s ``.cpu()`` waits for the card: the eager
  predict's span closes once its kernels are queued, so the predict's
  device time (~0.6-0.7 ms a query on an H100) lands here.

A faster device predict or a faster gather lowers it as much as a faster
copy does."""

from portbench.metrics.spans import seconds

SPANS = ("egp.bank.h2d", "egp.bank.readback")


def read(ctx):
    if ctx.trace is None or not ctx.traced["queries"]:
        return None
    s = seconds(ctx.trace, SPANS)
    return None if s is None else 1e3 * s / ctx.traced["queries"]
