"""prepare_fallback_share: the share of queries, in %, whose prepare left
its first tier (the Cholesky of Q_M on the card): counted by a handler on
the program's logger, from the record each later tier writes (the float64
host refactorization's INFO, the jitter ladder's WARNING)."""

import logging

LOGGER = "erl_gaussian_process_tpu_torch"
MARKS = ("host refactorization from the compensated", "fit required jitter")


class _Count(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.n = 0

    def emit(self, record):
        if any(m in str(record.msg) for m in MARKS):
            self.n += 1


def install(ctx):
    log = logging.getLogger(LOGGER)
    ctx.fallbacks = _Count()
    ctx.fallback_level = log.level
    log.addHandler(ctx.fallbacks)
    log.setLevel(logging.INFO)


def uninstall(ctx):
    log = logging.getLogger(LOGGER)
    log.removeHandler(ctx.fallbacks)
    log.setLevel(ctx.fallback_level)


def read(ctx):
    queries = len(ctx.window["latencies"]) + (
        ctx.traced["queries"] if ctx.traced else 0)
    if not queries:
        return None
    return 100.0 * ctx.fallbacks.n / queries
