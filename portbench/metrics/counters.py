"""The program's counters (``utils.timing.counters`` in the port), shared
by the counter readers: ``install`` keeps a copy before the window, and
the reader takes what was counted over the window and the traced slice.
A program without counters reads None."""


def snapshot():
    from erl_gaussian_process_tpu_torch.utils import timing

    read = getattr(timing, "counters", None)
    return None if read is None else read()


def counted(before, name: str):
    """What the counter ``name`` counted since ``before``, a
    :func:`snapshot`; None without counters."""
    after = snapshot()
    if before is None or after is None:
        return None
    return after.get(name, 0) - before.get(name, 0)
