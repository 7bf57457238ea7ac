"""The program's host spans (``egp.*``, ``utils.timing.span`` in the port)
in a traced slice, shared by the span readers. A span counts when it
starts inside the slice, its end clipped to the slice's; its self time is
its length less the part of it that the program's spans inside it cover.
Each function returns None when the slice holds none of the spans it
reads (a program that records none)."""

import bisect

PREFIX = "egp."


def _spans(trace) -> list:
    """(start, end, name) of every program span that starts inside the
    slice, clipped to it, by start (a parent before its children)."""
    return sorted(((a, min(b, trace.end), n) for n, a, b in trace.host
                   if n.startswith(PREFIX) and trace.start <= a < trace.end),
                  key=lambda s: (s[0], -s[1]))


def seconds(trace, names):
    """The summed length of the spans named ``names``."""
    found = [b - a for a, b, n in _spans(trace) if n in names]
    return sum(found) / 1e9 if found else None


def self_seconds(trace, names):
    """The summed self time of the spans named ``names``."""
    spans = _spans(trace)
    starts = [a for a, _, _ in spans]
    total, found = 0, False
    for i, (a, b, n) in enumerate(spans):
        if n not in names:
            continue
        found = True
        covered, reach = 0, a
        for c, d, _ in spans[i + 1:bisect.bisect_right(starts, b)]:
            if d > b or (c < reach and d <= reach):
                continue    # not inside this span, or inside a child
            covered += d - max(c, reach)
            reach = d
        total += b - a - covered
    return total / 1e9 if found else None
