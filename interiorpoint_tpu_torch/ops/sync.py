"""Host reads of device scalars for loop control, counted.

The port's drivers decide loop exits, jitter retries and refinement
rounds on the host.  Each such decision reads one device value, which on
a GPU waits for the stream to drain.  ``read`` is the one place that
happens, so ``count`` is the number of host syncs a solve made.
"""

count = 0


def read(t):
    """Python value of a 0-dim tensor (one counted host sync)."""
    global count
    count += 1
    return t.item()


def read_list(t):
    """Python list of a small 1-d tensor (one counted host sync)."""
    global count
    count += 1
    return t.tolist()
