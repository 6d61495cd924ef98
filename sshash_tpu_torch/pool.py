"""An ordered map over a bounded thread pool, shared by the host builders
(the partitioned MPHF, the ranged assembly, the table build) and the
capacity run's passes over its strings."""

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from itertools import islice


def ordered_map(fn, items, threads):
    """fn over items, results yielded in item order: on a pool of `threads`
    threads (NumPy's sorts and gathers and the native pilot search release
    the GIL) with at most 2 * threads calls in flight, items drawn from
    their iterator in this thread as calls finish, so that a result is
    freed as soon as the caller consumes it; in this thread when threads
    is 1 or less."""
    if threads <= 1:
        yield from map(fn, items)
        return
    it = iter(items)
    with ThreadPoolExecutor(max_workers=threads) as ex:
        futs = deque(ex.submit(fn, x) for x in islice(it, 2 * threads))
        while futs:
            res = futs.popleft().result()
            futs.extend(ex.submit(fn, x) for x in islice(it, 1))
            yield res
