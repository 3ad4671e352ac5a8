"""Traffic drivers: the loop a traffic mix runs in the timed window, one
module a ``driver`` name.  Each gives ``setup(run)``, ``window(run,
state, seconds)``, ``span(run, state, n)`` (the traced span) and
``check(run, state)`` (the comparison with the reference)."""
