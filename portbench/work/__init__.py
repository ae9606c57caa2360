"""The work of an operation from its shapes: operations and bytes, and the
least time one H100 could take for them (``peaks``).  Each count is the
operation's own work, whatever kernel implements it; the derivations are
in ``PERF.md``."""
