"""Traffic kinds: one general generator a kind, parameterised by the cell's file."""
