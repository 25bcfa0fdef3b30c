"""Traffic kinds: one driver a kind, found by the kind's name."""
