"""Float64 numpy oracles the port is held against (its own copies)."""
