"""Job-level defences of the port: ``speculate``, the decaying unit
latency tracker behind the span window's speculative second copies."""
