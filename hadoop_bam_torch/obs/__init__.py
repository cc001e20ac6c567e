"""Observability helpers of the port: ``hist``, the log-bucketed
histogram the straggler defence reads its soft deadline from."""
