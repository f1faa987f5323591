"""One reader per metric: read(record) returns the metric's number, or
None where the run has nothing for it to read (the harness then leaves the
metric out of the result).  The record holds setup_s, window_s, requests
(ms, its, ok, spans), setup_spans, profile (busy_s, window_s,
launches, its, device_ops, idle_gaps), probes ({probe: {kernel name:
[device seconds, launches]}}), sizes and traffic."""
