"""The port's tools: the run tool (``run``), the evaluate CLI
(``evaluate``), the GPU bench (``bench``), the verification and
measurement tools (``parity_oracle``, ``soak``, ``microbench``,
``profile_trace``, ``profile_stages``, ``certify_tf``,
``reconcile_timing``) and measurement scripts run on the card."""
